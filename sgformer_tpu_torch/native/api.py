"""numpy-facing wrappers of the host graph kernels: the counterparts of the
JAX package's ``native/api.py::sample_batch_native``,
``sample_neighbors_native``, ``lpa_cluster_native`` and
``cluster_pack_native``. They raise where the library cannot be built;
none returns None."""

from __future__ import annotations

import numpy as np

from sgformer_tpu_torch.native.build import library


def sample_batch_native(indptr: np.ndarray, indices: np.ndarray, seeds: np.ndarray, fanouts,
                        node_cap: int, edge_cap: int, seed: int):
    """One batch of the C++ full-batch sampler (``csrc/graph_kernels.cpp``):
    the fanout draws from ``seed``, the relabel (seeds first), a self-loop on
    every node, the stable sort by destination and the f32 GCN weights.

    ``indptr``/``indices`` are the in-neighbour CSR (int64); ``node_cap`` and
    ``edge_cap`` size the output buffers. Returns ``(node_ids, src, dst,
    weight, truncated)``: the arrays at the batch's real size (int64 global
    ids, int32 local ends, f32 weights) and whether a sampled node (``[0]``)
    or an edge (``[1]``) did not fit. The call releases the GIL, so batches
    sample in parallel in Python threads."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    seeds = np.ascontiguousarray(seeds, dtype=np.int64)
    fan = np.ascontiguousarray(fanouts, dtype=np.int64).reshape(-1)
    num_nodes = len(indptr) - 1
    if num_nodes < 0 or indptr[-1] != len(indices):
        raise ValueError(f"indptr ends at {indptr[-1] if len(indptr) else None}, "
                         f"indices holds {len(indices)}")
    if len(seeds) and (seeds.min() < 0 or seeds.max() >= num_nodes):
        raise ValueError(f"seeds must lie in [0, {num_nodes})")
    if not 0 <= node_cap < 2 ** 31 or edge_cap < 0:
        raise ValueError(f"node_cap {node_cap} must lie in [0, 2^31) (int32 local ids), "
                         f"edge_cap {edge_cap} must not be negative")
    node_ids = np.empty(node_cap, dtype=np.int64)
    src = np.empty(edge_cap, dtype=np.int32)
    dst = np.empty(edge_cap, dtype=np.int32)
    weight = np.empty(edge_cap, dtype=np.float32)
    n_edges = np.zeros(1, dtype=np.int64)
    truncated = np.zeros(2, dtype=np.int64)
    n = library().sample_batch(
        indptr.ctypes.data, indices.ctypes.data, seeds.ctypes.data, len(seeds),
        fan.ctypes.data, len(fan), node_cap, edge_cap, seed & (2 ** 64 - 1),
        node_ids.ctypes.data, src.ctypes.data, dst.ctypes.data, weight.ctypes.data,
        n_edges.ctypes.data, truncated.ctypes.data)
    e = int(n_edges[0])
    return node_ids[:n], src[:e], dst[:e], weight[:e], tuple(bool(t) for t in truncated)


def sample_neighbors_native(indptr: np.ndarray, indices: np.ndarray, frontier: np.ndarray,
                            fanout: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """One hop of the C++ hop sampler (``csrc/graph_kernels.cpp``), the JAX
    package's ``sample_neighbors_native`` bit for bit: for each frontier
    node, all its in-neighbours where its degree is at most ``fanout``, else
    ``fanout`` offsets drawn with replacement from ``seed``'s xorshift
    stream. ``indptr``/``indices`` are the in-neighbour CSR (int64).
    Returns (src, dst) int64 global ids of the sampled edges, in frontier
    order."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    frontier = np.ascontiguousarray(frontier, dtype=np.int64)
    num_nodes = len(indptr) - 1
    if num_nodes < 0 or indptr[-1] != len(indices):
        raise ValueError(f"indptr ends at {indptr[-1] if len(indptr) else None}, "
                         f"indices holds {len(indices)}")
    if len(frontier) and (frontier.min() < 0 or frontier.max() >= num_nodes):
        raise ValueError(f"the frontier must lie in [0, {num_nodes})")
    if fanout < 0:
        raise ValueError(f"fanout must not be negative, got {fanout}")
    cap = len(frontier) * fanout
    src = np.empty(cap, dtype=np.int64)
    dst = np.empty(cap, dtype=np.int64)
    n = library().sample_neighbors(indptr.ctypes.data, indices.ctypes.data,
                                   frontier.ctypes.data, len(frontier), fanout,
                                   seed & (2 ** 64 - 1), src.ctypes.data, dst.ctypes.data)
    return src[:n], dst[:n]


def lpa_cluster_native(src: np.ndarray, dst: np.ndarray, num_nodes: int, iters: int,
                       max_size: int, seed: int) -> np.ndarray:
    """Label-propagation clustering of the edges (src, dst) by the C++ sweep
    (``csrc/graph_kernels.cpp``), the JAX package's ``lpa_cluster_native``
    label for label: ``iters`` sweeps at most, labels of ``max_size`` nodes
    or more closed to new members, draws from ``seed``. Returns the labels
    compacted to 0..C-1 in order of their first label value ([N] int64)."""
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    if src.shape != dst.shape:
        raise ValueError("src and dst must have one entry per edge")
    if len(src) and (min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) >= num_nodes):
        raise ValueError(f"edge ends must lie in [0, {num_nodes})")
    labels = np.empty(num_nodes, dtype=np.int64)
    library().lpa_cluster(src.ctypes.data, dst.ctypes.data, len(src), num_nodes, iters,
                          max_size, seed & (2 ** 64 - 1), labels.ctypes.data)
    _, labels = np.unique(labels, return_inverse=True)
    return labels.astype(np.int64)


def cluster_pack_native(clusters: np.ndarray, slab_rows: int) -> np.ndarray:
    """``perm`` (``perm[new] = old``) that packs the clusters (labels
    0..C-1) into consecutive blocks of ``slab_rows`` new ids, by the C++
    best-fit-decreasing packing: the JAX package's ``cluster_pack_native``
    bit for bit."""
    clusters = np.ascontiguousarray(clusters, dtype=np.int64)
    if slab_rows < 1:
        raise ValueError(f"slab_rows must be positive, got {slab_rows}")
    perm = np.empty(len(clusters), dtype=np.int64)
    library().cluster_pack(clusters.ctypes.data, len(clusters), slab_rows, perm.ctypes.data)
    return perm
