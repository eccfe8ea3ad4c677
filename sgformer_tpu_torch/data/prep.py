"""Chunked, bounded-memory preparation of 100M-scale graphs on the host: the
port of ``sgformer_tpu/data/prep.py``, a numpy copy whose outputs are bitwise
the JAX package's (``tests/test_torch_sampled.py``).

The reference's papers100M tier symmetrises its 1.6B edges in host RAM
(``100M/nb-sample.py:79-80``: ``to_undirected`` + ``add_self_loops`` on the
whole edge list), several [2, 3.2B] int64 arrays at once. This module builds
the same graph (symmetrised, deduplicated, self-looped, in-neighbour CSR)
with peak RAM bounded by ``O(chunk_edges + E_sym / num_buckets)``:

1. **Scatter pass**: stream the directed edge list in chunks; emit both
   directions, drop existing self-loops, and append each (dst, src) pair
   to one of ``num_buckets`` on-disk bucket files keyed by dst range.
2. **Bucket pass**: per bucket (ascending dst range) load its pairs,
   lexsort by (dst, src), deduplicate, splice in one self-loop per node
   of the range, and append the result to the output CSR's indices
   array. Buckets are dst-ordered, so the concatenation is the CSR: no
   global sort happens.

The output is ``to_undirected`` -> ``remove_self_loops`` ->
``add_self_loops`` -> ``CSRGraph.from_edge_index`` bit for bit.
"""

from __future__ import annotations

import json
import os
from typing import Union

import numpy as np

from sgformer_tpu_torch.sample.neighbor import CSRGraph

_META = "csr_meta.json"
_INDPTR = "csr_indptr.npy"
_INDICES = "csr_indices.bin"


def build_undirected_csr(
    edge_index: Union[np.ndarray, str],
    num_nodes: int,
    out_dir: str,
    *,
    chunk_edges: int = 20_000_000,
    num_buckets: int = 16,
    add_loops: bool = True,
    progress: bool = False,
) -> str:
    """Symmetrize + dedup (+ self-loops) + CSR, out of core.

    Args:
      edge_index: [2, E] directed edges — an in-RAM array, or the path of
        a ``.npy`` file (opened with ``mmap_mode='r'`` so the input never
        fully loads).
      num_nodes: node count (dst/src must be < num_nodes).
      out_dir: output directory; receives ``csr_indptr.npy`` (int64
        [N+1]), ``csr_indices.bin`` (raw int64 [E_sym]), and
        ``csr_meta.json``.  Load with :func:`load_csr`.
      chunk_edges: edges streamed per scatter-pass chunk.
      num_buckets: dst-range buckets; peak RAM of the bucket pass is
        ``~E_sym/num_buckets * 24 bytes`` (pair + lexsort temp).
      add_loops: replace self-loops with exactly one per node (the
        reference's remove+add semantics, ``large/main.py:77-79``; the
        100M tier's ``add_self_loops`` on a loop-free OGB graph is the
        same result, ``nb-sample.py:80``).

    Returns ``out_dir``.
    """
    os.makedirs(out_dir, exist_ok=True)
    if isinstance(edge_index, str):
        edges = np.load(edge_index, mmap_mode="r")
    else:
        edges = np.asarray(edge_index)
    if edges.ndim != 2 or edges.shape[0] != 2:
        raise ValueError(f"edge_index must be [2, E], got {edges.shape}")
    e_dir = edges.shape[1]
    bucket_size = -(-num_nodes // num_buckets)

    # -- scatter pass --------------------------------------------------------
    bucket_paths = [
        os.path.join(out_dir, f"bucket_{b:04d}.tmp") for b in range(num_buckets)
    ]
    files = [open(p, "wb") for p in bucket_paths]
    try:
        for lo in range(0, e_dir, chunk_edges):
            hi = min(lo + chunk_edges, e_dir)
            s = np.asarray(edges[0, lo:hi], dtype=np.int64)
            d = np.asarray(edges[1, lo:hi], dtype=np.int64)
            keep = s != d  # drop existing self-loops (re-added per node)
            if not add_loops:
                keep = np.ones(len(s), dtype=bool)
            s, d = s[keep], d[keep]
            # both directions: (dst, src) pairs keyed by dst
            pd = np.concatenate([d, s])
            ps = np.concatenate([s, d])
            b_of = pd // bucket_size
            order = np.argsort(b_of, kind="stable")
            pd, ps, b_of = pd[order], ps[order], b_of[order]
            bounds = np.searchsorted(b_of, np.arange(num_buckets + 1))
            for b in range(num_buckets):
                n0, n1 = bounds[b], bounds[b + 1]
                if n1 > n0:
                    pair = np.empty((n1 - n0, 2), dtype=np.int64)
                    pair[:, 0] = pd[n0:n1]
                    pair[:, 1] = ps[n0:n1]
                    files[b].write(pair.tobytes())
            if progress:
                print(f"[prep] scatter {hi}/{e_dir}", flush=True)
    finally:
        for f in files:
            f.close()

    # -- bucket pass ---------------------------------------------------------
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    idx_path = os.path.join(out_dir, _INDICES)
    e_out = 0
    with open(idx_path, "wb") as out:
        for b in range(num_buckets):
            raw = np.fromfile(bucket_paths[b], dtype=np.int64)
            pair = raw.reshape(-1, 2)
            d, s = pair[:, 0], pair[:, 1]
            lo_node = b * bucket_size
            hi_node = min(lo_node + bucket_size, num_nodes)
            if hi_node <= lo_node:
                # bucket range entirely beyond num_nodes (small n with
                # many buckets): nothing to emit
                os.unlink(bucket_paths[b])
                continue
            if len(d):
                order = np.lexsort((s, d))
                d, s = d[order], s[order]
                keep = np.ones(len(d), dtype=bool)
                keep[1:] = (d[1:] != d[:-1]) | (s[1:] != s[:-1])
                d, s = d[keep], s[keep]
            if add_loops and hi_node > lo_node:
                # splice one self-loop per node at the END of its dst run:
                # the oracle pipeline appends loops after coalesce and the
                # stable dst sort keeps them last within each run
                # (graph.add_self_loops + CSRGraph.from_edge_index)
                loops = np.arange(lo_node, hi_node, dtype=np.int64)
                pos = np.searchsorted(d, loops, side="right")
                s = np.insert(s, pos, loops)
                d = np.insert(d, pos, loops)
            counts = np.bincount(d - lo_node, minlength=hi_node - lo_node)
            indptr[lo_node + 1 : hi_node + 1] = counts
            out.write(np.ascontiguousarray(s).tobytes())
            e_out += len(s)
            os.unlink(bucket_paths[b])
            if progress:
                print(f"[prep] bucket {b + 1}/{num_buckets}: "
                      f"{len(s)} edges", flush=True)
    np.cumsum(indptr, out=indptr)
    np.save(os.path.join(out_dir, _INDPTR), indptr)
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(
            {"num_nodes": int(num_nodes), "num_edges": int(e_out),
             "dtype": "int64", "directed_input_edges": int(e_dir),
             "self_loops": bool(add_loops)},
            f,
        )
    return out_dir


def load_csr(out_dir: str, in_ram: bool = True) -> CSRGraph:
    """Open a :func:`build_undirected_csr` output.

    ``in_ram=True`` (default) loads the indices array into memory: the
    sampler reads it at random every batch. At papers100M scale that is
    ~26 GB of int64 indices, the residency split of the sampled tier: the
    CSR in RAM, the features on disk (``FeatureStore``)."""
    with open(os.path.join(out_dir, _META)) as f:
        meta = json.load(f)
    indptr = np.load(os.path.join(out_dir, _INDPTR))
    idx_path = os.path.join(out_dir, _INDICES)
    if in_ram:
        indices = np.fromfile(idx_path, dtype=np.int64)
    else:
        indices = np.memmap(idx_path, dtype=np.int64, mode="r",
                            shape=(meta["num_edges"],))
    if len(indices) != meta["num_edges"]:
        raise ValueError(f"{idx_path} holds {len(indices)} edges, its meta "
                         f"{meta['num_edges']}")
    return CSRGraph(indptr=indptr, indices=indices)


def csr_to_edge_index(csr: CSRGraph) -> np.ndarray:
    """[2, E] (src, dst) edge list of an in-neighbor CSR (dst-sorted)."""
    n = csr.num_nodes
    dst = np.repeat(
        np.arange(n, dtype=np.int64), np.diff(csr.indptr)
    )
    return np.stack([np.asarray(csr.indices, dtype=np.int64), dst])
