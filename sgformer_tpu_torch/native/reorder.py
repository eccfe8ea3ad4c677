"""The clustering reorder: node ids relabelled so that clusters of the graph
are contiguous, the port of the JAX package's ``kernels/slabs.py::
reorder_for_slabs`` as ``preprocess_graph(reorder=True)`` calls it there,
with ``slab_rows = num_nodes`` and without the TPU slab layout.

Node-sharded training splits the nodes into contiguous blocks
(:mod:`sgformer_tpu_torch.parallel.partition`), so after the reorder a
shard holds whole communities and the halo exchange carries fewer rows.
"""

from __future__ import annotations

import numpy as np

from sgformer_tpu_torch.native.api import cluster_pack_native, lpa_cluster_native


def reorder_for_clusters(edge_index, num_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """``(perm, inv)`` with ``perm[new] = old`` and ``inv[old] = new``:
    relabel edges as ``inv[src], inv[dst]`` and node-indexed arrays as
    ``arr[perm]``.

    Label propagation on the loop-free edges (C++, :func:`lpa_cluster_native`,
    seed 0, at most 40 sweeps up to 300,000 nodes and 96 above), its
    clusters packed into one block of ``num_nodes`` ids. The JAX function
    scores four seeds by the share of edges inside one block; with a single
    block every seed scores 1 and the first wins, so only seed 0 is run. The
    C++ library is built on first use; a failed build raises (the JAX
    function falls back to numpy)."""
    src, dst = np.asarray(edge_index)
    n = int(num_nodes)
    # self-loops bias every node toward keeping its own label
    m = src != dst
    clusters = lpa_cluster_native(src[m], dst[m], n, 40 if n <= 300_000 else 96, n + 1, 0)
    perm = cluster_pack_native(clusters, n)
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    return perm, inv
