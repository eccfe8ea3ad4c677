"""Graph container and the one-time host-side preprocessing.

The port of ``sgformer_tpu/graph.py``, CSR path only. All structure work
(symmetrising, self-loops, sorting edges by destination, the GCN degree
normalisation) runs once on the host in numpy and gives a :class:`Graph` of
tensors that stays on the device. Its dst-sorted ``indptr``, ``edge_src`` and
``gcn_weight`` are exactly what the CSR SpMM kernel reads, so the TPU's
slab, chunk and clustering-reorder plans have no counterpart here:
``node_perm`` is always None.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sgformer_tpu_torch.device import resolve_device
from sgformer_tpu_torch.kernels import spmm as _spmm_kernel


@dataclasses.dataclass(frozen=True)
class Graph:
    """Dst-sorted COO/CSR graph on one device.

    Attributes:
      edge_src: [E] int32 source of each edge, sorted by ``edge_dst``.
      edge_dst: [E] int32 destination of each edge (non-decreasing).
      gcn_weight: [E] symmetric-normalised weight ``1/sqrt(d[dst]*d[src])``
        with ``d`` the in-degree.
      indptr: [N+1] int32 CSR row pointers over the dst-sorted edges.
      num_nodes / num_edges: Python ints.
      pyg_*: PyG ``gcn_norm`` edges (sorted by dst) and their row pointers,
        present only with ``with_pyg_norm=True``.
      node_perm: always None (the port does not reorder nodes).
    """

    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    gcn_weight: torch.Tensor
    indptr: torch.Tensor
    num_nodes: int
    num_edges: int
    pyg_src: Optional[torch.Tensor] = None
    pyg_dst: Optional[torch.Tensor] = None
    pyg_weight: Optional[torch.Tensor] = None
    pyg_indptr: Optional[torch.Tensor] = None
    node_perm: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.edge_src.device

    def to(self, device) -> "Graph":
        dev = resolve_device(device)
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            moved[f.name] = v.to(dev) if isinstance(v, torch.Tensor) else v
        return Graph(**moved)

    def propagate(self, x: torch.Tensor, kind: str = "gcn") -> torch.Tensor:
        """A_norm @ x, the GCN aggregation, through the CSR SpMM kernel
        (its plain version on the CPU). ``kind='gcn'`` uses the GraphConv
        normalisation; ``'pyg'`` the PyG ``gcn_norm`` edges."""
        if kind == "gcn":
            return _spmm_kernel.csr_spmm(
                x, self.indptr, self.edge_src, self.edge_dst, self.gcn_weight
            )
        if kind != "pyg":
            raise ValueError(f"unknown propagate kind {kind!r}")
        if self.pyg_src is None:
            raise ValueError(
                "pyg edges missing: preprocess_graph(..., with_pyg_norm=True)"
            )
        return _spmm_kernel.csr_spmm(
            x, self.pyg_indptr, self.pyg_src, self.pyg_dst, self.pyg_weight
        )


# ---------------------------------------------------------------------------
# Host-side (numpy) edge-list transforms, run once before the graph moves to
# the device. Copies of the JAX package's, which the port may not import.
# ---------------------------------------------------------------------------


def to_undirected(edge_index: np.ndarray) -> np.ndarray:
    """Symmetrise and deduplicate an edge list [2, E]."""
    src, dst = edge_index
    both = np.concatenate([np.stack([src, dst]), np.stack([dst, src])], axis=1)
    return coalesce(both)


def coalesce(edge_index: np.ndarray) -> np.ndarray:
    """Sort by (dst, src) and remove duplicate edges."""
    src, dst = edge_index
    key = dst.astype(np.int64) * (max(int(src.max(initial=0)), int(dst.max(initial=0))) + 1) + src
    order = np.argsort(key, kind="stable")
    key = key[order]
    keep = np.ones(len(key), dtype=bool)
    keep[1:] = key[1:] != key[:-1]
    return np.stack([src[order][keep], dst[order][keep]])


def remove_self_loops(edge_index: np.ndarray) -> np.ndarray:
    src, dst = edge_index
    mask = src != dst
    return np.stack([src[mask], dst[mask]])


def add_self_loops(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    loop = np.arange(num_nodes, dtype=edge_index.dtype)
    return np.concatenate([edge_index, np.stack([loop, loop])], axis=1)


def in_degree(dst: np.ndarray, num_nodes: int) -> np.ndarray:
    return np.bincount(dst, minlength=num_nodes).astype(np.float64)


def gcn_norm_weights(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> np.ndarray:
    """Per-edge ``1/sqrt(d_in[dst] * d_in[src])``, with inf/nan (isolated
    nodes) set to 0."""
    d = in_degree(dst, num_nodes)
    with np.errstate(divide="ignore"):
        dinv = 1.0 / np.sqrt(d)
    dinv[~np.isfinite(dinv)] = 0.0
    return (dinv[dst] * dinv[src]).astype(np.float32)


def sort_by_dst(edge_index: np.ndarray):
    src, dst = edge_index
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order]


def build_indptr(dst_sorted: np.ndarray, num_nodes: int) -> np.ndarray:
    counts = np.bincount(dst_sorted, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr


def pyg_gcn_norm(
    edge_index: np.ndarray,
    num_nodes: int,
    *,
    add_self_loops_: bool = True,
    improved: bool = False,
):
    """PyG-style ``gcn_norm``: add the remaining self-loops (existing loops
    keep their weight; loop-less nodes get 1, or 2 if ``improved``), degree
    from edge weights over dst, weight ``dinv[src]*dinv[dst]``. Returns
    (src, dst, weight) sorted by dst."""
    edge_index = np.asarray(edge_index)
    src, dst = edge_index
    weight = np.ones(src.shape[0], dtype=np.float64)
    if add_self_loops_:
        fill = 2.0 if improved else 1.0
        mask = src != dst
        loop_weight = np.full(num_nodes, fill)
        loop_weight[src[~mask]] = weight[~mask]
        loop = np.arange(num_nodes, dtype=src.dtype)
        src = np.concatenate([src[mask], loop])
        dst = np.concatenate([dst[mask], loop])
        weight = np.concatenate([weight[mask], loop_weight])
    deg = np.zeros(num_nodes, dtype=np.float64)
    np.add.at(deg, dst, weight)
    with np.errstate(divide="ignore"):
        dinv = deg**-0.5
    dinv[~np.isfinite(dinv)] = 0.0
    weight = dinv[src] * weight * dinv[dst]
    order = np.argsort(dst, kind="stable")
    return (
        src[order].astype(np.int32),
        dst[order].astype(np.int32),
        weight[order].astype(np.float32),
    )


def _int32(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)


def preprocess_graph(
    edge_index,
    num_nodes: int,
    *,
    undirected: bool = True,
    self_loops: bool = True,
    with_pyg_norm: bool = False,
    dtype=np.float32,
    device="cuda",
) -> Graph:
    """Symmetrise (optionally), replace self-loops, sort by destination and
    normalise, then place the graph on ``device``.

    ``edge_index`` is a [2, E] integer array (numpy, or a tensor on any
    device). ``with_pyg_norm`` also builds the PyG ``gcn_norm`` edges of the
    medium-tier GCN backbone. ``dtype`` is the type of the edge weights.
    """
    dev = resolve_device(device)
    if isinstance(edge_index, torch.Tensor):
        edge_index = edge_index.cpu().numpy()
    edge_index = np.asarray(edge_index)
    if undirected:
        edge_index = to_undirected(edge_index)
    if self_loops:
        edge_index = remove_self_loops(edge_index)
        edge_index = add_self_loops(edge_index, num_nodes)
    src, dst = sort_by_dst(edge_index)
    weight = gcn_norm_weights(src, dst, num_nodes).astype(dtype)
    indptr = build_indptr(dst, num_nodes)
    pyg = {}
    if with_pyg_norm:
        psrc, pdst, pw = pyg_gcn_norm(np.stack([src, dst]), num_nodes)
        pyg = dict(
            pyg_src=_int32(psrc, dev),
            pyg_dst=_int32(pdst, dev),
            pyg_weight=torch.from_numpy(pw.astype(dtype)).to(dev),
            pyg_indptr=_int32(build_indptr(pdst, num_nodes), dev),
        )
    return Graph(
        edge_src=_int32(src, dev),
        edge_dst=_int32(dst, dev),
        gcn_weight=torch.from_numpy(np.ascontiguousarray(weight)).to(dev),
        indptr=_int32(indptr, dev),
        num_nodes=int(num_nodes),
        num_edges=int(len(src)),
        **pyg,
    )
