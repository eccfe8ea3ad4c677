"""Graph container and the one-time host-side preprocessing.

The port of ``sgformer_tpu/graph.py``, CSR path only. All structure work
(symmetrising, self-loops, sorting edges by destination, the GCN degree
normalisation) runs once on the host in numpy and gives a :class:`Graph` of
tensors that stays on the device. Its dst-sorted ``indptr``, ``edge_src`` and
``gcn_weight`` are exactly what the CSR SpMM kernel reads, so the TPU's
slab, chunk and clustering-reorder plans have no counterpart here:
``node_perm`` is always None.

The gradient of the aggregation is ``A^T @ g`` through the same kernel. A
graph built with ``undirected=True`` is symmetric by construction (the edge
set is closed under transpose and both normalisations are symmetric in src
and dst, as the JAX package reasons in its ``preprocess_graph``), so for the
fixed weights A's own CSR serves; otherwise ``preprocess_graph`` also builds
the CSR of the PyG edges' transpose.

Runtime per-edge values (GAT's attention weights, :meth:`Graph.
propagate_edge_values`) belong to directed edges: even on a symmetric edge
set the value of (j -> i) is not that of (i -> j). Their gradient therefore
always runs on the transposed edge order, which every graph carries:
``t_perm`` is the stable ``argsort`` of the dst-sorted edges by source, so
``v[t_perm]`` lists the values in the order of ``t_indptr``/``t_edge_src``.
The JAX package builds its transpose plan the same way on every graph
(``kernels/chunks.py::build_chunks``, ``input_ids=order``).

A graph built with ``slab_dtype="int8"`` aggregates through the int8 kernel
(:func:`sgformer_tpu_torch.kernels.spmm.csr_spmm_q8`): x is pre-scaled by
``rs = 1/sqrt(d_in)`` (the GCN weights factor as ``rs[src] * rs[dst]``),
quantised to int8 with one absmax per call (the quantiser kernel), summed
exactly in int32 through the same hub plans as the bf16 aggregation and
scaled back, the self-loop term unquantised; the gradient quantises the
cotangent the same way. This is the JAX package's ``SlabSpMM.slab_dtype ==
'int8'``, with two differences that ``ROADMAP.md`` §3 lists: the port
quantises every non-self edge (the JAX plan sums its cross-slab edges
unquantised in bf16) and keeps the exact integer sum (the JAX kernel rounds
it to bf16 before the dequantisation).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sgformer_tpu_torch.device import resolve_device
from sgformer_tpu_torch.kernels import spmm as _spmm_kernel
from sgformer_tpu_torch.kernels.spmm import HUB_EDGES, hub_segments

_CHUNK_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


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
      symmetric: True when A == A^T by construction (``undirected=True``);
        the fixed-weight gradient then runs on A's own CSR.
      t_*: CSR of A^T (edges sorted by source: ``t_edge_src`` holds the
        original destinations, ``t_edge_dst`` the sources, ``t_perm`` the
        dst-sorted id of each, ``t_weight`` = ``gcn_weight[t_perm]``),
        built on every graph.
      pyg_t_*: the same for the PyG edges, present only when ``symmetric``
        is False.
      chunk_dtype: 'f32' or 'bf16', the type of the messages of the
        per-edge-value aggregation (the JAX ``Graph.chunk_dtype`` that
        ``GATConv`` reads); the fixed-weight aggregation keeps x's type.
      slab_dtype: 'compute' (the GCN aggregation in x's type) or 'int8'
        (the int8 aggregation, the JAX ``SlabSpMM.slab_dtype``).
      rs: [N] f32 ``1/sqrt(d_in)``, the separable factor of ``gcn_weight``
        that the int8 aggregation reads; present only with 'int8'.
      hub_segments, t_hub_segments, pyg_hub_segments, pyg_t_hub_segments:
        the hub plan of ``indptr``, ``t_indptr``, ``pyg_indptr`` and
        ``pyg_t_indptr`` (:func:`sgformer_tpu_torch.kernels.spmm.
        hub_segments`, [S, 3] int32), present where their CSR is: the
        segments that the CSR kernels split rows of more than
        ``hub_edges`` in-edges into, built here once so that no call reads
        ``indptr`` back to the host.
      hub_edges: the segment length of those four plans
        (``kernels.spmm.HUB_EDGES``); the CSR kernels take it with each plan
        and refuse a plan without it.
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
    symmetric: bool = False
    t_indptr: Optional[torch.Tensor] = None
    t_edge_src: Optional[torch.Tensor] = None
    t_edge_dst: Optional[torch.Tensor] = None
    t_weight: Optional[torch.Tensor] = None
    t_perm: Optional[torch.Tensor] = None
    pyg_t_indptr: Optional[torch.Tensor] = None
    pyg_t_src: Optional[torch.Tensor] = None
    pyg_t_dst: Optional[torch.Tensor] = None
    pyg_t_weight: Optional[torch.Tensor] = None
    chunk_dtype: str = "f32"
    slab_dtype: str = "compute"
    rs: Optional[torch.Tensor] = None
    hub_segments: Optional[torch.Tensor] = None
    t_hub_segments: Optional[torch.Tensor] = None
    pyg_hub_segments: Optional[torch.Tensor] = None
    pyg_t_hub_segments: Optional[torch.Tensor] = None
    hub_edges: int = HUB_EDGES

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
        (its plain version on the CPU), differentiable in x: the gradient is
        A^T @ g through the same kernel. ``kind='gcn'`` uses the GraphConv
        normalisation, through the int8 kernel on a ``slab_dtype='int8'``
        graph; ``'pyg'`` the PyG ``gcn_norm`` edges (through the int8 kernel
        too on an int8 graph, whose PyG weights factor by the same ``rs``)."""
        if kind == "gcn":
            csr = (self.indptr, self.edge_src, self.edge_dst, self.gcn_weight)
            csr_t = (self.t_indptr, self.t_edge_src, self.t_edge_dst, self.t_weight)
            plans = (self.hub_segments, self.t_hub_segments)
        elif kind == "pyg":
            if self.pyg_src is None:
                raise ValueError(
                    "pyg edges missing: preprocess_graph(..., with_pyg_norm=True)"
                )
            csr = (self.pyg_indptr, self.pyg_src, self.pyg_dst, self.pyg_weight)
            csr_t = (self.pyg_t_indptr, self.pyg_t_src, self.pyg_t_dst, self.pyg_t_weight)
            plans = (self.pyg_hub_segments, self.pyg_t_hub_segments)
        else:
            raise ValueError(f"unknown propagate kind {kind!r}")
        if self.symmetric:
            csr_t = csr
            plans = (plans[0], plans[0])
        if self.slab_dtype == "int8":
            return _spmm_kernel.csr_spmm_q8_autograd(x, csr, csr_t, self.rs, *plans,
                                                     self.hub_edges)
        return _spmm_kernel.csr_spmm_autograd(x, csr, csr_t, *plans, self.hub_edges)

    def propagate_edge_values(self, x: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
        """out[i, h] = sum over edges e into i of values[e, h] * x[src_e, h],
        through the per-edge-value kernel (its plain version on the CPU).

        x: [N, H, D], sent as ``chunk_dtype`` messages; values: [E, H] f32 in
        the dst-sorted edge order. The sum is f32 and the result has x's
        type. Differentiable in x and in values, both from one walk of the
        transposed order (``csr_spmm_ev_bwd``: g gathered once per edge,
        ``values[t_perm]`` read in the kernel). A graph without the
        transposed order raises."""
        if self.t_perm is None or self.t_indptr is None:
            raise ValueError("the graph lacks t_perm/t_indptr, the transposed edge order "
                             "the per-edge-value gradient reads: build it with "
                             "preprocess_graph")
        return _spmm_kernel.csr_spmm_ev_autograd(
            x, values, (self.indptr, self.edge_src, self.edge_dst),
            (self.t_indptr, self.t_edge_src, self.t_edge_dst, self.t_perm),
            _CHUNK_DTYPES[self.chunk_dtype], self.hub_segments, self.t_hub_segments,
            self.hub_edges)


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


def gcn_norm_rs(dst: np.ndarray, num_nodes: int) -> np.ndarray:
    """The separable factor ``rs = 1/sqrt(d_in)`` of the symmetric GCN
    normalisation, with inf (isolated nodes) set to 0: ``gcn_norm_weights``
    is ``rs[dst] * rs[src]`` up to f32 rounding. The int8 aggregation
    pre-scales x by it."""
    d = in_degree(dst, num_nodes)
    with np.errstate(divide="ignore"):
        dinv = 1.0 / np.sqrt(d)
    dinv[~np.isfinite(dinv)] = 0.0
    return dinv.astype(np.float32)


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


def _transpose_csr(src, dst, weight, num_nodes: int, dev: torch.device) -> tuple:
    """CSR of A^T from A's dst-sorted edges: sorted (stably) by source, each
    edge's row is its source and its column its destination. Returns
    (indptr, edge_src, edge_dst, weight, perm, hub plan) in the layout
    :func:`csr_spmm` reads, with perm the dst-sorted id of each edge."""
    order = np.argsort(src, kind="stable")
    t_dst, t_src = src[order], dst[order]
    indptr = build_indptr(t_dst, num_nodes)
    return (_int32(indptr, dev), _int32(t_src, dev),
            _int32(t_dst, dev), torch.from_numpy(np.ascontiguousarray(weight[order])).to(dev),
            _int32(order, dev), _int32(hub_segments(indptr), dev))


def preprocess_graph(
    edge_index,
    num_nodes: int,
    *,
    undirected: bool = True,
    self_loops: bool = True,
    with_pyg_norm: bool = False,
    chunk_dtype: str = "f32",
    slab_dtype: str = "compute",
    dtype=np.float32,
    device="cuda",
) -> Graph:
    """Symmetrise (optionally), replace self-loops, sort by destination and
    normalise, then place the graph on ``device``.

    ``edge_index`` is a [2, E] integer array (numpy, or a tensor on any
    device). ``with_pyg_norm`` also builds the PyG ``gcn_norm`` edges of the
    medium-tier GCN backbone. ``chunk_dtype`` ('f32' or 'bf16') is the
    message type of the per-edge-value aggregation; its default, 'f32', is
    what a JAX graph without chunk plans computes. ``dtype`` is the type of
    the edge weights. The CSR of A^T (with ``t_perm``) is built on every
    graph; with ``undirected=False`` A need not be symmetric, so that of the
    PyG edges is built too.

    ``slab_dtype`` is the JAX plan's name (``SlabSpMM.slab_dtype``):
    'compute' (default) aggregates in x's type; 'int8' through the int8
    kernel (see the module's docstring), with ``rs`` on the graph. As in the
    JAX package, 'int8' needs ``chunk_dtype='bf16'`` (its quantiser works on
    bf16 rows) and separable weights: with ``with_pyg_norm=True`` the PyG
    weights must factor by the same ``rs`` too (they do when the self-loops
    are added here, since both degrees then count the same edges; without
    them PyG adds its own and the build is refused, as ``build_slabs`` of the
    JAX package refuses it).
    On the port int8 is an explicit opt-in: the JAX package's ``'auto'``
    policy decides from VMEM residency, which the card does not have, and its
    TPU layout knobs (slab rows, hub tails, the clustering reorder) have no
    counterpart here.
    """
    if chunk_dtype not in _CHUNK_DTYPES:
        raise ValueError(f"chunk_dtype must be one of {sorted(_CHUNK_DTYPES)}")
    if slab_dtype not in ("compute", "int8"):
        raise ValueError(f"slab_dtype must be 'compute' or 'int8', got {slab_dtype!r}")
    if slab_dtype == "int8" and chunk_dtype != "bf16":
        raise ValueError("slab_dtype='int8' is bf16-path-only: it needs chunk_dtype='bf16' "
                         "(the separable sep_rs weights of the JAX plan)")
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
    names = ("t_indptr", "t_edge_src", "t_edge_dst", "t_weight", "t_perm", "t_hub_segments")
    extra = dict(zip(names, _transpose_csr(src, dst, weight, num_nodes, dev)))
    rs = gcn_norm_rs(dst, num_nodes) if slab_dtype == "int8" else None
    if rs is not None:
        extra["rs"] = torch.from_numpy(rs).to(dev)
    if with_pyg_norm:
        psrc, pdst, pw = pyg_gcn_norm(np.stack([src, dst]), num_nodes)
        pw = pw.astype(dtype)
        off = psrc != pdst
        if rs is not None and not np.allclose(pw[off], rs[psrc[off]] * rs[pdst[off]],
                                              rtol=1e-5, atol=1e-12):
            raise ValueError("slab_dtype='int8' needs separable (sep_rs) weights: this "
                             "graph's PyG gcn_norm weights do not factor as rs[src] * rs[dst]")
        pindptr = build_indptr(pdst, num_nodes)
        extra.update(
            pyg_src=_int32(psrc, dev),
            pyg_dst=_int32(pdst, dev),
            pyg_weight=torch.from_numpy(pw).to(dev),
            pyg_indptr=_int32(pindptr, dev),
            pyg_hub_segments=_int32(hub_segments(pindptr), dev),
        )
        if not undirected:
            t = _transpose_csr(psrc, pdst, pw, num_nodes, dev)
            extra.update(pyg_t_indptr=t[0], pyg_t_src=t[1], pyg_t_dst=t[2], pyg_t_weight=t[3],
                         pyg_t_hub_segments=t[5])
    return Graph(
        edge_src=_int32(src, dev),
        edge_dst=_int32(dst, dev),
        gcn_weight=torch.from_numpy(np.ascontiguousarray(weight)).to(dev),
        indptr=_int32(indptr, dev),
        hub_segments=_int32(hub_segments(indptr), dev),
        hub_edges=HUB_EDGES,
        num_nodes=int(num_nodes),
        num_edges=int(len(src)),
        symmetric=bool(undirected),
        chunk_dtype=chunk_dtype,
        slab_dtype=slab_dtype,
        **extra,
    )
