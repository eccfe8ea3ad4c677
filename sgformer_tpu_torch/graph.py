"""Graph container and the one-time preprocessing.

The port of ``sgformer_tpu/graph.py``, CSR path only. ``preprocess_graph``
symmetrises, replaces self-loops, sorts the edges by destination and
normalises them once, on the graph's device, with the JAX package's numpy
results bitwise; :func:`graph_from_sorted` then builds the rest (row
pointers, the transposed CSR, the hub plans) there too. The batch trainer
builds each batch's subgraph with the same functions
(:func:`induced_edges`, :func:`gcn_norm_weights`). The result is a
:class:`Graph` of tensors that stays on the device. Its dst-sorted
``indptr``, ``edge_src`` and ``gcn_weight`` are exactly what the CSR SpMM
kernel reads, so the TPU's slab and chunk plans have no counterpart here.
The clustering reorder does (``preprocess_graph(reorder=True)``,
:mod:`sgformer_tpu_torch.native.reorder`): it relabels the nodes so that
clusters are contiguous, which lines node-sharded training's contiguous
shards up with communities, and records the relabelling in
``Graph.node_perm``. A graph that keeps its labels takes the same
clustering as its CSR kernels' walk order instead (``Graph.schedule``):
the kernels walk its rows cluster by cluster, so that the rows they gather
stay in the card's L2, and write them in place.

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
from sgformer_tpu_torch.kernels.spmm import HUB_EDGES, hub_plan

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
      node_perm: [N] int64 ``perm[new] = old`` of a clustering reorder
        (``preprocess_graph(reorder=True)``), else None: the graph's node i
        is the caller's node ``node_perm[i]``; the trainers and
        ``Predictor`` permute x and labels into this order and the logits
        back.
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
      schedule: [N] int32, the order in which the CSR kernels walk the rows
        of A (and of the PyG edges): the clustering reorder's ``perm``
        (:func:`walk_order`), so that the warps in flight walk one cluster's
        rows and gather from rows that L2 holds; a permutation of the nodes,
        which keep their labels (the result is the same bit for bit in any
        order). None: node order (a ``reorder=True`` graph, whose labels
        are already clustered, and the batch tiers' per-batch graphs).
      t_schedule: the walk order of A^T's rows (and of the PyG transpose's)
        where A^T is not A's own (``symmetric`` False), from the clustering
        of the transposed edges; None on a symmetric graph, whose A^T walks
        in ``schedule`` (:attr:`walk_orders`).
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
    schedule: Optional[torch.Tensor] = None
    t_schedule: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.edge_src.device

    @property
    def walk_orders(self) -> tuple:
        """The walk orders of A's rows and of A^T's: ``(schedule,
        schedule)`` on a symmetric graph, else ``(schedule, t_schedule)``."""
        return (self.schedule, self.schedule if self.symmetric else self.t_schedule)

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
                                                     self.hub_edges, *self.walk_orders)
        return _spmm_kernel.csr_spmm_autograd(x, csr, csr_t, *plans, self.hub_edges,
                                              *self.walk_orders)

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
            self.hub_edges, *self.walk_orders)


class NodeOrder:
    """The caller's node order and a graph's (``Graph.node_perm``, a
    clustering reorder): ``perm`` (``perm[new] = old``) and its inverse
    ``inv`` (``inv[old] = new``), int64 on ``device``, both None when the
    graph keeps the caller's order. The trainers and ``Predictor`` move x and
    the labels into the graph's order and the logits back through it."""

    def __init__(self, node_perm: Optional[torch.Tensor], device=None):
        self.perm = self.inv = None
        if node_perm is not None:
            self.perm = torch.as_tensor(node_perm).to(device, torch.int64)
            self.inv = torch.empty_like(self.perm)
            self.inv[self.perm] = torch.arange(self.perm.numel(), device=self.perm.device)

    def to_graph(self, rows):
        """Node-indexed rows (numpy or a tensor) in the graph's order."""
        if self.perm is None:
            return rows
        if isinstance(rows, torch.Tensor):
            return rows[self.perm.to(rows.device)]
        return np.asarray(rows)[self.perm.cpu().numpy()]

    def to_caller(self, rows: torch.Tensor) -> torch.Tensor:
        """Node-indexed rows in the graph's order back in the caller's."""
        return rows if self.inv is None else rows[self.inv.to(rows.device)]

    def graph_ids(self, idx) -> np.ndarray:
        """The caller's node ids ``idx`` as the graph's."""
        idx = np.asarray(idx, dtype=np.int64)
        return idx if self.inv is None else self.inv.cpu().numpy()[idx]


def graph_leaves(graph: Graph) -> tuple[list[torch.Tensor], dict]:
    """The graph as plain tensors, for a function that takes only tensors
    (an exported forward): its tensor fields in field order, and the spec
    that :func:`graph_from_leaves` rebuilds it with, ``{"tensors": names of
    those fields, "static": the fields that are not tensors}`` (the sizes,
    ``symmetric``, the dtypes, ``hub_edges``); a field left out of both is
    None."""
    tensors, static = [], {}
    for f in dataclasses.fields(graph):
        value = getattr(graph, f.name)
        if isinstance(value, torch.Tensor):
            tensors.append(f.name)
        elif value is not None:
            static[f.name] = value
    return [getattr(graph, name) for name in tensors], {"tensors": tuple(tensors),
                                                         "static": static}


def graph_from_leaves(leaves, spec: dict) -> Graph:
    """The :class:`Graph` of :func:`graph_leaves`' tensors and spec."""
    if len(leaves) != len(spec["tensors"]):
        raise ValueError(f"{len(leaves)} tensors for the {len(spec['tensors'])} of the spec")
    return Graph(**spec["static"], **dict(zip(spec["tensors"], leaves)))


# ---------------------------------------------------------------------------
# Structure work on tensors, on whatever device they are on: the JAX
# package's numpy edge-list transforms and normalisations (which the port
# may not import), bitwise, and the CSRs of a Graph from its dst-sorted
# edges. preprocess_graph runs it once per graph on the graph's device; the
# batch trainer once per batch, on the card.
# ---------------------------------------------------------------------------


def to_undirected(edge_index: torch.Tensor) -> torch.Tensor:
    """Symmetrise and deduplicate an edge list [2, E]."""
    src, dst = edge_index
    return coalesce(torch.stack([torch.cat([src, dst]), torch.cat([dst, src])]))


def coalesce(edge_index: torch.Tensor) -> torch.Tensor:
    """Sort by (dst, src) and remove duplicate edges."""
    src, dst = edge_index
    width = int(max(src.max().item(), dst.max().item(), 0)) + 1 if src.numel() else 1
    key = torch.unique(dst.long() * width + src.long(), sorted=True)
    return torch.stack([key % width, key // width]).to(edge_index.dtype)


def remove_self_loops(edge_index: torch.Tensor) -> torch.Tensor:
    return edge_index[:, edge_index[0] != edge_index[1]]


def add_self_loops(edge_index: torch.Tensor, num_nodes: int) -> torch.Tensor:
    loop = torch.arange(num_nodes, dtype=edge_index.dtype, device=edge_index.device)
    return torch.cat([edge_index, torch.stack([loop, loop])], dim=1)


def sort_by_dst(src: torch.Tensor, dst: torch.Tensor) -> tuple:
    """(src, dst) stably sorted by dst."""
    dst, order = torch.sort(dst, stable=True)
    return src[order], dst


def _indptr(dst_sorted: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """[N+1] int32 row pointers of dst-sorted edges."""
    indptr = torch.zeros(num_nodes + 1, dtype=torch.int64, device=dst_sorted.device)
    torch.cumsum(torch.bincount(dst_sorted, minlength=num_nodes), 0, out=indptr[1:])
    return indptr.int()


def _degree_table(deg: torch.Tensor, fn) -> torch.Tensor:
    """``fn`` (a numpy function on f64) of each integer degree in ``deg``,
    inf and nan set to 0: a table of numpy's own values for 0..max(deg),
    gathered on deg's device. torch's own f64 sqrt need not round as
    numpy's does (its CPU build differs in the last bit for some integers),
    so the table is what keeps the weights bitwise numpy's on every
    device."""
    top = int(deg.max().item()) if deg.numel() else 0
    with np.errstate(divide="ignore"):
        table = fn(np.arange(top + 1, dtype=np.float64))
    table[~np.isfinite(table)] = 0.0
    return torch.from_numpy(table).to(deg.device)[deg.long()]


def _rsqrt_in_degree(dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """[N] f64 ``1/sqrt(d_in)``, 0 for isolated nodes."""
    return _degree_table(torch.bincount(dst, minlength=num_nodes), lambda d: 1.0 / np.sqrt(d))


def gcn_norm_weights(src: torch.Tensor, dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Per-edge ``1/sqrt(d_in[dst] * d_in[src])`` as ``dinv[dst] * dinv[src]``
    in f64, then f32, with isolated nodes' ``dinv`` set to 0."""
    dinv = _rsqrt_in_degree(dst, num_nodes)
    return (dinv[dst.long()] * dinv[src.long()]).float()


def gcn_norm_rs(dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """The separable factor ``rs = 1/sqrt(d_in)`` (f32) of the symmetric GCN
    normalisation, with isolated nodes' set to 0: ``gcn_norm_weights`` is
    ``rs[dst] * rs[src]`` up to f32 rounding. The int8 aggregation
    pre-scales x by it."""
    return _rsqrt_in_degree(dst, num_nodes).float()


def pyg_gcn_norm(src: torch.Tensor, dst: torch.Tensor, num_nodes: int) -> tuple:
    """PyG-style ``gcn_norm`` with self-loops added (not improved): every
    self-loop is replaced by one of weight 1, each edge weighs
    ``dinv[src] * dinv[dst]`` with ``dinv = deg ** -0.5`` over dst (integer
    degrees, since every edge weighs 1). Returns (src, dst, weight) int32,
    int32, f32, sorted by dst."""
    keep = src != dst
    loop = torch.arange(num_nodes, dtype=src.dtype, device=src.device)
    src = torch.cat([src[keep], loop])
    dst = torch.cat([dst[keep], loop])
    dinv = _degree_table(torch.bincount(dst, minlength=num_nodes), lambda d: d ** -0.5)
    weight = dinv[src.long()] * dinv[dst.long()]
    order = torch.sort(dst, stable=True).indices
    return src[order].int(), dst[order].int(), weight[order].float()


def _transpose_csr(src, dst, weight, num_nodes: int) -> tuple:
    """CSR of A^T from A's dst-sorted edges: sorted (stably) by source, each
    edge's row is its source and its column its destination. Returns
    (indptr, edge_src, edge_dst, weight, perm, hub plan) in the layout
    :func:`csr_spmm` reads, with perm the dst-sorted id of each edge."""
    order = torch.sort(src, stable=True).indices
    t_dst, t_src = src[order], dst[order]
    indptr = _indptr(t_dst, num_nodes)
    return (indptr, t_src.contiguous(), t_dst.contiguous(), weight[order].contiguous(),
            order.int(), hub_plan(indptr, HUB_EDGES))


def walk_order(edge_index: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """The CSR kernels' walk order of the rows of the dst-sorted CSR of
    ``edge_index`` ([2, E], src then dst): the clustering reorder's ``perm``
    (:func:`sgformer_tpu_torch.native.reorder.reorder_for_clusters`, label
    propagation over each row's in-neighbours on the host, C++), as [N]
    int32 on edge_index's device."""
    from sgformer_tpu_torch.native.reorder import reorder_for_clusters

    perm, _ = reorder_for_clusters(edge_index.cpu().numpy(), num_nodes)
    return torch.from_numpy(perm).to(edge_index.device, torch.int32)


def _check_walk_order(name: str, order, num_nodes: int, device) -> Optional[torch.Tensor]:
    """A walk order as the kernels take it (contiguous int32 on the graph's
    device), refused unless it is a permutation of the nodes."""
    if order is None:
        return None
    order = torch.as_tensor(order)
    if order.dim() != 1 or order.shape[0] != num_nodes or order.dtype.is_floating_point:
        raise ValueError(f"{name} must be a permutation of the {num_nodes} nodes, got "
                         f"{order.dtype} {tuple(order.shape)}")
    order = order.to(device, torch.int64)
    if not torch.equal(torch.sort(order).values, torch.arange(num_nodes, device=device)):
        raise ValueError(f"{name} is not a permutation of the {num_nodes} nodes")
    return order.int().contiguous()


def check_int32_counts(num_nodes: int, num_edges: int) -> None:
    """Refuse a graph whose node ids or row pointers int32 cannot hold: the
    CSR stores both in int32, so the node and the edge count must each stay
    below 2^31."""
    for what, count in (("nodes", num_nodes), ("edges", num_edges)):
        if count >= 2 ** 31:
            raise ValueError(f"{count} {what}: the graph's int32 node ids and row pointers "
                             f"hold fewer than 2^31")


def graph_from_sorted(
    src: torch.Tensor,
    dst: torch.Tensor,
    weight: torch.Tensor,
    num_nodes: int,
    *,
    symmetric: bool,
    pyg: Optional[tuple] = None,
    chunk_dtype: str = "f32",
    slab_dtype: str = "compute",
    rs: Optional[torch.Tensor] = None,
    node_perm: Optional[torch.Tensor] = None,
    schedule: Optional[torch.Tensor] = None,
    t_schedule: Optional[torch.Tensor] = None,
) -> Graph:
    """A :class:`Graph` of dst-sorted edges on their device: the row
    pointers, the CSR of A^T with ``t_perm``, and the hub plans of both
    (segments of :data:`HUB_EDGES`). ``src``/``dst``: [E] int32, sorted by
    dst; ``weight``: [E] f32. ``pyg``: the PyG edges (src, dst, weight),
    sorted by dst, or None; their transposed CSR is built unless
    ``symmetric`` (A == A^T, whose gradient then walks A's own CSR).
    ``schedule`` and ``t_schedule``: the walk orders of A's rows and of
    A^T's (:class:`Graph`; None: node order), each refused unless it is a
    permutation of the nodes; ``t_schedule`` only where A is not
    symmetric."""
    check_int32_counts(num_nodes, max(src.shape[0], 0 if pyg is None else pyg[0].shape[0]))
    if symmetric and t_schedule is not None:
        raise ValueError("a symmetric graph's A^T walks in A's order: give no t_schedule")
    schedule = _check_walk_order("schedule", schedule, num_nodes, src.device)
    t_schedule = _check_walk_order("t_schedule", t_schedule, num_nodes, src.device)
    names = ("t_indptr", "t_edge_src", "t_edge_dst", "t_weight", "t_perm", "t_hub_segments")
    extra = dict(zip(names, _transpose_csr(src, dst, weight, num_nodes)))
    if pyg is not None:
        psrc, pdst, pw = pyg
        pindptr = _indptr(pdst, num_nodes)
        extra.update(pyg_src=psrc, pyg_dst=pdst, pyg_weight=pw, pyg_indptr=pindptr,
                     pyg_hub_segments=hub_plan(pindptr, HUB_EDGES))
        if not symmetric:
            t = _transpose_csr(psrc, pdst, pw, num_nodes)
            extra.update(pyg_t_indptr=t[0], pyg_t_src=t[1], pyg_t_dst=t[2], pyg_t_weight=t[3],
                         pyg_t_hub_segments=t[5])
    indptr = _indptr(dst, num_nodes)
    return Graph(
        edge_src=src,
        edge_dst=dst,
        gcn_weight=weight,
        indptr=indptr,
        hub_segments=hub_plan(indptr, HUB_EDGES),
        hub_edges=HUB_EDGES,
        num_nodes=int(num_nodes),
        num_edges=int(src.shape[0]),
        symmetric=bool(symmetric),
        chunk_dtype=chunk_dtype,
        slab_dtype=slab_dtype,
        rs=rs,
        node_perm=node_perm,
        schedule=schedule,
        t_schedule=t_schedule,
        **extra,
    )


def induced_edges(edge_index: torch.Tensor, node_idx: torch.Tensor, num_nodes: int) -> tuple:
    """The edges with both ends in ``node_idx``, relabelled to positions in
    it, in edge order: (src, dst) int32 on edge_index's device. Membership
    is a bool per node, so the pass over every edge of the full graph reads
    one byte per end; only the kept edges look up their positions."""
    dev = edge_index.device
    member = torch.zeros(num_nodes, dtype=torch.bool, device=dev)
    member[node_idx] = True
    keep = (torch.index_select(member, 0, edge_index[0])
            & torch.index_select(member, 0, edge_index[1]))
    sub = edge_index[:, keep]
    position = torch.full((num_nodes,), -1, dtype=torch.int32, device=dev)
    position[node_idx] = torch.arange(node_idx.numel(), dtype=torch.int32, device=dev)
    return torch.index_select(position, 0, sub[0]), torch.index_select(position, 0, sub[1])


def subgraph(node_idx, edge_index, num_nodes: int) -> tuple[torch.Tensor, int]:
    """Relabelled node-induced subgraph, the port of the JAX package's
    ``graph.subgraph`` (PyG ``subgraph`` with ``relabel_nodes=True``): the
    edges with BOTH endpoints in ``node_idx``, in their order, relabelled to
    ``0..len(node_idx)-1``, as an int64 [2, E_sub] tensor on edge_index's
    device (numpy input: the CPU), and the subgraph's node count."""
    if not isinstance(edge_index, torch.Tensor):
        edge_index = torch.from_numpy(np.asarray(edge_index))
    node_idx = torch.as_tensor(node_idx, device=edge_index.device).long()
    s, d = induced_edges(edge_index, node_idx, num_nodes)
    return torch.stack([s, d]).long(), int(node_idx.numel())


def preprocess_graph(
    edge_index,
    num_nodes: int,
    *,
    undirected: bool = True,
    self_loops: bool = True,
    with_pyg_norm: bool = False,
    chunk_dtype: str = "f32",
    slab_dtype: str = "compute",
    reorder: bool = False,
    device="cuda",
) -> Graph:
    """Symmetrise (optionally), replace self-loops, sort by destination and
    normalise, all on ``device``, where the graph then stays.

    ``edge_index`` is a [2, E] integer array (numpy, or a tensor on any
    device). The edge weights are f32. ``with_pyg_norm`` also builds the PyG ``gcn_norm`` edges of the
    medium-tier GCN backbone. ``chunk_dtype`` ('f32' or 'bf16') is the
    message type of the per-edge-value aggregation; its default, 'f32', is
    what a JAX graph without chunk plans computes. The CSR of A^T (with ``t_perm``) is built on every
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
    TPU layout knobs (slab rows, hub tails) have no counterpart here.

    ``reorder=True`` relabels the nodes by the clustering reorder before the
    sort (:func:`sgformer_tpu_torch.native.reorder.reorder_for_clusters` of
    the symmetrised, self-looped edges, on the host, C++), as the JAX
    ``preprocess_graph(reorder=True)`` does, and sets ``node_perm`` to its
    ``perm``, bitwise the JAX one.

    A graph that keeps its labels takes the same clustering as the CSR
    kernels' walk order, ``Graph.schedule`` (:func:`walk_order` of the
    symmetrised, self-looped edges; and ``t_schedule`` of the transposed
    edges with ``undirected=False``), once per graph on the host; the
    kernels' results do not depend on it. A ``reorder=True`` graph takes
    none: its labels are already clustered.
    """
    if chunk_dtype not in _CHUNK_DTYPES:
        raise ValueError(f"chunk_dtype must be one of {sorted(_CHUNK_DTYPES)}")
    if slab_dtype not in ("compute", "int8"):
        raise ValueError(f"slab_dtype must be 'compute' or 'int8', got {slab_dtype!r}")
    if slab_dtype == "int8" and chunk_dtype != "bf16":
        raise ValueError("slab_dtype='int8' is bf16-path-only: it needs chunk_dtype='bf16' "
                         "(the separable sep_rs weights of the JAX plan)")
    dev = resolve_device(device)
    if not isinstance(edge_index, torch.Tensor):
        edge_index = torch.from_numpy(np.asarray(edge_index))
    edge_index = edge_index.to(dev)
    if undirected:
        edge_index = to_undirected(edge_index)
    if self_loops:
        edge_index = add_self_loops(remove_self_loops(edge_index), num_nodes)
    node_perm = None
    if reorder:
        from sgformer_tpu_torch.native.reorder import reorder_for_clusters

        perm, inv = reorder_for_clusters(edge_index.cpu().numpy(), num_nodes)
        edge_index = torch.from_numpy(inv).to(dev)[edge_index.long()]
        node_perm = torch.from_numpy(perm).to(dev)
    check_int32_counts(num_nodes, edge_index.shape[1])
    orders = {}
    if not reorder and num_nodes:
        orders["schedule"] = walk_order(edge_index, num_nodes)
        if not undirected:
            orders["t_schedule"] = walk_order(edge_index.flip(0), num_nodes)
    src, dst = sort_by_dst(*edge_index.int())
    weight = gcn_norm_weights(src, dst, num_nodes)
    rs = gcn_norm_rs(dst, num_nodes) if slab_dtype == "int8" else None
    pyg = None
    if with_pyg_norm:
        pyg = pyg_gcn_norm(src, dst, num_nodes)
        psrc, pdst, pw = pyg
        off = psrc != pdst
        if rs is not None and not torch.allclose(
                pw[off], rs[psrc[off].long()] * rs[pdst[off].long()], rtol=1e-5, atol=1e-12):
            raise ValueError("slab_dtype='int8' needs separable (sep_rs) weights: this "
                             "graph's PyG gcn_norm weights do not factor as rs[src] * rs[dst]")
    return graph_from_sorted(src, dst, weight, num_nodes, symmetric=bool(undirected), pyg=pyg,
                             chunk_dtype=chunk_dtype, slab_dtype=slab_dtype, rs=rs,
                             node_perm=node_perm, **orders)


def build_h2_graphs(edge_index, num_nodes: int, *, device="cuda") -> tuple[Graph, Graph]:
    """A1/A2 edge sets for H2GCN, the port of the JAX package's
    ``build_h2_graphs``: A1 the self-loop-free 1-hop adjacency, A2 the exact
    2-hop neighbourhood (the pattern of A^2 less A and the diagonal), each
    normalised as ``preprocess_graph(..., undirected=False,
    self_loops=False)`` does on ``device``. The 2-hop set is found on the
    host with scipy, by the JAX function's own steps, so both give the same
    edges in the same order."""
    import scipy.sparse as sp

    if isinstance(edge_index, torch.Tensor):
        edge_index = edge_index.cpu()
    else:
        edge_index = torch.from_numpy(np.asarray(edge_index))
    src, dst = to_undirected(remove_self_loops(edge_index)).numpy()
    a = sp.csr_matrix((np.ones(len(src)), (dst, src)), shape=(num_nodes, num_nodes))
    a.data[:] = 1.0
    a2 = a @ a
    a2.setdiag(0)
    a2 = (a2 > 0).astype(np.float64)
    a2 = a2 - a2.multiply((a > 0).astype(np.float64))  # drop 1-hop pairs
    a2.eliminate_zeros()

    def graph_of(mat) -> Graph:
        coo = mat.tocoo()
        ei = np.stack([coo.col, coo.row]).astype(np.int64)  # (src, dst)
        return preprocess_graph(ei, num_nodes, undirected=False, self_loops=False,
                                device=device)

    return graph_of(a), graph_of(a2)
