"""The node partition of full-graph training across ranks: the port of
``sgformer_tpu/parallel/partition.py``.

Nodes are padded to a multiple of the shard count S and split into
contiguous blocks of B = ceil(N / S) rows: shard s owns rows [s B, (s+1) B).
The global edges are sorted by destination, so each shard's edges are one
contiguous range of them; the shard keeps their global source ids and its
own local destinations. Each rank builds only its own shard (the host work,
slicing and the halo plans, runs on every rank alike).

A shard aggregates through the CSR SpMM kernel on a rectangular A
(:func:`sgformer_tpu_torch.kernels.spmm.csr_spmm`): its B rows, and as
columns either

- every shard's rows gathered ([S B, F], :func:`.comm.all_gather_rows`), or
- with the halo (``with_halo=True``, the GCN edges only), its own rows for
  the edges whose source it owns and a table of only the rows its other
  edges read ([S H, F], :func:`.comm.all_to_all_rows` of each peer's
  boundary rows): traffic S H F instead of S B F, in proportion to the
  partition's edge cut, which the clustering reorder
  (``preprocess_graph(reorder=True)``) shrinks.

Each CSR carries the CSR of its transpose and both hub plans, built on the
rank's device with :func:`sgformer_tpu_torch.graph.graph_from_sorted`'s
helpers, so the gradient is the same kernel on Aᵀ. The halo's send gather is
itself a unit-weight CSR (one edge a sent row), so its gradient is a CSR
walk too: every sum runs in a fixed order, with no float atomics, and a
sharded step repeats bit for bit.

The JAX package pads every shard's edges to one length (static shapes for
``shard_map``) and builds MXU chunk plans; neither has a counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sgformer_tpu_torch.device import resolve_device
from sgformer_tpu_torch.graph import Graph, _indptr, _transpose_csr
from sgformer_tpu_torch.kernels.spmm import HUB_EDGES, csr_spmm_autograd, hub_plan
from sgformer_tpu_torch.parallel.comm import all_gather_rows, all_to_all_rows
from sgformer_tpu_torch.parallel.mesh import shard_rows


@dataclasses.dataclass(frozen=True)
class ShardCsr:
    """A rectangular CSR A ([rows, cols], dst-sorted) and the CSR of Aᵀ
    ([cols, rows]), each as (indptr, edge_src, edge_dst, weight) with its hub
    plan of :data:`HUB_EDGES`-edge segments, on one device."""

    fwd: tuple
    bwd: tuple
    fwd_segments: torch.Tensor
    bwd_segments: torch.Tensor
    rows: int
    cols: int

    @property
    def num_edges(self) -> int:
        return int(self.fwd[1].shape[0])

    @classmethod
    def build(cls, src, dst, weight, rows: int, cols: int, device) -> "ShardCsr":
        """From edges sorted by ``dst`` (< rows), with sources ``src``
        (< cols) and f32 ``weight``: host arrays or tensors."""
        dev = torch.device(device)

        def place(a, dtype):
            return torch.as_tensor(a).to(dev, dtype).contiguous()

        src, dst, w = place(src, torch.int32), place(dst, torch.int32), place(weight, torch.float32)
        indptr = _indptr(dst, rows)
        t_indptr, t_src, t_dst, t_w, _, t_plan = _transpose_csr(src, dst, w, cols)
        return cls((indptr, src, dst, w), (t_indptr, t_src, t_dst, t_w),
                   hub_plan(indptr, HUB_EDGES), t_plan, int(rows), int(cols))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x ([rows, F] from x [cols, F]) through the CSR SpMM kernel,
        differentiable in x (Aᵀ @ g through the same kernel)."""
        return csr_spmm_autograd(x, self.fwd, self.bwd, self.fwd_segments,
                                 self.bwd_segments, HUB_EDGES)


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """One shard's halo exchange: ``send`` gathers the rows this shard ships
    ([S H, B]: slot j H + k holds the k-th row peer j reads, empty past
    their count), ``local`` aggregates the edges whose source this shard
    owns ([B, B]), ``remote`` the others over the received table ([B, S H]).
    ``rows`` is H, the slots a peer gets from each shard."""

    send: ShardCsr
    local: ShardCsr
    remote: ShardCsr
    rows: int


@dataclasses.dataclass(frozen=True)
class ShardGraph:
    """One rank's shard of a node-partitioned graph, on its device.

    Attributes:
      gcn: the GraphConv-normalised edges into this shard's rows, sources
        global ([B, S B]); pyg: the PyG ``gcn_norm`` edges likewise (None
        when the graph has none).
      halo: the halo plan of the GCN edges, or None (aggregate over the
        all-gathered rows).
      num_nodes: rows per shard (B); total_nodes: S B; num_real_nodes: the
        graph's N; num_edges: the graph's edge count (all shards');
        num_shards, rank, axis_name: the partition and its mesh axis.
    """

    gcn: ShardCsr
    pyg: Optional[ShardCsr]
    halo: Optional[HaloPlan]
    num_nodes: int
    total_nodes: int
    num_real_nodes: int
    num_edges: int
    num_shards: int
    rank: int
    axis_name: str

    @property
    def halo_rows(self) -> int:
        return 0 if self.halo is None else self.halo.rows

    def propagate(self, x: torch.Tensor, kind: str = "gcn") -> torch.Tensor:
        """This shard's rows of A_norm @ x, from its own rows x ([B, F]):
        ``kind='gcn'`` the GraphConv normalisation (through the halo when
        the shard has one), ``'pyg'`` the PyG edges; the other shards' rows
        arrive by one collective. Differentiable in x."""
        if kind == "gcn" and self.halo is not None:
            h = self.halo
            sent = h.send(x).view(self.num_shards, h.rows, x.shape[1])
            table = all_to_all_rows(sent, self.axis_name).view(-1, x.shape[1])
            return h.local(x) + h.remote(table)
        if kind == "gcn":
            csr = self.gcn
        elif kind == "pyg":
            if self.pyg is None:
                raise ValueError("pyg edges missing: preprocess_graph(..., with_pyg_norm=True)")
            csr = self.pyg
        else:
            raise ValueError(f"unknown propagate kind {kind!r}")
        return csr(all_gather_rows(x, self.axis_name))


def shard_edges(src, dst, weight, indptr, num_shards: int, block: int, num_nodes: int):
    """Each shard's slice of the dst-sorted global edges: a list of S
    (src global, dst local, weight) host arrays, the JAX ``_shard_edges``
    without its padding to one length."""
    src, dst, weight, indptr = (np.asarray(a) for a in (src, dst, weight, indptr))
    out = []
    for s in range(num_shards):
        lo, hi = min(s * block, num_nodes), min((s + 1) * block, num_nodes)
        e0, e1 = int(indptr[lo]), int(indptr[hi])
        out.append((src[e0:e1].astype(np.int32), (dst[e0:e1] - lo).astype(np.int32),
                    weight[e0:e1].astype(np.float32)))
    return out


def build_halo(shards, block: int, num_shards: int):
    """The halo plans of every shard from :func:`shard_edges`' slices, the
    JAX ``_build_halo`` without its padding: returns (send, H, local,
    remote) with ``send[i][j]`` the local rows shard i ships to shard j
    (sorted), H the largest such count (at least 1), ``local[j]`` shard j's
    edges from its own rows (src local, dst, weight) and ``remote[j]`` its
    other edges (src an index i H + k into the received table, dst,
    weight), each in the shard's edge order."""
    S = num_shards
    need = [[np.empty(0, np.int64)] * S for _ in range(S)]
    for j in range(S):
        src_j = shards[j][0].astype(np.int64)
        owners = src_j // block
        for i in range(S):
            if i != j:
                need[i][j] = np.unique(src_j[owners == i])
    H = max([1] + [len(need[i][j]) for i in range(S) for j in range(S) if i != j])
    send = [[need[i][j] - i * block for j in range(S)] for i in range(S)]
    local, remote = [], []
    for j in range(S):
        src_j, dst_j, w_j = shards[j]
        src_j = src_j.astype(np.int64)
        owners = src_j // block
        own = owners == j
        local.append((src_j[own] - j * block, dst_j[own], w_j[own]))
        src_h, owners_h = src_j[~own], owners[~own]
        g = np.empty(len(src_h), dtype=np.int64)
        for i in range(S):
            m = owners_h == i
            if i != j and m.any():
                g[m] = i * H + np.searchsorted(need[i][j], src_h[m])
        remote.append((g, dst_j[~own], w_j[~own]))
    return send, H, local, remote


def partition_graph(graph: Graph, num_shards: int, rank: int, axis_name: str = "sp", *,
                    with_halo: bool = False, device=None) -> ShardGraph:
    """Shard ``rank`` of ``graph`` split into ``num_shards`` contiguous node
    blocks, on ``device`` (the graph's when None). ``with_halo`` builds the
    halo plan of the GCN edges (the PyG edges always aggregate over the
    all-gathered rows, as in the JAX package)."""
    if graph.slab_dtype != "compute":
        raise ValueError("a node-sharded graph aggregates in x's type: build it with "
                         "slab_dtype='compute'")
    if not 0 <= rank < num_shards:
        raise ValueError(f"rank {rank} outside [0, {num_shards})")
    dev = graph.device if device is None else resolve_device(device)
    n = graph.num_nodes
    block = shard_rows(n, num_shards)
    total = block * num_shards

    def host(t):
        return t.cpu().numpy()

    shards = shard_edges(host(graph.edge_src), host(graph.edge_dst), host(graph.gcn_weight),
                         host(graph.indptr), num_shards, block, n)
    gcn = ShardCsr.build(*shards[rank], block, total, dev)
    pyg = None
    if graph.pyg_src is not None:
        p = shard_edges(host(graph.pyg_src), host(graph.pyg_dst), host(graph.pyg_weight),
                        host(graph.pyg_indptr), num_shards, block, n)[rank]
        pyg = ShardCsr.build(*p, block, total, dev)
    halo = None
    if with_halo:
        send, H, local, remote = build_halo(shards, block, num_shards)
        slots = [j * H + np.arange(len(send[rank][j])) for j in range(num_shards)]
        rows = np.concatenate(send[rank])
        halo = HaloPlan(
            send=ShardCsr.build(rows, np.concatenate(slots), np.ones(len(rows), np.float32),
                                num_shards * H, block, dev),
            local=ShardCsr.build(*local[rank], block, block, dev),
            remote=ShardCsr.build(*remote[rank], block, num_shards * H, dev),
            rows=H,
        )
    return ShardGraph(gcn=gcn, pyg=pyg, halo=halo, num_nodes=block, total_nodes=total,
                      num_real_nodes=n, num_edges=graph.num_edges, num_shards=num_shards,
                      rank=rank, axis_name=axis_name)


def idx_to_mask(idx, total_nodes: int) -> np.ndarray:
    """[total_nodes] float32 mask: 1 at the node ids ``idx``."""
    m = np.zeros(total_nodes, dtype=np.float32)
    m[np.asarray(idx)] = 1.0
    return m


def edge_cut(graph: Graph, num_shards: int) -> int:
    """Edges whose two ends fall in different shards of ``num_shards``
    contiguous blocks: what the halo must carry."""
    block = shard_rows(graph.num_nodes, num_shards)
    src = graph.edge_src.long() // block
    dst = graph.edge_dst.long() // block
    return int((src != dst).sum().item())
