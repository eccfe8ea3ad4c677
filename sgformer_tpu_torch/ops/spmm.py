"""Sparse aggregation over the dst-sorted edge list: plain PyTorch.

The port of ``sgformer_tpu/ops/spmm.py``. :func:`spmm` is the CPU path of
:func:`sgformer_tpu_torch.kernels.spmm.csr_spmm` and the oracle its CUDA
kernel is held against on the card; :func:`spmm_edge_values` is the same for
:func:`sgformer_tpu_torch.kernels.spmm.csr_spmm_ev` (runtime per-edge values
per head, GAT's aggregation), and :func:`spmm_edge_values_backward` for its
gradient, :func:`sgformer_tpu_torch.kernels.spmm.csr_spmm_ev_bwd`.

The sum is taken in f32 and rounded once to the output type, as the CUDA
kernels do. The JAX function multiplies and ``segment_sum``-s in x's type, so
on its bf16 path every partial sum is rounded to bf16 (``ops/spmm.py:44-52``
of the JAX package); the port's bf16 aggregation is the more exact of the two.

Every sum over a destination's edges is taken in one fixed order, the edges'
own order within the destination (a stable sort by destination, then
:func:`segment_sum`), with no float atomics: the same inputs give the same
bits on every run, on the card as on the CPU, and those of a sequential
``index_add``.

:func:`quantize_absmax` and :func:`spmm_q8` are the int8 aggregation of a
graph built with ``slab_dtype="int8"``, transcribed from the JAX package's
``kernels/slab_spmm.py::_apply_side``: the plain versions of the quantiser
kernel :func:`sgformer_tpu_torch.kernels.spmm.quantize_absmax` (bit for
bit) and of :func:`sgformer_tpu_torch.kernels.spmm.csr_spmm_q8`.
"""

from __future__ import annotations

import torch


def spmm(
    x: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    weight: torch.Tensor | None,
    num_nodes: int,
) -> torch.Tensor:
    """out[i] = sum over edges e with dst[e] == i of weight[e] * x[src[e]]
    (the edges in any order): [num_nodes, F] for any x of more than
    max(src) rows, so A may be rectangular."""
    dst, order = torch.sort(edge_dst.long(), stable=True)
    msgs = x.float()[edge_src.long()[order]]
    if weight is not None:
        msgs = msgs * weight.float()[order][:, None]
    return segment_sum(msgs, dst, num_nodes).to(x.dtype)


class _SegmentSum(torch.autograd.Function):
    """:func:`segment_sum`; its gradient gathers each segment's cotangent
    back to the segment's rows (autograd of ``segment_reduce`` would loop
    over each segment's rows in one thread, a long wait on a hub row)."""

    @staticmethod
    def forward(ctx, data, ids, num_segments):
        ctx.save_for_backward(ids)
        bounds = torch.searchsorted(ids, torch.arange(num_segments + 1, device=ids.device))
        # unsafe: the lengths add up to the rows by construction; the check
        # would wait for the card
        return torch.segment_reduce(data, "sum", lengths=torch.diff(bounds), axis=0,
                                    unsafe=True)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return grad.index_select(0, ids), None, None


def segment_sum(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """[num_segments, ...]: out[i] is the sum of the rows of ``data`` whose
    segment id (``ids``, int64, non-decreasing: each segment's rows are
    consecutive) is i, 0 for none. Each segment is summed in row order from
    0, with no atomics and no wait for the card: the same inputs give the
    same bits on every run and on every device (those of a sequential
    ``index_add``). Differentiable in ``data``."""
    return _SegmentSum.apply(data, ids, num_segments)


def quantize_absmax(x: torch.Tensor, rs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pass absmax int8 quantisation of ``x`` pre-scaled by ``rs``, as
    ``_apply_side`` of the JAX package computes it (``slab_spmm.py:380-394``):

    - ``xs = x.bf16 * rs.bf16[:, None]``, rounded to bf16;
    - ``s = max(max|xs|, 1e-30)`` in f32;
    - ``q = clamp(round(xs * (127 / s)), -127, 127)`` as int8, rounding half
      to even (``torch.round`` and ``jnp.round`` both do).

    Returns (q [N, F] int8, s, a 0-d f32 tensor on x's device: no host sync).
    ``127 / s`` is a true division of two device tensors: PyTorch computes
    ``scalar / tensor`` as a reciprocal times the scalar, which rounds
    differently.
    """
    xs = x.to(torch.bfloat16) * rs.to(torch.bfloat16)[:, None]
    xf = xs.float()
    s = torch.clamp_min(xf.abs().amax(), 1e-30)
    scale = torch.div(s.new_full((), 127.0), s)
    q = torch.clamp(torch.round(xf * scale), -127.0, 127.0).to(torch.int8)
    return q, s


def spmm_q8_apply(
    q: torch.Tensor,
    s: torch.Tensor,
    x_self: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    weight: torch.Tensor,
    rs: torch.Tensor,
    num_nodes: int,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """The aggregation of quantised rows, with the epilogue of
    ``slab_spmm.py:427-436`` in f32 and in its order:

    ``out[i] = ((acc[i] * (s/127)) * rs[i]) + w_self[i] * x_self[i]``,

    ``acc[i]`` the exact int32 sum of ``q[src_e]`` over the edges into i
    that are not self edges, ``w_self[i]`` the sum of the self edges'
    weights (pulled out unquantised, as ``build_slabs`` does,
    ``slabs.py:704-707``), ``x_self`` the bf16 x. Non-self edges' weights are
    not read: they are ``rs[src] * rs[dst]``, carried by ``q`` and ``rs``."""
    src, dst = edge_src.long(), edge_dst.long()
    self_edge = src == dst
    keep = ~self_edge
    acc = torch.zeros(num_nodes, q.shape[1], dtype=torch.int32, device=q.device)
    acc.index_add_(0, dst[keep], q.index_select(0, src[keep]).to(torch.int32))
    w_self = torch.zeros(num_nodes, dtype=torch.float32, device=q.device)
    w_self.index_add_(0, dst[self_edge], weight.float()[self_edge])
    # s / 127 divides two device tensors: a CUDA divisor that is a host
    # scalar becomes a multiplication by its reciprocal, which rounds
    # differently from the kernel's division
    out = acc.float() * torch.div(s, s.new_full((), 127.0))
    out = out * rs.float()[:, None]
    out = out + w_self[:, None] * x_self.float()
    return out.to(out_dtype)


def spmm_q8(
    x: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    weight: torch.Tensor,
    rs: torch.Tensor,
    num_nodes: int,
) -> torch.Tensor:
    """The int8 GCN aggregation of a graph with separable weights
    ``w_e = rs[src] * rs[dst]``:

    ``out[i] = rs[i] * (s/127) * sum_{e into i, src != i} q[src_e]
    + sum_{e into i, src == i} w_e * x_bf16[i]``

    with ``(q, s) = quantize_absmax(x, rs)``; the result has x's type."""
    q, s = quantize_absmax(x, rs)
    return spmm_q8_apply(q, s, x.to(torch.bfloat16), edge_src, edge_dst, weight, rs,
                         num_nodes, x.dtype)


def spmm_edge_values(
    x: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    values: torch.Tensor,
    num_nodes: int,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """out[i, h] = sum over edges e with dst[e] == i of values[e, h] * x[src[e], h].

    x: [N, H, D]; values: [E, H] (used in f32); the edges in any order. The
    sum is f32 and the result has ``out_dtype`` (x's type when None)."""
    dst, order = torch.sort(edge_dst.long(), stable=True)
    msgs = x.float()[edge_src.long()[order]] * values.float()[order][..., None]
    return segment_sum(msgs, dst, num_nodes).to(out_dtype or x.dtype)


def spmm_edge_values_backward(
    g: torch.Tensor,
    x: torch.Tensor,
    values: torch.Tensor,
    t_edge_src: torch.Tensor,
    t_edge_dst: torch.Tensor,
    t_perm: torch.Tensor,
    msg_dtype: torch.dtype,
    need_dx: bool = True,
    need_dv: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The gradient of :func:`spmm_edge_values` of x sent as ``msg_dtype``
    messages, as the JAX package's ``_spmm_ev_bwd`` defines it, from the
    transposed edge order (``t_edge_src`` the destinations, ``t_edge_dst``
    the sources, ``t_perm`` the dst-sorted id of each edge):

    - dx: :func:`spmm_edge_values` of g rounded to ``msg_dtype`` on the
      transposed order with ``values[t_perm]``, the result in x's type;
    - dv: ``g[dst_e] . x[src_e]`` of the unrounded g and x in f32
      (:func:`sgformer_tpu_torch.ops.sddmm.sddmm`), [E, H] in the
      dst-sorted order.

    g and x: [N, H, D]; values: [E, H]. A gradient not asked for is None."""
    from sgformer_tpu_torch.ops.sddmm import sddmm  # ops.sddmm imports this module

    dx = dv = None
    if need_dx:
        dx = spmm_edge_values(g.to(msg_dtype), t_edge_src, t_edge_dst,
                              values.index_select(0, t_perm.long()), x.shape[0], x.dtype)
    if need_dv:
        dv = torch.empty(values.shape, dtype=torch.float32, device=values.device)
        dv[t_perm.long()] = sddmm(g.float(), x.float(), t_edge_dst, t_edge_src)
    return dx, dv


def edge_softmax(scores: torch.Tensor, edge_dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Per-destination softmax over incoming-edge scores ([E] or [E, H]),
    the normalisation inside PyG's ``GATConv``. The edges are in CSR order
    (``edge_dst`` non-decreasing, as every :class:`sgformer_tpu_torch.graph.Graph`
    keeps them).

    As in the JAX function, a destination's max that is not finite (no
    incoming edge, or only -inf scores) becomes 0, and the denominator is
    floored at 1e-16. The shift by the max has an exact gradient of 0 (the
    softmax does not depend on it), so it is taken out of autograd with
    ``detach``: a gradient through ``scatter_reduce("amax")`` would split
    between tied maxima and add only rounding noise. The max is exact in any
    order; the denominators are :func:`segment_sum`'s fixed-order sums over
    each destination's run of edges, so the weights are the same bits on
    every run."""
    dst = edge_dst.long()
    shape = (num_nodes,) + tuple(scores.shape[1:])
    idx = dst.view(-1, *([1] * (scores.dim() - 1))).expand_as(scores)
    mx = torch.full(shape, float("-inf"), dtype=scores.dtype, device=scores.device)
    mx = mx.scatter_reduce(0, idx, scores.detach(), "amax", include_self=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    e = torch.exp(scores - mx[dst])
    den = segment_sum(e, dst, num_nodes)
    return e / den[dst].clamp(min=1e-16)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """``torch_scatter.scatter(..., reduce='mean')``: the mean of ``data``'s
    rows per segment; an empty segment gives 0."""
    ids = segment_ids.long()
    total = torch.zeros(num_segments, *data.shape[1:], dtype=data.dtype,
                        device=data.device).index_add(0, ids, data)
    count = torch.zeros(num_segments, dtype=data.dtype, device=data.device).index_add(
        0, ids, torch.ones(data.shape[0], dtype=data.dtype, device=data.device))
    return total / count.clamp(min=1.0).view(-1, *([1] * (data.dim() - 1)))
