"""Sparse aggregation over the dst-sorted edge list: plain PyTorch.

The port of ``sgformer_tpu/ops/spmm.py``. :func:`spmm` is the CPU path of
:func:`sgformer_tpu_torch.kernels.spmm.csr_spmm` and the oracle its CUDA
kernel is held against on the card; :func:`spmm_edge_values` is the same for
:func:`sgformer_tpu_torch.kernels.spmm.csr_spmm_ev` (runtime per-edge values
per head, GAT's aggregation).

The sum is taken in f32 and rounded once to the output type, as the CUDA
kernels do. The JAX function multiplies and ``segment_sum``-s in x's type, so
on its bf16 path every partial sum is rounded to bf16 (``ops/spmm.py:44-52``
of the JAX package); the port's bf16 aggregation is the more exact of the two.
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
    """out[i] = sum over edges e with dst[e] == i of weight[e] * x[src[e]]."""
    msgs = x.float().index_select(0, edge_src.long())
    if weight is not None:
        msgs = msgs * weight.float()[:, None]
    out = torch.zeros(num_nodes, x.shape[1], dtype=torch.float32, device=x.device)
    out.index_add_(0, edge_dst.long(), msgs)
    return out.to(x.dtype)


def spmm_edge_values(
    x: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    values: torch.Tensor,
    num_nodes: int,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """out[i, h] = sum over edges e with dst[e] == i of values[e, h] * x[src[e], h].

    x: [N, H, D]; values: [E, H] (used in f32). The sum is f32 and the result
    has ``out_dtype`` (x's type when None)."""
    msgs = x.float().index_select(0, edge_src.long()) * values.float()[..., None]
    out = torch.zeros(num_nodes, *x.shape[1:], dtype=torch.float32, device=x.device)
    out.index_add_(0, edge_dst.long(), msgs)
    return out.to(out_dtype or x.dtype)


def edge_softmax(scores: torch.Tensor, edge_dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Per-destination softmax over incoming-edge scores ([E] or [E, H]),
    the normalisation inside PyG's ``GATConv``.

    As in the JAX function, a destination's max that is not finite (no
    incoming edge, or only -inf scores) becomes 0, and the denominator is
    floored at 1e-16. The shift by the max has an exact gradient of 0 (the
    softmax does not depend on it), so it is taken out of autograd with
    ``detach``: a gradient through ``scatter_reduce("amax")`` would split
    between tied maxima and add only rounding noise."""
    dst = edge_dst.long()
    shape = (num_nodes,) + tuple(scores.shape[1:])
    idx = dst.view(-1, *([1] * (scores.dim() - 1))).expand_as(scores)
    mx = torch.full(shape, float("-inf"), dtype=scores.dtype, device=scores.device)
    mx = mx.scatter_reduce(0, idx, scores.detach(), "amax", include_self=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    e = torch.exp(scores - mx[dst])
    den = torch.zeros(shape, dtype=scores.dtype, device=scores.device).index_add(0, dst, e)
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
