"""SDDMM, sampled dense-dense matmul: per-edge dots of node embeddings.
Plain PyTorch; the port of ``sgformer_tpu/ops/sddmm.py``.

:func:`sddmm` is the CPU path of
:func:`sgformer_tpu_torch.kernels.spmm.sddmm` (the gradient of GAT's
aggregation in its per-edge values) and the oracle its CUDA kernel is held
against on the card. It gathers both operands per edge, [E, ..., D] each,
which the kernel never does.
"""

from __future__ import annotations

import torch

from sgformer_tpu_torch.ops.spmm import edge_softmax


def sddmm(q: torch.Tensor, k: torch.Tensor, edge_src: torch.Tensor,
          edge_dst: torch.Tensor) -> torch.Tensor:
    """scores[e] = q[dst[e]] . k[src[e]]; q, k: [N, D] or [N, H, D] ->
    [E] or [E, H], in the inputs' type."""
    qe = q.index_select(0, edge_dst.long())
    ke = k.index_select(0, edge_src.long())
    return (qe * ke).sum(-1)


def sddmm_softmax_weights(q: torch.Tensor, k: torch.Tensor, edge_src: torch.Tensor,
                          edge_dst: torch.Tensor, num_nodes: int, *,
                          scale: float = 1.0) -> torch.Tensor:
    """SDDMM scores, scaled, then the per-destination softmax."""
    return edge_softmax(sddmm(q, k, edge_src, edge_dst) * scale, edge_dst, num_nodes)
