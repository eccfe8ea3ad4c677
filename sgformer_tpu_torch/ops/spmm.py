"""Sparse matrix times dense (SpMM), the GCN aggregation: plain PyTorch.

The port of ``sgformer_tpu/ops/spmm.py::spmm``. It is the CPU path of
:func:`sgformer_tpu_torch.kernels.spmm.csr_spmm` and the oracle its CUDA
kernel is held against on the card.

The sum is taken in f32 and rounded once to x's type, as the CUDA kernel
does. The JAX function multiplies and ``segment_sum``-s in x's type, so on
its bf16 path every partial sum is rounded to bf16 (``ops/spmm.py:44-52`` of
the JAX package); the port's bf16 aggregation is the more exact of the two.
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
