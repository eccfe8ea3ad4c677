"""CSR SpMM wrapper: ``out = A_norm @ x`` from the dst-sorted CSR graph.

On a CUDA tensor :func:`csr_spmm` launches ``csrc/spmm.cu`` (which replaces
the TPU kernels ``kernels/slab_spmm.py::_ssel_kernel`` and
``kernels/spmm.py::_spmm_kernel`` of the JAX package) or raises. On a CPU
tensor it runs the plain version, :func:`sgformer_tpu_torch.ops.spmm.spmm`.

:func:`csr_spmm_autograd` is the differentiable form: the gradient of
``A @ x`` is ``A^T @ g``, the same kernel on the transposed CSR (the JAX
package's ``_slab_core_bwd`` likewise runs its forward kernels on the
transpose plan). For a symmetric A the transpose is A's own CSR.

``launches`` counts the kernel's launches, forward and backward alike; set
it to 0 to start a count.
"""

from __future__ import annotations

import torch

from sgformer_tpu_torch.kernels import _build
from sgformer_tpu_torch.ops.spmm import spmm as spmm_plain

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def csr_spmm(
    x: torch.Tensor,
    indptr: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    weight: torch.Tensor,
) -> torch.Tensor:
    """out[i] = sum_{e in [indptr[i], indptr[i+1])} weight[e] * x[edge_src[e]].

    x: [N, F] float32 or bfloat16 (any F; the kernel takes 256 columns per
    pass); indptr [N+1], edge_src and edge_dst [E] int32, sorted by dst;
    weight [E] float32. The sum is f32 and the result has x's type.
    ``edge_dst`` is read only by the plain version.
    """
    global launches
    n = indptr.shape[0] - 1
    if x.dim() != 2 or x.shape[0] != n:
        raise ValueError(f"x must be [{n}, F], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    devices = {t.device for t in (x, indptr, edge_src, edge_dst, weight)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    if x.device.type == "cpu":
        return spmm_plain(x, edge_src, edge_dst, weight, n)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")

    F = x.shape[1]
    for name, t, dt in (("indptr", indptr, torch.int32),
                        ("edge_src", edge_src, torch.int32),
                        ("weight", weight, torch.float32)):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous 1-d {dt} tensor")
    if edge_src.shape != weight.shape:
        raise ValueError("edge_src and weight must have one entry per edge")
    x = x.contiguous()
    out = torch.empty_like(x)
    if n == 0 or F == 0:
        return out
    vec8 = F % 8 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    lib = _build.library("spmm")
    err = lib.sgf_csr_spmm(
        indptr.data_ptr(), edge_src.data_ptr(), weight.data_ptr(),
        x.data_ptr(), out.data_ptr(), n, F, _DTYPES[x.dtype], int(vec8),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "csr_spmm")
    launches += 1
    return out


class CsrSpmmFunction(torch.autograd.Function):
    """``A @ x`` with ``A^T @ g`` as its gradient, both through
    :func:`csr_spmm`. Only x gets a gradient; the CSR arrays get none."""

    @staticmethod
    def forward(ctx, x, indptr, edge_src, edge_dst, weight,
                t_indptr, t_edge_src, t_edge_dst, t_weight):
        ctx.transpose = (t_indptr, t_edge_src, t_edge_dst, t_weight)
        return csr_spmm(x, indptr, edge_src, edge_dst, weight)

    @staticmethod
    def backward(ctx, g):
        dx = csr_spmm(g.contiguous(), *ctx.transpose)
        return (dx,) + (None,) * 8


def csr_spmm_autograd(x: torch.Tensor, csr: tuple, csr_t: tuple) -> torch.Tensor:
    """:func:`csr_spmm` of ``x`` on ``csr`` = (indptr, edge_src, edge_dst,
    weight), differentiable in x; ``csr_t`` is the CSR of A^T in the same
    form (``csr`` itself when A is symmetric). Where autograd does not
    record (``torch.no_grad``, ``torch.inference_mode``, or x needs no
    gradient) it is one :func:`csr_spmm` and saves nothing."""
    if torch.is_grad_enabled() and x.requires_grad:
        return CsrSpmmFunction.apply(x, *csr, *csr_t)
    return csr_spmm(x, *csr)
