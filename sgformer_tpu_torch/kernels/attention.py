"""Linear-attention kernel wrappers: reduce and apply, forward.

On CUDA tensors :func:`reduce` and :func:`apply` launch the kernels of
``csrc/linear_attention.cu``, which replace the TPU kernels
``kernels/attention.py::_reduce_kernel`` and ``::_apply_kernel`` of the JAX
package, or raise. On CPU tensors they run :func:`reduce_plain` and
:func:`apply_plain`. :func:`fused_linear_attention` keeps the JAX layout,
[N, H, M] in and [N, H, D] out, and loops the heads as the JAX ``_attn_core``
does, reading each head in place through its row stride. With several heads
q and k are scaled by one norm over all heads, as in the SGFormer reference
and the plain path; the JAX Pallas path scales each head by its own norms,
which agrees only at H = 1.

``reduce_launches`` and ``apply_launches`` count the launches; set them to 0
to start a count.
"""

from __future__ import annotations

import torch

from sgformer_tpu_torch.kernels import _build

reduce_launches = 0
apply_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64
_ROWS = 32
_WAVES = 4  # reduce blocks per SM to aim for


def _inv(q_sq: torch.Tensor, k_sq: torch.Tensor, guard: bool) -> torch.Tensor:
    if not guard:
        return 1.0 / (q_sq.sqrt() * k_sq.sqrt())
    one = torch.ones_like(q_sq)
    nonzero = (q_sq > 0.0) & (k_sq > 0.0)
    q_norm = torch.where(q_sq > 0.0, q_sq, one).sqrt()
    k_norm = torch.where(k_sq > 0.0, k_sq, one).sqrt()
    return torch.where(nonzero, 1.0 / (q_norm * k_norm), torch.zeros_like(q_sq))


def reduce_plain(q, k, v, guard: bool):
    """kvs = k^T v [M, D], ksum [M] and scal = (||q||^2, ||k||^2, inv, 0),
    all f32. ``guard`` zeroes inv when a norm is zero (masked inputs)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    q_sq, k_sq = qf.square().sum(), kf.square().sum()
    scal = torch.stack([q_sq, k_sq, _inv(q_sq, k_sq, guard), torch.zeros_like(q_sq)])
    return torch.einsum("nm,nd->md", kf, vf), kf.sum(dim=0), scal


def apply_plain(q, v, kvs, ksum, scal, n_total, guard: bool):
    """(inv * q @ kvs + n * v) / (inv * q . ksum + n) in f32, in q's type.
    ``guard`` turns a zero denominator into 1 (masked inputs)."""
    qf = q.float()
    inv = scal[2]
    num = torch.einsum("nm,md->nd", qf, kvs) * inv + n_total * v.float()
    den = (torch.einsum("nm,m->n", qf, ksum) * inv + n_total)[:, None]
    if guard:
        den = torch.where(den == 0.0, torch.ones_like(den), den)
    return (num / den).to(q.dtype)


def _check_rows(name: str, t: torch.Tensor, n: int, dtype) -> None:
    if t.dim() != 2 or t.shape[0] != n:
        raise ValueError(f"{name} must be [{n}, *], got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if t.stride(1) != 1:
        raise ValueError(f"{name} must be contiguous along its last dimension")


def _device_of(*ts: torch.Tensor) -> torch.device:
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _slices(n: int, m: int, d: int, device: torch.device) -> tuple[int, int]:
    """Split the N rows into slices so the reduce grid fills the card about
    _WAVES times over; slice length is a multiple of the 32-row step."""
    tiles = _cdiv(m, _TILE) * _cdiv(d, _TILE)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, min(_cdiv(n, _ROWS), _cdiv(_WAVES * sms, tiles)))
    rows = _cdiv(_cdiv(n, want), _ROWS) * _ROWS
    return _cdiv(n, rows), rows


def reduce(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, guard: bool = False):
    """Per-head cross-node sums. q, k: [N, M]; v: [N, D]; float32 or
    bfloat16, each contiguous along its last dimension (rows may be strided).
    Returns kvs [M, D], ksum [M] and scal [4], all f32."""
    global reduce_launches
    n = q.shape[0]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    _check_rows("q", q, n, q.dtype)
    _check_rows("k", k, n, q.dtype)
    _check_rows("v", v, n, q.dtype)
    if k.shape[1] != q.shape[1]:
        raise ValueError("q and k must have the same width")
    if _device_of(q, k, v).type == "cpu":
        return reduce_plain(q, k, v, guard)
    if n == 0:
        raise ValueError("linear attention needs at least one node")

    m, d = q.shape[1], v.shape[1]
    slices, rows = _slices(n, m, d, q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    kvs_part = torch.empty(slices, m, d, **f32)
    ksum_part = torch.empty(slices, m, **f32)
    qsq_part = torch.empty(slices, m, **f32)
    ksq_part = torch.empty(slices, m, **f32)
    kvs = torch.empty(m, d, **f32)
    ksum = torch.empty(m, **f32)
    scal = torch.empty(4, **f32)
    err = _build.library("linear_attention").sgf_la_reduce(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q.stride(0), k.stride(0), v.stride(0), n, m, d, _DTYPES[q.dtype],
        slices, rows, int(guard),
        kvs_part.data_ptr(), ksum_part.data_ptr(), qsq_part.data_ptr(),
        ksq_part.data_ptr(), kvs.data_ptr(), ksum.data_ptr(), scal.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "linear attention reduce")
    reduce_launches += 1
    return kvs, ksum, scal


def apply(q, v, kvs, ksum, scal, n_total, guard: bool = False, out=None):
    """Per-head output rows. q: [N, M]; v: [N, D]; kvs [M, D], ksum [M],
    scal [4] from :func:`reduce`; n_total a 0-d f32 tensor. Writes into
    ``out`` ([N, D], q's type, rows may be strided) when given."""
    global apply_launches
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    n, m = q.shape
    d = v.shape[1]
    _check_rows("q", q, n, q.dtype)
    _check_rows("v", v, n, q.dtype)
    if out is None:
        out = torch.empty(n, d, dtype=q.dtype, device=q.device)
    _check_rows("out", out, n, q.dtype)
    for name, t, shape in (("kvs", kvs, (m, d)), ("ksum", ksum, (m,)),
                           ("scal", scal, (4,)), ("n_total", n_total, ())):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 tensor of shape {shape}")
    if _device_of(q, v, kvs, ksum, scal, n_total, out).type == "cpu":
        out.copy_(apply_plain(q, v, kvs, ksum, scal, n_total, guard))
        return out
    err = _build.library("linear_attention").sgf_la_apply(
        q.data_ptr(), v.data_ptr(), q.stride(0), v.stride(0),
        out.data_ptr(), out.stride(0), n, m, d, _DTYPES[q.dtype],
        kvs.data_ptr(), ksum.data_ptr(), scal.data_ptr(), n_total.data_ptr(),
        int(guard), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "linear attention apply")
    apply_launches += 1
    return out


def fused_linear_attention(
    qs: torch.Tensor,
    ks: torch.Tensor,
    vs: torch.Tensor,
    node_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """SGFormer linear attention through the reduce and apply kernels.

    qs, ks: [N, H, M]; vs: [N, H, D]. The same function as
    :func:`sgformer_tpu_torch.ops.attention.linear_attention` without
    ``output_attn``. Returns [N, H, D] in q's type.
    """
    if qs.dim() != 3 or ks.shape != qs.shape or vs.dim() != 3 \
            or vs.shape[:2] != qs.shape[:2]:
        raise ValueError(
            f"expected qs, ks [N, H, M] and vs [N, H, D], got "
            f"{tuple(qs.shape)}, {tuple(ks.shape)}, {tuple(vs.shape)}"
        )
    guard = node_mask is not None
    if guard:
        m = node_mask.to(qs.dtype)[:, None, None]
        qs, ks, vs = qs * m, ks * m, vs * m
        n_total = node_mask.float().sum()
    else:
        n_total = torch.full((), float(qs.shape[0]), device=qs.device)
    qs, ks, vs = (t if t.stride(2) == 1 else t.contiguous() for t in (qs, ks, vs))
    n, h, _ = qs.shape
    sums = [reduce(qs[:, i], ks[:, i], vs[:, i], guard) for i in range(h)]
    scal = sums[0][2]
    if h > 1:
        # one norm over all heads, as in the reference and the plain path;
        # the JAX Pallas path normalises each head by its own norms
        q_sq = sum(s[2][0] for s in sums)
        k_sq = sum(s[2][1] for s in sums)
        scal = torch.stack([q_sq, k_sq, _inv(q_sq, k_sq, guard), torch.zeros_like(q_sq)])
    out = torch.empty(n, h, vs.shape[2], dtype=qs.dtype, device=qs.device)
    for i, (kvs, ksum, _) in enumerate(sums):
        apply(qs[:, i], vs[:, i], kvs, ksum, scal, n_total, guard, out=out[:, i])
    return out
