"""Linear-attention kernel wrappers: reduce and apply, forward and backward.

On CUDA tensors :func:`reduce` and :func:`apply` launch the kernels of
``csrc/linear_attention.cu``, which replace the TPU kernels
``kernels/attention.py::_reduce_kernel`` and ``::_apply_kernel`` of the JAX
package, and :func:`bwd_reduce` and :func:`bwd_apply` those of
``csrc/linear_attention_bwd.cu``, which replace ``::_bwd_reduce_kernel`` and
``::_bwd_apply_kernel``; each raises on what its kernel cannot take. On CPU
tensors they run :func:`reduce_plain`, :func:`apply_plain`,
:func:`bwd_reduce_plain` and :func:`bwd_apply_plain`. The two forward
wrappers check their arguments and call their ``torch.library`` custom ops
(:mod:`.ops`): CUDA implementation :func:`reduce_cuda` / :func:`apply_cuda`,
CPU implementation the plain version.

:func:`fused_linear_attention` keeps the JAX layout, [N, H, M] in and
[N, H, D] out, and loops the heads as the JAX ``_attn_core`` does, reading
each head in place through its row stride. Where autograd records, it runs
through a ``torch.autograd.Function`` whose backward is the two backward
kernels; under ``torch.no_grad`` or ``torch.inference_mode`` it calls the
forward kernels directly and saves nothing. With several heads q and k are
scaled by one norm over all heads, as in the SGFormer reference and the
plain path; the JAX Pallas path scales each head by its own norms, which
agrees only at H = 1.

On bf16 inputs every kernel's products run on the tensor cores, with f32
sums: :func:`reduce`'s kᵀv (``la_reduce_wgmma_kernel``, warpgroup MMAs
(wgmma) reading k and v node-major from swizzled shared memory: exact bf16
products, fresh sums every 32 rows, fixed-order f32 sums over slices of
N), :func:`apply`'s q @ kvs (``la_apply_wgmma_kernel``, wgmma: kvs split
into bf16 hi + lo; persistent, one block an SM, the next row block's q rows
landing under this one's MMAs), :func:`bwd_reduce`'s q @ kvs and qᵀ(g/den)
(``la_bwd_rows_ws16_kernel``, ``la_bwd_reduce_ws16_kernel``, wgmma: kvs
split into bf16 hi + mid + lo, g/den into hi + lo, the P pass's operands
read node-major; both persistent, the rows pass streaming the next row
block's q rows into slots that this one frees, the P pass forming each
g/den once for a 256-row m tile, ds spread over its items) and
:func:`bwd_apply`'s three products (``la_bwd_apply_ws16_kernel``, wgmma:
kvs and P split into hi + lo; persistent over (256-row block, product)
items, each B chunk serving 256 rows, each item's A rows streamed into
slots that the item before frees; ``la_bwd_apply_wgmma_kernel``, one block
a 128-row block, for M or D above 256); the reduce, the apply and the
backward kernels are fed by the copy engine (TMA) from a producer warp or
warpgroup. On f32 inputs every kernel runs in 3xTF32 (each f32
operand split into tf32 hi + lo, each product lo*hi + hi*lo + hi*hi, f32
sums), all on warpgroup MMAs (wgmma tf32, A from registers): the reduce
(``la_reduce_wg_kernel``: kᵀ split as its fragments load, v split once a
chunk into K-major tf32 hi + lo tiles) and the backward reduce's P pass
(``la_bwd_reduce_wg_kernel``: the reduce's design with qᵀ for kᵀ and
g/den, formed as each chunk is split, for v), the apply
(``la_apply_wg_kernel``), the backward apply (``la_bwd_apply_ws_kernel``:
persistent over (row block, product) items, each item's A rows streamed
into slots that the item before frees atom by atom in its last column
tile) and the backward reduce's rows pass (``la_bwd_rows_ws_kernel``:
persistent over row blocks, the next row block's q rows streamed into
slots that this one frees atom by atom in its last column tile, b and
Σ g·v on the producer warpgroup's spare warps), all five fed by TMA from a
producer warpgroup. Both reduces' tiles
stream the node rows and take any width; the kernels that stage their rows'
full width in shared memory run on the CUDA cores where it does not fit
(the forward apply's q tile above M = 704 in bf16 and 256 in f32; the
backward reduce's q tile above 704 in bf16, 256 in f32; the backward apply
above M or D = 704 in bf16 and 256 in f32). :func:`reduce_design`,
:func:`apply_design`, :func:`bwd_reduce_design` and :func:`bwd_apply_design`
name the kernel a call runs.

``reduce_launches``, ``apply_launches``, ``bwd_reduce_launches`` and
``bwd_apply_launches`` count the launching calls (the forward ones in their
ops' CUDA implementations, so an exported program's calls count too); set
them to 0 to start a count.
"""

from __future__ import annotations

import torch

from sgformer_tpu_torch.kernels import _build

# the forward kernels' custom ops, registered by .ops
_OPS = torch.ops.sgformer_tpu_torch

reduce_launches = 0
apply_launches = 0
bwd_reduce_launches = 0
bwd_apply_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64
_ROWS = 32
_WAVES = 4  # CUDA-core reduce blocks per SM to aim for
# the tensor-core reduces: 128 x 128 output tiles over chunks of node rows,
# one wave of resident blocks, one on each SM in both types (the warpgroup
# designs' consumers and producer hold an SM's registers, and their rings
# most of its shared memory)
_TC_TILE = 128
_TC_BLOCKS_PER_SM = 1
_CUDA_CORES = "CUDA cores (f32 FMA)"


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
    """(inv * q @ kvs + n * v) / (inv * q . ksum + n) in f32 (f64 for f64
    inputs), in q's type. ``guard`` turns a zero denominator into 1 (masked
    inputs)."""
    qf = _acc(q)
    inv = scal[2]
    num = torch.einsum("nm,md->nd", qf, kvs) * inv + n_total * _acc(v)
    den = (torch.einsum("nm,m->n", qf, ksum) * inv + n_total)[:, None]
    if guard:
        den = torch.where(den == 0.0, torch.ones_like(den), den)
    return (num / den).to(q.dtype)


def _acc(t: torch.Tensor) -> torch.Tensor:
    """t in the backward's accumulation type: f32, or f64 for f64 inputs
    (an exact reference for the kernels' f32 sums)."""
    return t if t.dtype == torch.float64 else t.float()


def bwd_reduce_plain(q, v, g, kvs, ksum, scal, n_total, guard: bool):
    """The backward's cross-node sums, from the hand-derived formulas of the
    Pallas ``_bwd_reduce_kernel`` (not autograd), in f32 (f64 for f64
    inputs):

        gd = g / den,  gden = -sum_d(g * num) / den^2,
        P = q^T gd [M, D],  ds = sum_n q * gden [M],
        dinv = sum gd * a + sum gden * b,

    with a = q @ kvs, b = q . ksum, den = inv * b + n, num = inv * a + n * v.
    ``guard`` takes a zero den as 1 with gden = 0 (masked inputs). Returns
    P, ds, dinv (0-d) and rows = [den; gden] [2, N], which the apply reads.
    """
    qf, vf, gf = _acc(q), _acc(v), _acc(g)
    inv = scal[2]
    a = torch.einsum("nm,md->nd", qf, kvs)
    b = torch.einsum("nm,m->n", qf, ksum)
    den = inv * b + n_total
    num = inv * a + n_total * vf
    gden_of = -(gf * num).sum(dim=1)
    if guard:
        zero = den == 0.0
        den = torch.where(zero, torch.ones_like(den), den)
        gden = torch.where(zero, torch.zeros_like(den), gden_of / (den * den))
    else:
        gden = gden_of / (den * den)
    gd = gf / den[:, None]
    P = torch.einsum("nm,nd->md", qf, gd)
    ds = torch.einsum("nm,n->m", qf, gden)
    dinv = (gd * a).sum() + (gden * b).sum()
    return P, ds, dinv, torch.stack([den, gden])


def bwd_apply_plain(q, k, v, g, kvs, ksum, scal, n_total, P, ds, dinv, rows, guard: bool):
    """dq, dk, dv from the Pallas ``_bwd_apply_kernel``'s formulas (not
    autograd), computed in f32 (f64 for f64 inputs) and returned in the
    inputs' type:

        dq = inv * gd @ kvs^T + inv * gden * ksum - dinv * inv / ||q||^2 * q
        dk = inv * v @ P^T + inv * ds - dinv * inv / ||k||^2 * k
        dv = n * gd + inv * k @ P

    ``dinv`` is summed over all heads; ``rows`` = [den; gden] from
    :func:`bwd_reduce_plain`. ``guard``: a zero norm (inv = 0) drops the
    dinv terms instead of giving 0/0.
    """
    qf, kf, vf = _acc(q), _acc(k), _acc(v)
    q_sq, k_sq, inv = scal[0], scal[1], scal[2]
    den, gden = rows[0], rows[1]
    gd = _acc(g) / den[:, None]
    c_q, c_k = dinv * inv / q_sq, dinv * inv / k_sq
    if guard:
        zero = torch.zeros_like(inv)
        c_q = torch.where(inv == 0.0, zero, c_q)
        c_k = torch.where(inv == 0.0, zero, c_k)
    dq = inv * torch.einsum("nd,md->nm", gd, kvs) + inv * gden[:, None] * ksum - c_q * qf
    dk = inv * torch.einsum("nd,md->nm", vf, P) + inv * ds - c_k * kf
    dv = n_total * gd + inv * torch.einsum("nm,md->nd", kf, P)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_rows(name: str, t: torch.Tensor, n: int, dtype) -> None:
    if t.dim() != 2 or t.shape[0] != n:
        raise ValueError(f"{name} must be [{n}, *], got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if t.stride(1) != 1:
        raise ValueError(f"{name} must be contiguous along its last dimension")


def _check_f32(named: tuple) -> None:
    for name, t, shape in named:
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 tensor of shape {shape}")


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


def _slices(n: int, m: int, d: int, device: torch.device,
            tensor_cores: bool) -> tuple[int, int]:
    """(slices, rows per slice) of the N rows for a reduce grid on
    ``device``; slice length is a multiple of the 32-row step. The CUDA-core
    grid (64 x 64 tiles) fills the card about _WAVES times over; the
    tensor-core grid (128 x 128 tiles) is one wave of the resident blocks
    (_TC_BLOCKS_PER_SM an SM): at the arxiv shape (N = 169,343, M = D
    = 256, 132 SMs) 33 slices of 5,152 rows, whose f32 partials of kvs or P
    take 33 * 256 * 256 * 4 = 8.7 MB."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if tensor_cores:
        tiles = _cdiv(m, _TC_TILE) * _cdiv(d, _TC_TILE)
        blocks = _TC_BLOCKS_PER_SM * sms
    else:
        tiles = _cdiv(m, _TILE) * _cdiv(d, _TILE)
        blocks = _WAVES * sms
    want = max(1, min(_cdiv(n, _ROWS), _cdiv(blocks, tiles)))
    rows = _cdiv(_cdiv(n, want), _ROWS) * _ROWS
    return _cdiv(n, rows), rows


def reduce_design(dtype: torch.dtype, m: int, d: int) -> str:
    """Which kernel :func:`reduce` launches on the card for inputs of
    ``dtype`` with widths m (q, k) and d (v): both tensor-core kernels take
    any width (the node rows stream through a fixed 128 x 128 tile of kvs),
    so every call runs one."""
    del m, d
    if dtype == torch.float32:
        return ("tensor cores (wgmma 3xTF32: k and v as tf32 hi + lo, v split K-major, f32 "
                "sums; la_reduce_wg_kernel, fed by TMA from a producer warpgroup)")
    return ("tensor cores (wgmma bf16, k and v read node-major, f32 sums; "
            "la_reduce_wgmma_kernel, fed by TMA from a producer warpgroup)")


def _bwd_reduce_scratch(dtype: torch.dtype, m: int, d: int) -> int:
    """Elements of ``dtype`` of the tensor-core backward reduce's scratch
    (kvsᵀ in three bf16 pieces, or as the forward apply's split: tf32 hi
    and lo atoms held in f32), 0 for the CUDA-core design (builds the
    kernels on first use)."""
    return _build.library("linear_attention_bwd").sgf_la_bwd_reduce_scratch(
        _DTYPES[dtype], m, d)


def bwd_reduce_design(dtype: torch.dtype, m: int, d: int) -> str:
    """Which kernels :func:`bwd_reduce` launches on the card for inputs of
    ``dtype`` with widths m (q) and d (v, g)."""
    if not _bwd_reduce_scratch(dtype, m, d):
        return _CUDA_CORES
    if dtype == torch.float32:
        return ("tensor cores (wgmma 3xTF32, f32 sums: rows pass q and kvs as tf32 hi + lo, "
                "la_bwd_rows_ws_kernel, persistent; P pass q and g/den as tf32 hi + lo, g/den "
                "split K-major, la_bwd_reduce_wg_kernel; both fed by TMA from a producer "
                "warpgroup)")
    return ("tensor cores (wgmma bf16, f32 sums: rows pass kvs as bf16 hi + mid + lo, "
            "la_bwd_rows_ws16_kernel; P pass q and g/den node-major, g/den as hi + lo, "
            "la_bwd_reduce_ws16_kernel; both persistent, fed by TMA from a producer warpgroup)")


def _apply_scratch(dtype: torch.dtype, m: int, d: int) -> int:
    """Elements of ``dtype`` of the tensor-core forward apply's scratch
    (kvsᵀ as bf16 hi + lo, or two tf32 pieces held in f32), 0 for the
    CUDA-core design (builds the kernels on first use)."""
    return _build.library("linear_attention").sgf_la_apply_scratch(_DTYPES[dtype], m, d)


def apply_design(dtype: torch.dtype, m: int, d: int) -> str:
    """Which kernel :func:`apply` launches on the card for inputs of
    ``dtype`` with widths m (q) and d (v): the tensor-core kernel wherever
    its q tile fits one block's shared memory beside the kvs stages (M up
    to 704 in bf16, 256 in f32), else the CUDA-core one."""
    if not _apply_scratch(dtype, m, d):
        return _CUDA_CORES
    if dtype == torch.float32:
        return ("tensor cores (wgmma 3xTF32: q and kvs as tf32 hi + lo, f32 sums; "
                "la_apply_wg_kernel, fed by TMA from a producer warpgroup)")
    return ("tensor cores (wgmma bf16, kvs as bf16 hi + lo, f32 sums; la_apply_wgmma_kernel, "
            "persistent, fed by TMA from a producer warpgroup)")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def reduce(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, guard: bool = False):
    """Per-head cross-node sums. q, k: [N, M]; v: [N, D]; float32 or
    bfloat16, each contiguous along its last dimension (rows may be strided).
    Returns kvs [M, D], ksum [M] and scal [4], all f32. Runs the op
    ``sgformer_tpu_torch::linear_attention_reduce`` (:mod:`.ops`)."""
    n = q.shape[0]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    _check_rows("q", q, n, q.dtype)
    _check_rows("k", k, n, q.dtype)
    _check_rows("v", v, n, q.dtype)
    if k.shape[1] != q.shape[1]:
        raise ValueError("q and k must have the same width")
    _device_of(q, k, v)
    return _OPS.linear_attention_reduce(q, k, v, guard)


def reduce_cuda(q, k, v, guard):
    """The CUDA implementation of the op :func:`reduce` runs: the kernels'
    launch, counted."""
    global reduce_launches
    n = q.shape[0]
    if n == 0:
        raise ValueError("linear attention needs at least one node")

    m, d = q.shape[1], v.shape[1]
    slices, rows = _slices(n, m, d, q.device, True)  # every width on the tensor cores
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
        _stream(q),
    )
    _build.check(err, "linear attention reduce")
    reduce_launches += 1
    return kvs, ksum, scal


def apply(q, v, kvs, ksum, scal, n_total, guard: bool = False, out=None):
    """Per-head output rows. q: [N, M]; v: [N, D]; kvs [M, D], ksum [M],
    scal [4] from :func:`reduce`; n_total a 0-d f32 tensor. Runs the op
    ``sgformer_tpu_torch::linear_attention_apply``, which returns a fresh
    [N, D] tensor of q's type; with ``out`` ([N, D], q's type, rows may be
    strided) that is copied into ``out``, which is returned."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    n, m = q.shape
    d = v.shape[1]
    _check_rows("q", q, n, q.dtype)
    _check_rows("v", v, n, q.dtype)
    if out is not None:
        _check_rows("out", out, n, q.dtype)
    _check_f32((("kvs", kvs, (m, d)), ("ksum", ksum, (m,)),
                ("scal", scal, (4,)), ("n_total", n_total, ())))
    _device_of(q, v, kvs, ksum, scal, n_total, *(() if out is None else (out,)))
    res = _OPS.linear_attention_apply(q, v, kvs, ksum, scal, n_total, guard)
    return res if out is None else out.copy_(res)


def apply_cuda(q, v, kvs, ksum, scal, n_total, guard):
    """The CUDA implementation of the op :func:`apply` runs."""
    global apply_launches
    n, m = q.shape
    d = v.shape[1]
    out = torch.empty(n, d, dtype=q.dtype, device=q.device)
    scratch = _apply_scratch(q.dtype, m, d)
    hl = torch.empty(scratch, dtype=q.dtype, device=q.device) if scratch else None
    err = _build.library("linear_attention").sgf_la_apply(
        q.data_ptr(), v.data_ptr(), q.stride(0), v.stride(0),
        out.data_ptr(), out.stride(0), n, m, d, _DTYPES[q.dtype],
        kvs.data_ptr(), ksum.data_ptr(), scal.data_ptr(), n_total.data_ptr(),
        int(guard), None if hl is None else hl.data_ptr(), _stream(q),
    )
    _build.check(err, "linear attention apply")
    apply_launches += 1
    return out


def bwd_reduce(q, v, g, kvs, ksum, scal, n_total, guard: bool = False):
    """Backward pass 1 of one head. q: [N, M]; v, g: [N, D] (g = dL/dout),
    one type, float32 or bfloat16, rows may be strided; kvs, ksum from the
    forward's :func:`reduce`, scal [4] and n_total as the forward's apply
    got them. Returns P [M, D], ds [M], dinv (0-d) and rows [2, N] =
    (den, gden), all f32 (see :func:`bwd_reduce_plain`)."""
    global bwd_reduce_launches
    n = q.shape[0]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    _check_rows("q", q, n, q.dtype)
    _check_rows("v", v, n, q.dtype)
    _check_rows("g", g, n, q.dtype)
    m, d = q.shape[1], v.shape[1]
    if g.shape[1] != d:
        raise ValueError("g and v must have the same width")
    _check_f32((("kvs", kvs, (m, d)), ("ksum", ksum, (m,)),
                ("scal", scal, (4,)), ("n_total", n_total, ())))
    if _device_of(q, v, g, kvs, ksum, scal, n_total).type == "cpu":
        return bwd_reduce_plain(q, v, g, kvs, ksum, scal, n_total, guard)
    if n == 0:
        raise ValueError("linear attention needs at least one node")

    scratch = _bwd_reduce_scratch(q.dtype, m, d)
    slices, rows_per_slice = _slices(n, m, d, q.device, scratch > 0)
    f32 = dict(dtype=torch.float32, device=q.device)
    rows = torch.empty(2, n, **f32)
    dinv_part = torch.empty(_cdiv(n, _TILE), dtype=torch.float64, device=q.device)
    P_part = torch.empty(slices, m, d, **f32)
    ds_part = torch.empty(slices, m, **f32)
    P = torch.empty(m, d, **f32)
    ds = torch.empty(m, **f32)
    dinv = torch.empty((), **f32)
    hl = torch.empty(scratch, dtype=q.dtype, device=q.device) if scratch else None
    err = _build.library("linear_attention_bwd").sgf_la_bwd_reduce(
        q.data_ptr(), v.data_ptr(), g.data_ptr(), q.stride(0), v.stride(0), g.stride(0),
        n, m, d, _DTYPES[q.dtype], slices, rows_per_slice, int(guard),
        kvs.data_ptr(), ksum.data_ptr(), scal.data_ptr(), n_total.data_ptr(),
        rows.data_ptr(), dinv_part.data_ptr(), P_part.data_ptr(), ds_part.data_ptr(),
        P.data_ptr(), ds.data_ptr(), dinv.data_ptr(), None if hl is None else hl.data_ptr(),
        _stream(q),
    )
    _build.check(err, "linear attention bwd_reduce")
    bwd_reduce_launches += 1
    return P, ds, dinv, rows


def _bwd_apply_scratch(dtype: torch.dtype, m: int, d: int) -> int:
    """Elements of ``dtype`` of the tensor-core backward apply's scratch
    (kvs, P and Pᵀ as bf16, or tf32 in f32, hi + lo), 0 for the CUDA-core
    design (builds the kernels on first use)."""
    return _build.library("linear_attention_bwd").sgf_la_bwd_apply_scratch(
        _DTYPES[dtype], m, d)


def bwd_apply_design(dtype: torch.dtype, m: int, d: int) -> str:
    """Which kernel :func:`bwd_apply` launches on the card for inputs of
    ``dtype`` with widths m (q, k) and d (v, g): in bf16 the persistent
    ``la_bwd_apply_ws16_kernel`` up to M, D = 256 (its A slots), above that
    up to 704 ``la_bwd_apply_wgmma_kernel``."""
    if not _bwd_apply_scratch(dtype, m, d):
        return _CUDA_CORES
    if dtype == torch.float32:
        return ("tensor cores (wgmma 3xTF32: g, v, k, kvs and P as tf32 hi + lo, f32 sums; "
                "la_bwd_apply_ws_kernel, persistent, fed by TMA from a producer warpgroup)")
    if _build.library("linear_attention_bwd").sgf_la_bwd_apply_persistent(_DTYPES[dtype], m, d):
        return ("tensor cores (wgmma bf16, kvs and P as bf16 hi + lo, f32 sums; "
                "la_bwd_apply_ws16_kernel, 256 rows an item, persistent, fed by TMA from a "
                "producer warpgroup)")
    return ("tensor cores (wgmma bf16, kvs and P as bf16 hi + lo, f32 sums; "
            "la_bwd_apply_wgmma_kernel, for M or D above 256, fed by TMA from a producer warp)")


def bwd_apply(q, k, v, g, kvs, ksum, scal, n_total, P, ds, dinv, rows,
              guard: bool = False, out=None):
    """Backward pass 2 of one head: dq, dk [N, M] and dv [N, D] in the
    inputs' type. P, ds and rows from :func:`bwd_reduce`; ``dinv`` summed
    over all heads. Writes into ``out`` = (dq, dk, dv) (rows may be strided)
    when given."""
    global bwd_apply_launches
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    n, m = q.shape
    d = v.shape[1]
    for name, t, w in (("q", q, m), ("k", k, m), ("v", v, d), ("g", g, d)):
        _check_rows(name, t, n, q.dtype)
        if t.shape[1] != w:
            raise ValueError(f"{name} must be [{n}, {w}], got {tuple(t.shape)}")
    if out is None:
        out = (torch.empty(n, m, dtype=q.dtype, device=q.device),
               torch.empty(n, m, dtype=q.dtype, device=q.device),
               torch.empty(n, d, dtype=q.dtype, device=q.device))
    dq, dk, dv = out
    for name, t, w in (("dq", dq, m), ("dk", dk, m), ("dv", dv, d)):
        _check_rows(name, t, n, q.dtype)
        if t.shape[1] != w:
            raise ValueError(f"{name} must be [{n}, {w}], got {tuple(t.shape)}")
    _check_f32((("kvs", kvs, (m, d)), ("ksum", ksum, (m,)), ("scal", scal, (4,)),
                ("n_total", n_total, ()), ("P", P, (m, d)), ("ds", ds, (m,)),
                ("dinv", dinv, ()), ("rows", rows, (2, n))))
    dev = _device_of(q, k, v, g, kvs, ksum, scal, n_total, P, ds, dinv, rows, dq, dk, dv)
    if dev.type == "cpu":
        for t, want in zip(out, bwd_apply_plain(q, k, v, g, kvs, ksum, scal, n_total,
                                                P, ds, dinv, rows, guard)):
            t.copy_(want)
        return out
    scratch = _bwd_apply_scratch(q.dtype, m, d)
    hl = torch.empty(scratch, dtype=q.dtype, device=dev) if scratch else None
    # the tensor-core kernel reads the A rows (g, v, k), and in its epilogue
    # q, k, g, dq, dk, dv, 16 bytes at a time where widths, strides and
    # bases allow
    per16 = 16 // q.element_size()
    vec_a = int(m % per16 == 0 and d % per16 == 0 and all(
        t.stride(0) % per16 == 0 and t.data_ptr() % 16 == 0 for t in (k, v, g)))
    vec_io = int(all(t.stride(0) % per16 == 0 and t.data_ptr() % 16 == 0
                     for t in (q, k, g, dq, dk, dv)))
    err = _build.library("linear_attention_bwd").sgf_la_bwd_apply(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        q.stride(0), k.stride(0), v.stride(0), g.stride(0),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dq.stride(0), dk.stride(0), dv.stride(0),
        n, m, d, _DTYPES[q.dtype], kvs.data_ptr(), ksum.data_ptr(), P.data_ptr(),
        ds.data_ptr(), scal.data_ptr(), n_total.data_ptr(), dinv.data_ptr(),
        rows.data_ptr(), int(guard), vec_a, vec_io, None if hl is None else hl.data_ptr(),
        _stream(q),
    )
    _build.check(err, "linear attention bwd_apply")
    bwd_apply_launches += 1
    return out


def _all_reduce_sums(sums, n_total, guard, axis_name):
    """The per-head reduce results of every rank of the axis summed in one
    all-reduce (kvs, ksum and the norms ||q||², ||k||² of each head, and the
    row count n), between the reduce and apply kernels; each head's
    inv = 1/(||q|| ||k||) then comes from the summed norms. Returns the
    summed (kvs, ksum, scal) of each head and n."""
    from sgformer_tpu_torch.parallel.comm import all_reduce_

    flat = torch.cat([t.reshape(-1) for kvs, ksum, scal in sums
                      for t in (kvs, ksum, scal[:2])] + [n_total.reshape(1)])
    all_reduce_(flat, axis_name)
    out, at = [], 0
    for kvs, ksum, _ in sums:
        kvs_t = flat[at:at + kvs.numel()].view(kvs.shape)
        at += kvs.numel()
        ksum_t = flat[at:at + ksum.numel()]
        at += ksum.numel()
        q_sq, k_sq = flat[at], flat[at + 1]
        at += 2
        scal = torch.stack([q_sq, k_sq, _inv(q_sq, k_sq, guard), torch.zeros_like(q_sq)])
        out.append((kvs_t, ksum_t, scal))
    return out, flat[at]


def _attention_forward(qs, ks, vs, n_total, guard, axis_name=None):
    """Reduce every head, one norm over all heads, apply every head (each
    head's rows a fresh tensor, stacked when there are several). With
    ``axis_name`` the sums and n_total (this rank's count) are all-reduced
    over that mesh axis between the two kernels.
    Returns out [N, H, D] and what the backward needs: per-head (kvs, ksum),
    the shared scal and n_total."""
    h = qs.shape[1]
    sums = [reduce(qs[:, i], ks[:, i], vs[:, i], guard) for i in range(h)]
    if axis_name is not None:
        sums, n_total = _all_reduce_sums(sums, n_total, guard, axis_name)
    scal = sums[0][2]
    if h > 1:
        # one norm over all heads, as in the reference and the plain path;
        # the JAX Pallas path normalises each head by its own norms
        q_sq = sum(s[2][0] for s in sums)
        k_sq = sum(s[2][1] for s in sums)
        scal = torch.stack([q_sq, k_sq, _inv(q_sq, k_sq, guard), torch.zeros_like(q_sq)])
    heads = [apply(qs[:, i], vs[:, i], kvs, ksum, scal, n_total, guard)
             for i, (kvs, ksum, _) in enumerate(sums)]
    out = heads[0][:, None] if h == 1 else torch.stack(heads, dim=1)
    return out, [s[:2] for s in sums], scal, n_total


class LinearAttentionFunction(torch.autograd.Function):
    """The attention core with the backward kernels as its gradient.

    Saves (q, k, v, kvs, ksum, scal, n_total) in the forward. The backward
    runs :func:`bwd_reduce` for every head, sums dinv over the heads (one
    norm is shared by all of them), then runs :func:`bwd_apply` for every
    head. ``n_total`` and ``guard`` get no gradient, as in the JAX
    ``_attn_core_bwd``. With ``axis_name`` the forward's sums and the
    backward's (P, ds, dinv) of every head are each all-reduced in one
    collective between the two kernels of their pass, as the JAX kernel
    path's psums (``kernels/attention.py:153-156``, ``:295-296``)."""

    @staticmethod
    def forward(ctx, qs, ks, vs, n_total, guard: bool, axis_name):
        out, sums, scal, n_total = _attention_forward(qs, ks, vs, n_total, guard, axis_name)
        ctx.guard = guard
        ctx.axis_name = axis_name
        ctx.save_for_backward(qs, ks, vs, n_total, scal,
                              *(t for pair in sums for t in pair))
        return out

    @staticmethod
    def backward(ctx, g):
        qs, ks, vs, n_total, scal, *flat = ctx.saved_tensors
        guard = ctx.guard
        g = g.to(qs.dtype)
        if g.stride(2) != 1:
            g = g.contiguous()
        h = qs.shape[1]
        sums = [(flat[2 * i], flat[2 * i + 1]) for i in range(h)]
        parts = [bwd_reduce(qs[:, i], vs[:, i], g[:, i], kvs, ksum, scal, n_total, guard)
                 for i, (kvs, ksum) in enumerate(sums)]
        if ctx.axis_name is not None:
            parts = _all_reduce_partials(parts, ctx.axis_name)
        dinv = parts[0][2]
        for p in parts[1:]:
            dinv = dinv + p[2]
        dq, dk = torch.empty(2, *qs.shape, dtype=qs.dtype, device=qs.device)
        dv = torch.empty(vs.shape, dtype=vs.dtype, device=vs.device)
        for i, ((kvs, ksum), (P, ds, _, rows)) in enumerate(zip(sums, parts)):
            bwd_apply(qs[:, i], ks[:, i], vs[:, i], g[:, i], kvs, ksum, scal, n_total,
                      P, ds, dinv, rows, guard, out=(dq[:, i], dk[:, i], dv[:, i]))
        return dq, dk, dv, None, None, None


def _all_reduce_partials(parts, axis_name):
    """Every head's backward partials (P, ds, dinv) summed over the axis in
    one all-reduce; each head's rows stay this rank's."""
    from sgformer_tpu_torch.parallel.comm import all_reduce_

    flat = torch.cat([t.reshape(-1) for P, ds, dinv, _ in parts for t in (P, ds, dinv)])
    all_reduce_(flat, axis_name)
    out, at = [], 0
    for P, ds, _, rows in parts:
        P_t = flat[at:at + P.numel()].view(P.shape)
        at += P.numel()
        ds_t = flat[at:at + ds.numel()]
        at += ds.numel()
        out.append((P_t, ds_t, flat[at], rows))
        at += 1
    return out


def fused_linear_attention(
    qs: torch.Tensor,
    ks: torch.Tensor,
    vs: torch.Tensor,
    node_mask: torch.Tensor | None = None,
    axis_name: str | None = None,
) -> torch.Tensor:
    """SGFormer linear attention through the reduce and apply kernels, and
    the backward kernels for its gradient.

    qs, ks: [N, H, M]; vs: [N, H, D]. The same function as
    :func:`sgformer_tpu_torch.ops.attention.linear_attention` without
    ``output_attn``. With ``axis_name`` the rows are this rank's shard of a
    node-sharded graph: the reduce kernels run on them and their sums (and
    n) are all-reduced over the axis before the apply kernels, one
    collective a pass. Returns [N, H, D] in q's type.
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
    if torch.is_grad_enabled() and (qs.requires_grad or ks.requires_grad
                                    or vs.requires_grad):
        return LinearAttentionFunction.apply(qs, ks, vs, n_total, guard, axis_name)
    return _attention_forward(qs, ks, vs, n_total, guard, axis_name)[0]
