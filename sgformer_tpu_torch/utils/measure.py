"""Measurement on the card, shared by ``chip_smoke.py``, the timing probes
and the card-only tests: device time from CUDA events, the least time the
work allows, the card's name, and a kernel's error against its plain
version."""

from __future__ import annotations

import statistics
import subprocess

import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; dense
# operations a second of the type the inputs have. bf16 and int8 on the
# tensor cores; f32 at the 3xTF32 rate, three TF32 tensor-core products of
# 495 TFLOP/s for each f32-accurate one, above the 67 TFLOP/s of f32 FMAs
# on the CUDA cores, so that no f32 kernel can beat its bound
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3, torch.int8: 1979e12}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    """Median device time of one call of ``fn``, from CUDA events around
    each call, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def bound_ms(nbytes: float, ops: float, dtype=torch.bfloat16) -> tuple[float, str]:
    """Least time in ms for the work: the larger of the bytes over the memory
    rate and the operations over the peak for ``dtype``; and which it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, max |want|), in f32; raises if got is not finite.
    A kernel agrees with its plain version to ``rel`` when the first is at
    most ``rel`` times the second."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    scale = want.abs().max().item() if want.numel() else 0.0
    return err, scale


# cancel: the size of the kvs terms that cancel in q @ kvs, against
# kvs ~ N(0, 1) terms that do not
APPLY_CANCEL_SCALE = 2.0 ** 5
# bwd_product_inputs' cancel: the same for the bf16 rows pass, whose three
# pieces of kvs must hold gden at the f32 tolerance
ROWS_CANCEL_SCALE = 2.0 ** 6


def apply_product_inputs(n: int, m: int, d: int, dtype, gen: torch.Generator,
                         cancel: bool = False):
    """Inputs of the linear-attention apply, (q, v, kvs, ksum, scal,
    n_total) on ``gen``'s device, on which q @ kvs carries the output, so
    that a kernel's index mapping and its precision on kvs both show.

    q is positive (0.5 to 1.5), kvs ~ N(0, 1) in f32 (so every (m, d)
    pairing moves the output, as it does not for a kvs = kᵀv of positive k
    and v, whose entries are nearly equal), ksum positive and
    ~1/sqrt(m), inv = n = 1: den ~ sqrt(m) and each output is ~N(0, 1).

    ``cancel``: columns m and m ^ 8 of q are equal (a pair within one
    16-deep k step), and kvs also carries +-APPLY_CANCEL_SCALE * c_d on the
    two rows of each pair, which cancel exactly in q @ kvs. kvs rounded to
    bf16 then moves outputs by up to their own size (~50 times the bf16
    tolerance at m = d = 256), while with bf16 hi + lo pieces they stay
    within the output's own bf16 rounding, so the tolerance tells the two
    apart."""
    dev = gen.device

    def draw(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    q = (0.5 + draw(n, m)).to(dtype)
    kvs = torch.randn(m, d, generator=gen, device=dev)
    if cancel:
        cols = torch.arange(m, device=dev)
        pair = cols ^ 8
        paired = pair < m
        src = torch.where(paired & (cols & 8 != 0), pair, cols)
        q = q[:, src].contiguous()
        sign = torch.where(cols & 8 == 0, 1.0, -1.0) * paired
        c = torch.randn(d, generator=gen, device=dev)
        kvs = kvs + APPLY_CANCEL_SCALE * sign[:, None] * c[None, :]
    v = torch.randn(n, d, generator=gen, device=dev).to(dtype)
    ksum = (0.5 + draw(m)) / m ** 0.5
    scal = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev)
    return q, v, kvs, ksum, scal, torch.ones((), device=dev)


def _above_tf32(shape, dtype, gen: torch.Generator) -> torch.Tensor:
    """Positive values a fraction w of a tf32 step above a tf32 value,
    2^e (1 + (j + w) / 1024) with e in {-1, 0}, j < 1024 and w uniform in
    [0.05, 0.45], on ``gen``'s device: rounding to tf32 (nearest) takes each
    one down, by ~1.6e-4 of it on average."""
    dev = gen.device
    j = torch.randint(0, 1024, shape, generator=gen, device=dev)
    w = 0.05 + 0.4 * torch.rand(*shape, generator=gen, device=dev)
    e = torch.randint(-1, 1, shape, generator=gen, device=dev)
    return (torch.ldexp(1.0 + (j + w) / 1024, e.float())).to(dtype)


def reduce_product_inputs(n: int, m: int, d: int, dtype, gen: torch.Generator):
    """Inputs of the linear-attention reduce, (q, k, v) on ``gen``'s device,
    on which a 3xTF32 kᵀv that drops a lo piece misses the f32 tolerance.

    Every value is positive, so no sum cancels, and lies a fraction w of a
    tf32 step above a tf32 value, 2^e (1 + (j + w) / 1024) with e in
    {-1, 0}, j < 1024 and w uniform in [0.05, 0.45]: rounding to tf32
    (nearest) takes each one down, by ~1.6e-4 of it on average, so a dropped
    lo piece of k or of v biases every entry of kᵀv by ~16 times the f32
    tolerance (1e-5 of its scale), where the errors of the split with its lo
    pieces (~2^-21 of each term) average out far under it."""
    return (_above_tf32((n, m), dtype, gen), _above_tf32((n, m), dtype, gen),
            _above_tf32((n, d), dtype, gen))


def bwd_reduce_product_inputs(n: int, m: int, d: int, dtype, gen: torch.Generator):
    """Inputs of the linear-attention backward reduce, (q, v, g, kvs, ksum,
    scal, n_total) in its argument order, on ``gen``'s device, on which a
    3xTF32 P = qᵀ(g/den) that drops a lo piece of q or of g/den misses the
    f32 tolerance.

    q and g are positive values a fraction of a tf32 step above tf32 values
    (as ``reduce_product_inputs`` makes them), and ksum = 0 with inv = n = 1,
    so that every den is exactly 1 and g/den is g: no sum of P cancels, and
    a dropped lo piece biases every entry of P by ~16 times the f32
    tolerance (1e-5 of its scale). v is positive (0.5 to 1.5) and kvs ~
    N(0, 1) / m, so that gden (~ -d) and ds are the size of their own
    terms."""
    dev = gen.device
    q, g = _above_tf32((n, m), dtype, gen), _above_tf32((n, d), dtype, gen)
    v = (0.5 + torch.rand(n, d, generator=gen, device=dev)).to(dtype)
    kvs = torch.randn(m, d, generator=gen, device=dev) / m
    scal = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev)
    return q, v, g, kvs, torch.zeros(m, device=dev), scal, torch.ones((), device=dev)


def bwd_product_inputs(n: int, m: int, d: int, dtype, gen: torch.Generator,
                       cancel: bool = False):
    """Inputs of the linear-attention backward apply, (q, k, v, g, kvs, ksum,
    scal, n_total, P, ds, dinv, rows) in its argument order, on ``gen``'s
    device, on which its three products carry dq, dk and dv, so that a
    kernel's index mapping and its precision on kvs and P both show; q, v,
    g, kvs, ksum, scal and n_total are also inputs of the backward reduce on
    which q @ kvs carries den's partner terms.

    The products' A rows (g, v, k) and q are positive (0.5 to 1.5); kvs and
    P ~ N(0, 1) in f32, so that every (row, column) pairing moves an output
    (one TF32 product in place of three, ~2^-11 of each term, misses the f32
    tolerance by far); n = inv = 1 and den = 1 to 2 a row, so that n * gd in
    dv is the size of one term of k @ P and not of their sum; gden, ds and
    dinv ~1e-2 and ksum positive, ~1 / m, so that the epilogue's other terms
    show without swamping the products.

    ``cancel`` (the backward reduce's rows pass): columns m and m ^ 8 of q
    are equal (a pair within one 16-deep k step), and kvs also carries
    +-ROWS_CANCEL_SCALE * c_d on the two rows of each pair, which cancel
    exactly in q @ kvs (c drawn after every other input, which stay as
    without it). kvs as bf16 hi + mid (its lo piece dropped) then moves gden
    by ~6 times the f32 tolerance (1e-5 of its scale) at m = d = 256, while
    hi + mid + lo keep it within ~3e-7."""
    dev = gen.device

    def draw(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    q, k = ((0.5 + draw(n, m)).to(dtype) for _ in range(2))
    v, g = ((0.5 + draw(n, d)).to(dtype) for _ in range(2))
    kvs, P = randn(m, d), randn(m, d)
    ksum = (0.5 + draw(m)) / m
    scal = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev)
    rows = torch.stack([1.0 + draw(n), 1e-2 * randn(n)])
    ds, dinv = 1e-2 * randn(m), 1e-2 * randn(())
    if cancel:
        cols = torch.arange(m, device=dev)
        pair = cols ^ 8
        paired = pair < m
        q = q[:, torch.where(paired & (cols & 8 != 0), pair, cols)].contiguous()
        sign = torch.where(cols & 8 == 0, 1.0, -1.0) * paired
        kvs = kvs + ROWS_CANCEL_SCALE * sign[:, None] * randn(d)[None, :]
    return (q, k, v, g, kvs, ksum, scal, torch.ones((), device=dev), P, ds, dinv, rows)
