"""Measurement on the card, shared by ``chip_smoke.py``, the timing probes
and the card-only tests: device time from CUDA events, the least time the
work allows, the card's name, and a kernel's error against its plain
version."""

from __future__ import annotations

import statistics
import subprocess

import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; dense
# operations a second of the type the inputs have (bf16 and int8 on tensor
# cores, f32 on CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}


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
