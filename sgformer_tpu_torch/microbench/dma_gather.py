"""Per-row gather rate: the port of ``scripts/microbench_dma_gather.py``.

The TPU probe gathers E random rows of x [N, 256] bf16 with one DMA per row,
S copies in flight, C rows per grid step, and sums each step's rows in eight
groups of C/8 (``dma_kernel``, the inline Pallas kernel at its line 70). Its
output block is overwritten every step, so only the last chunk's sums
survive; :func:`gather_rows` writes every chunk's:

    out[c, r, :] = sum_{j < C/8} f32(x[idx[c*C + r*C/8 + j], :])     [E/C, 8, F]

Its kernel (``csrc/microbench.cu``, ``gather_rows_kernel``) is persistent:
one block for each slot the card holds at its ring (:func:`plan`), each
walking chunks ``blockIdx.x, += gridDim.x``; warp r sums group r of each, its
rows one stream kept S deep in a ring of 16-byte ``cp.async`` copies across
the chunks' ends, the ids read 32 at a time a batch ahead. ``stages`` (S)
is the rows in flight for one output group. The question is the card's
random-row rate: rows a second, ns a row, GB/s. The library yardstick is the
script's other line, ``jnp.take`` and a sum: ``torch.index_select`` and the
same group sums. On the card:

    python -m sgformer_tpu_torch.microbench.dma_gather
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from sgformer_tpu_torch import kernels, microbench
from sgformer_tpu_torch.kernels import _build
from sgformer_tpu_torch.utils import measure

# the script's sizes (microbench_dma_gather.py:30-34)
N, E, F, C, S = 169_343, 1_048_576, 256, 512, 16
STAGES = (4, 8, 16, 32)
# kernel against plain, as a share of the largest sum: each sum has C/8 = 64
# f32 terms, added in another order
REL_TOL = 1e-5
# the kernel's block: 8 warps, one an output group
THREADS = 256


def plan(n_chunks: int, f: int = F, stages: int = S, sms: int = 132,
         resident: int | None = None) -> dict:
    """The kernel's launch over ``n_chunks`` chunks: its ring (8 warps x
    ``stages`` rows of ``f`` bf16 in shared memory), the blocks an SM holds
    at that ring (by shared memory and threads; on the card ``resident``,
    its occupancy query, which also counts registers) and the persistent
    grid, one block a resident slot of the ``sms`` SMs and no more than
    chunks."""
    ring = 8 * stages * f * 2
    per_sm = microbench.resident_blocks(ring, THREADS) if resident is None else resident
    return dict(ring_bytes=ring, threads=THREADS, blocks_per_sm=per_sm,
                grid=microbench.persistent_grid(n_chunks, sms, per_sm))


@functools.lru_cache(maxsize=None)
def card_plan(n_chunks: int, f: int, stages: int, device: int) -> dict:
    """:func:`plan` on the card: its SMs and the kernel's occupancy there."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm = microbench.card_blocks_per_sm("sgf_gather_rows_resident", f, stages)
    return plan(n_chunks, f, stages, sms, per_sm)


def design(stages: int = S, f: int = F, n_chunks: int = E // C) -> str:
    """The kernel's launch on the card at these sizes, in words."""
    p = card_plan(n_chunks, f, stages, torch.cuda.current_device())
    return (f"persistent: {p['grid']} blocks ({p['blocks_per_sm']} an SM) over {n_chunks} "
            f"chunks; 8 warps, each a {stages}-deep ring of 16-byte cp.async rows kept full "
            f"across its chunks, ids a batch of 32 ahead")


def make_inputs(device, n: int = N, e: int = E, f: int = F, seed: int = 0):
    """(x [n, f] bf16, idx [e] int32) from ``default_rng(seed)``, drawn as
    the script draws them: the indices first, then x."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, e).astype(np.int32)
    x = rng.standard_normal((n, f))
    return (torch.from_numpy(x).to(device=device, dtype=torch.bfloat16),
            torch.from_numpy(idx).to(device))


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor, chunk: int = C) -> torch.Tensor:
    """The group sums in plain PyTorch: [E/chunk, 8, F] f32."""
    e, f = idx.shape[0], x.shape[1]
    rows = x.float().index_select(0, idx.long())
    return rows.view(e // chunk, 8, chunk // 8, f).sum(2)


def gather_rows(x: torch.Tensor, idx: torch.Tensor, chunk: int = C,
                stages: int = S) -> torch.Tensor:
    """out[c, r] = sum_{j < chunk/8} f32(x[idx[c*chunk + r*chunk/8 + j]]).

    x: [N, F] bfloat16 (F % 8 == 0 and F <= 256 on the card); idx: [E] int32
    with E % chunk == 0 and chunk % 8 == 0; ``stages`` copies in flight per
    warp, one of 4, 8, 16, 32. Returns [E/chunk, 8, F] float32."""
    if x.dim() != 2 or x.dtype != torch.bfloat16:
        raise TypeError(f"x must be [N, F] bfloat16, got {tuple(x.shape)} {x.dtype}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise TypeError("idx must be a 1-d int32 tensor")
    e, f = idx.shape[0], x.shape[1]
    if chunk % 8 or e % chunk:
        raise ValueError(f"chunk ({chunk}) must be a multiple of 8 dividing E ({e})")
    if x.device != idx.device:
        raise ValueError("x and idx must be on one device")
    if x.device.type == "cpu":
        return gather_rows_plain(x, idx, chunk)
    if f % 8 or f > 256 or stages not in STAGES:
        raise ValueError(f"the kernel takes F % 8 == 0, F <= 256 and stages in {STAGES}, "
                         f"got F = {f}, stages = {stages}")
    x, idx = x.contiguous(), idx.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    out = torch.empty(e // chunk, 8, f, dtype=torch.float32, device=x.device)
    if e:
        p = card_plan(e // chunk, f, stages, x.device.index)
        err = _build.library("microbench").sgf_gather_rows(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), e // chunk, chunk, f, stages,
            p["grid"], torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "gather_rows")
        kernels.probe_launches["gather_rows"] += 1
    return out


def run(x: torch.Tensor, idx: torch.Tensor, chunk: int = C, stages: int = S,
        iters: int = 20) -> dict:
    """Time the kernel, its plain version and the library yardstick on the
    card; the kernel's rates and its bound (each distinct row of x read
    once, idx read once, the sums written once)."""
    e, f = idx.shape[0], x.shape[1]
    ms = measure.time_ms(lambda: gather_rows(x, idx, chunk, stages), iters)
    plain_ms = measure.time_ms(lambda: gather_rows_plain(x, idx, chunk), iters)
    il = idx.long()
    library_ms = measure.time_ms(lambda: torch.index_select(x, 0, il).view(
        e // chunk, 8, chunk // 8, f).sum(2, dtype=torch.float32), iters)
    distinct = torch.unique(idx).numel()
    nbytes = distinct * f * 2 + e * 4 + (e // chunk) * 8 * f * 4
    b_ms, b_by = measure.bound_ms(nbytes, e * f)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                mrows_per_s=e / ms / 1e3, ns_per_row=ms / e * 1e6,
                gb_per_s=e * f * 2 / ms / 1e6, distinct_rows=distinct)


def main() -> int:
    if not torch.cuda.is_available():
        print("dma_gather: CUDA is not available; this probe needs a GPU", file=sys.stderr)
        return 1
    print(measure.card_line(), flush=True)
    x, idx = make_inputs("cuda")
    got = gather_rows(x, idx)
    err, scale = measure.rel_err(got, gather_rows_plain(x, idx))
    print(f"gather_rows vs plain: max |diff| {err:.3e} (largest sum {scale:.3e})")
    if err > REL_TOL * scale:
        print("gather_rows disagrees with its plain version", file=sys.stderr)
        return 1
    for stages in STAGES:
        r = run(x, idx, stages=stages)
        print(f"cp.async row gather (C={C}, S={stages}): {r['ms']:7.4f} ms for {E} rows -> "
              f"{r['mrows_per_s']:.1f} Mrows/s ({r['ns_per_row']:.3f} ns/row, "
              f"{r['gb_per_s']:.0f} GB/s); bound {r['bound_ms']:.4f} ms by {r['bound_by']}",
              flush=True)
    print(f"index_select + sums       : {r['library_ms']:7.4f} ms for {E} rows -> "
          f"{E / r['library_ms'] / 1e3:.1f} Mrows/s; plain {r['plain_ms']:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
