"""Tile gather rate: the port of ``scripts/microbench_dma_tile.py``.

The TPU probe gathers E random tiles of 8 contiguous rows (4 KB at F = 256
bf16) with one DMA each, C tiles per grid step into a [8C, F] scratch, S
copies in flight, and sums the scratch in eight groups of C rows
(``dma_kernel``, the inline Pallas kernel at its line 65); again only the
last step's sums survive there. :func:`gather_tiles` writes every step's:

    out[c, r, :] = sum_{k < C} f32(scratch[r*C + k, :]),
    scratch[8j + i, :] = x[8*idx[c*C + j] + i, :]                    [E/C, 8, F]

A step's scratch (1 MB) does not fit shared memory, so the kernel
(``csrc/microbench.cu``, ``gather_tiles_kernel``) streams: one CTA per step,
each tile one TMA bulk copy (``cp.async.bulk`` with an ``mbarrier``) into an
S-stage ring, summed into its group as it lands. S is the ring depth, 8 and
32 as in the script. The library yardstick is ``index_select`` of the tiles
and the same sums. On the card:

    python -m sgformer_tpu_torch.microbench.dma_tile
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from sgformer_tpu_torch import kernels
from sgformer_tpu_torch.kernels import _build
from sgformer_tpu_torch.utils import measure

# the script's sizes (microbench_dma_tile.py:29-33 and its S loop)
N, F, E, C = 169_344, 256, 262_144, 256
STAGES = (8, 32)
# kernel against plain, as a share of the largest sum: each sum has 8C =
# 2048 f32 terms, added in another order
REL_TOL = 1e-4


def make_inputs(device, n: int = N, f: int = F, e: int = E, chunk: int = C,
                stages=STAGES, seed: int = 0):
    """(x [n, f] bf16, {S: idx [e] int32 tile ids}) from
    ``default_rng(seed)``, drawn as the script draws them: x first, then one
    index array for each S in turn."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f))
    idx = {s: rng.integers(0, n // 8, (e // chunk, 1, chunk)).astype(np.int32).reshape(-1)
           for s in stages}
    return (torch.from_numpy(x).to(device=device, dtype=torch.bfloat16),
            {s: torch.from_numpy(i).to(device) for s, i in idx.items()})


def gather_tiles_plain(x: torch.Tensor, idx: torch.Tensor, chunk: int = C) -> torch.Tensor:
    """The group sums in plain PyTorch: [E/chunk, 8, F] f32."""
    e, f = idx.shape[0], x.shape[1]
    tiles = x.float().view(-1, 8, f).index_select(0, idx.long())  # [E, 8, F]
    return tiles.view(e // chunk, 8, chunk, f).sum(2)


def gather_tiles(x: torch.Tensor, idx: torch.Tensor, chunk: int = C,
                 stages: int = 8) -> torch.Tensor:
    """out[c, r] = sum_{k < chunk} f32(scratch_c[r*chunk + k]) with
    ``scratch_c[8j + i] = x[8*idx[c*chunk + j] + i]``.

    x: [N, F] bfloat16 with N % 8 == 0 (F % 8 == 0 and F <= 256 on the card);
    idx: [E] int32 tile ids below N/8, E % chunk == 0, chunk % 8 == 0;
    ``stages`` tiles in the ring. Returns [E/chunk, 8, F] float32."""
    if x.dim() != 2 or x.dtype != torch.bfloat16 or x.shape[0] % 8:
        raise TypeError(f"x must be [N, F] bfloat16 with N % 8 == 0, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise TypeError("idx must be a 1-d int32 tensor")
    e, f = idx.shape[0], x.shape[1]
    if chunk % 8 or e % chunk:
        raise ValueError(f"chunk ({chunk}) must be a multiple of 8 dividing E ({e})")
    if x.device != idx.device:
        raise ValueError("x and idx must be on one device")
    if x.device.type == "cpu":
        return gather_tiles_plain(x, idx, chunk)
    ring = -(-stages * 8 // 128) * 128 + stages * 8 * f * 2
    if f % 8 or f > 256 or stages < 1 or ring > 227 * 1024:
        raise ValueError(f"the kernel takes F % 8 == 0, F <= 256 and a ring of stages "
                         f"within 227 KB of shared memory, got F = {f}, stages = {stages}")
    x, idx = x.contiguous(), idx.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    out = torch.empty(e // chunk, 8, f, dtype=torch.float32, device=x.device)
    if e:
        err = _build.library("microbench").sgf_gather_tiles(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), e // chunk, chunk, f, stages,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "gather_tiles")
        kernels.probe_launches["gather_tiles"] += 1
    return out


def run(x: torch.Tensor, idx: torch.Tensor, chunk: int = C, stages: int = 8,
        iters: int = 20) -> dict:
    """Time the kernel, its plain version and the library yardstick on the
    card; the kernel's rates and its bound (each distinct tile of x read
    once, idx read once, the sums written once)."""
    e, f = idx.shape[0], x.shape[1]
    ms = measure.time_ms(lambda: gather_tiles(x, idx, chunk, stages), iters)
    plain_ms = measure.time_ms(lambda: gather_tiles_plain(x, idx, chunk), iters)
    il = idx.long()
    tiles = x.view(-1, 8 * f)
    library_ms = measure.time_ms(lambda: torch.index_select(tiles, 0, il).view(
        e // chunk, 8, chunk, f).sum(2, dtype=torch.float32), iters)
    distinct = torch.unique(idx).numel()
    nbytes = distinct * 8 * f * 2 + e * 4 + (e // chunk) * 8 * f * 4
    b_ms, b_by = measure.bound_ms(nbytes, e * 8 * f)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                mtiles_per_s=e / ms / 1e3, ns_per_tile=ms / e * 1e6,
                gb_per_s=e * 8 * f * 2 / ms / 1e6, distinct_tiles=distinct)


def main() -> int:
    if not torch.cuda.is_available():
        print("dma_tile: CUDA is not available; this probe needs a GPU", file=sys.stderr)
        return 1
    print(measure.card_line(), flush=True)
    x, idx = make_inputs("cuda")
    for stages in STAGES:
        got = gather_tiles(x, idx[stages], stages=stages)
        err, scale = measure.rel_err(got, gather_tiles_plain(x, idx[stages]))
        print(f"gather_tiles S={stages} vs plain: max |diff| {err:.3e} (largest sum "
              f"{scale:.3e})")
        if err > REL_TOL * scale:
            print("gather_tiles disagrees with its plain version", file=sys.stderr)
            return 1
        r = run(x, idx[stages], stages=stages)
        print(f"TMA tile gather S={stages}: {r['ms']:7.4f} ms for {E} tiles ({r['mtiles_per_s']:.1f}"
              f" Mtiles/s, {r['ns_per_tile']:.3f} ns/tile, {r['gb_per_s']:.0f} GB/s); bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}; index_select + sums "
              f"{r['library_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
