"""Timing probes on the card: the port of the three inline Pallas kernels
under the JAX package's ``scripts/``.

- :mod:`.dma_gather` (``scripts/microbench_dma_gather.py``): how fast the
  card gathers random 512-byte rows (a cp.async pipeline per warp);
- :mod:`.dma_tile` (``scripts/microbench_dma_tile.py``): how fast it gathers
  random 4 KB tiles of 8 rows (TMA bulk copies into a ring);
- :mod:`.slab_variants` (``scripts/microbench_slab_variants.py``): how much of
  the CSR SpMM's time is the source gather and how much the row walk.

Each module has a plain PyTorch version, a kernel wrapper (its kernel in
``csrc/microbench.cu``; the plain version on CPU tensors), a ``run`` that
times the kernel, and a ``main`` for the card:

    python -m sgformer_tpu_torch.microbench.dma_gather
    python -m sgformer_tpu_torch.microbench.dma_tile
    python -m sgformer_tpu_torch.microbench.slab_variants

Their launches are counted with every other kernel's, in
:func:`sgformer_tpu_torch.kernels.launch_counts`.
"""

# what an H100 SM holds for resident blocks: shared memory (228 KB, of which
# the system keeps 1 KB a block), threads, blocks
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_BLOCK = 1024
THREADS_PER_SM = 2048
BLOCKS_PER_SM = 32


def resident_blocks(smem: int, threads: int) -> int:
    """The blocks of ``threads`` threads and ``smem`` bytes of dynamic shared
    memory an SM holds at once, by shared memory and threads (the card's
    occupancy query also counts registers)."""
    return min(SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK), THREADS_PER_SM // threads,
               BLOCKS_PER_SM)


def persistent_grid(items: int, sms: int, per_sm: int) -> int:
    """One block for each resident slot of the card, but no more blocks than
    work items (each block walks items blockIdx.x, += gridDim.x)."""
    return max(1, min(items, sms * per_sm))


def card_blocks_per_sm(entry: str, f: int, stages: int) -> int:
    """The blocks an SM of the card holds of a gather kernel at width ``f``
    and ring ``stages``, from its library's occupancy query ``entry``
    (shared memory, threads and registers); raises where it holds none."""
    from sgformer_tpu_torch.kernels import _build

    per_sm = getattr(_build.library("microbench"), entry)(f, stages)
    if per_sm < 0:
        _build.check(-per_sm, entry)
    if per_sm == 0:
        raise ValueError(f"{entry}: no block fits an SM at F = {f}, stages = {stages}")
    return per_sm
