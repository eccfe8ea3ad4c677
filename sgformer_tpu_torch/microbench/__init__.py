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
