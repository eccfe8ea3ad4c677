"""Training generators: the counterpart of ``sgformer_tpu/utils/rng.py``.

The JAX package picks a PRNG bit generator for its training keys
(``impl``: threefry2x32, or the TPU's hardware rbg under "auto"). torch has
one generator family a device (a Mersenne twister on the CPU, Philox on
CUDA), so the port accepts ``impl`` and ignores it: every value draws the
same numbers.
"""

from __future__ import annotations

import torch


def train_generator(seed: int, impl: str = "auto", device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded ``seed``, for a training
    loop's dropout masks; ``impl`` is accepted and ignored."""
    del impl
    return torch.Generator(device=device).manual_seed(seed)
