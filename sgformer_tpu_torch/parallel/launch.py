"""Start a group of ranks on this host: one process per rank, spawned, each
joined to the group before it calls the work.

``torchrun --nproc_per_node S`` is how a user starts the sharded trainer on S
cards (:mod:`sgformer_tpu_torch.cli.main`); :func:`run_group` does the same
from Python for the scaling harness, the tests and the card's checks, with a
file store under a fresh temporary directory as the rendezvous, so that no
two groups share a port.
"""

from __future__ import annotations

import tempfile
from typing import Optional

import torch.distributed as dist
import torch.multiprocessing as mp

from sgformer_tpu_torch.device import resolve_device
from sgformer_tpu_torch.parallel.mesh import init_distributed


def _entry(rank: int, fn, world_size: int, init_method: str, device, backend, args) -> None:
    init_distributed(device, backend, init_method=init_method, rank=rank,
                     world_size=world_size)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_group(fn, world_size: int, *args, device="cuda", backend: Optional[str] = None) -> None:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes joined to
    one process group, on the card unless ``device="cpu"`` asks for the CPU
    (raising before any rank starts when CUDA is absent); ``backend``: NCCL
    on the card, gloo on the CPU, unless named (under gloo several ranks may
    share one card). ``fn`` must be importable by name (a module-level
    function); it returns nothing (a rank writes what it must hand back to a
    file). Raises if a rank fails."""
    resolve_device(device)
    with tempfile.TemporaryDirectory() as store:
        mp.spawn(_entry, args=(fn, world_size, f"file://{store}/rendezvous", device, backend,
                               args), nprocs=world_size, join=True)
