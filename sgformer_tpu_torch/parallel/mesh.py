"""Process groups for node-sharded training: the counterpart of
``sgformer_tpu/parallel/mesh.py`` on ``torch.distributed``.

The JAX package runs one process over every device and names a mesh axis
(``"sp"``) that its collectives reduce over. The port runs one process per
card (``torchrun --nproc_per_node S``), and a mesh axis is a name registered
here for a process group: the modules take ``axis_name`` as the JAX modules
do, and :mod:`.comm` looks the group up by that name. Registration works the
same under NCCL (the backend of CUDA tensors) and gloo (of CPU tensors, and
of several ranks sharing one card).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from sgformer_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One mesh axis over the default process group: its name, this
    process's rank in it, its size and this process's device."""

    axis_name: str
    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str:
        return dist.get_backend()


_AXES: dict[str, Mesh] = {}
_DEVICE: Optional[torch.device] = None


def _rank_device(device, local_rank: int) -> torch.device:
    """The device of a rank: ``cuda:{local_rank % device_count}`` for
    ``device`` None or ``"cuda"`` (raising without CUDA), else ``device``."""
    if device is None or torch.device(device) == torch.device("cuda"):
        resolve_device("cuda")
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return resolve_device(device)


def init_distributed(device=None, backend: Optional[str] = None, *,
                     init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join (or start) the default process group, once; returns this rank's
    device. Idempotent: a later call joins nothing and returns the device
    (the first call's when ``device`` is None; it raises if another is
    asked for).

    Under ``torchrun`` the rank, the world size and the local rank come from
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``, the rendezvous from
    ``MASTER_ADDR``/``MASTER_PORT``; without them (and without ``rank``,
    ``world_size`` and ``init_method``) the process is a group of one. The
    device is ``cuda:{LOCAL_RANK % device_count}`` unless ``device`` names
    another (``"cpu"``: the CPU, only when asked); the backend is NCCL for
    CUDA and gloo for the CPU unless ``backend`` names one (gloo lets several
    ranks share one card, which NCCL refuses)."""
    global _DEVICE
    if device is None and dist.is_initialized() and _DEVICE is not None:
        return _DEVICE
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    dev = _rank_device(device, int(env.get("LOCAL_RANK", rank)))
    if dist.is_initialized():
        if _DEVICE is not None and dev != _DEVICE:
            raise ValueError(f"the process group runs on {_DEVICE}, not {dev}")
        _DEVICE = dev
        return dev
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = dict(backend=backend, rank=rank, world_size=world_size)
    if init_method is not None:
        kwargs["init_method"] = init_method
    elif "MASTER_ADDR" in env:
        kwargs["init_method"] = "env://"
    elif world_size == 1:
        kwargs["store"] = dist.HashStore()
    else:
        raise ValueError(f"world size {world_size} needs a rendezvous: run under torchrun "
                         "(MASTER_ADDR) or pass init_method")
    dist.init_process_group(**kwargs)
    _DEVICE = dev
    return dev


def make_mesh(axis_name: str = "sp", device=None) -> Mesh:
    """Register the default process group as the mesh axis ``axis_name``
    and return it, on this rank's ``device`` (:func:`init_distributed`,
    which starts the group if nothing has; None: the group's device, or the
    rank's card if there is no group yet)."""
    dev = init_distributed(device)
    mesh = Mesh(axis_name, dist.get_rank(), dist.get_world_size(), dev)
    _AXES[axis_name] = mesh
    return mesh


def axis(axis_name: str) -> Mesh:
    """The mesh registered as ``axis_name``; raises if none is."""
    try:
        return _AXES[axis_name]
    except KeyError:
        raise KeyError(f"no mesh axis {axis_name!r}: build one with "
                       f"sgformer_tpu_torch.parallel.make_mesh({axis_name!r})") from None


def shard_rows(num_nodes: int, num_shards: int) -> int:
    """Rows per shard: contiguous blocks of ``ceil(N / S)``."""
    return -(-num_nodes // num_shards)


def feed_process_local(data, mesh: Mesh, num_nodes: int) -> torch.Tensor:
    """This rank's rows of the node-indexed ``data`` ([N, ...], numpy or a
    tensor), padded with zeros to the shard's ``ceil(N / S)`` rows, on the
    mesh's device: each rank materialises only its own rows."""
    block = shard_rows(num_nodes, mesh.size)
    lo, hi = min(mesh.rank * block, num_nodes), min((mesh.rank + 1) * block, num_nodes)
    rows = torch.as_tensor(data[lo:hi])
    out = torch.zeros((block,) + tuple(rows.shape[1:]), dtype=rows.dtype, device=mesh.device)
    out[:hi - lo] = rows
    return out
