"""Process groups for sharded training: the counterpart of
``sgformer_tpu/parallel/mesh.py`` on ``torch.distributed``.

The JAX package runs one process over every device and names mesh axes
(``"sp"``, or ``("dp", "sp")``) that its collectives reduce over. The port
runs one process per card (``torchrun --nproc_per_node S``), and a mesh axis
is a name registered here for a process group: the modules take
``axis_name`` as the JAX modules do, and :mod:`.comm` looks the group up by
that name. :func:`make_mesh` registers the whole group as one axis;
:func:`make_global_mesh` lays the ranks out on a (dp, sp) grid, world rank r
at (r // sp, r % sp), with a group for each row (an ``"sp"`` group: sp
consecutive ranks, one host's under ``torchrun --nproc_per_node sp``) and for
each column (a ``"dp"`` group, across hosts, as the JAX mesh lays dp over
DCN). Registration works the same under NCCL (the backend of CUDA tensors)
and gloo (of CPU tensors, and of several ranks sharing one card). A name
stays bound to its group for as long as the default group lives: binding it
again to a group of other ranks raises, since every module built with that
``axis_name`` would silently reduce over the new group.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from sgformer_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One mesh axis: its name (a tuple of names for the product of
    several axes), this process's rank in its group, the group's size, this
    process's device and the process group (None: the default group)."""

    axis_name: Union[str, tuple]
    rank: int
    size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = dataclasses.field(default=None, compare=False)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


@dataclasses.dataclass(frozen=True)
class GridMesh:
    """A 2-D mesh of the whole group (:func:`make_global_mesh`): ``shape``
    maps each axis name to its size, ``mesh[name]`` is that axis's
    :class:`Mesh` (``mesh[axis_names]`` the whole group's), and ``coords``
    this rank's index along each axis."""

    axis_names: tuple
    axes: dict
    device: torch.device

    @property
    def shape(self) -> dict:
        return {name: self.axes[name].size for name in self.axis_names}

    @property
    def coords(self) -> tuple:
        return tuple(self.axes[name].rank for name in self.axis_names)

    @property
    def rank(self) -> int:
        return self.axes[self.axis_names].rank

    def __getitem__(self, axis_name) -> Mesh:
        return self.axes[axis_name]


_AXES: dict = {}
# (axis_names, dp) -> the GridMesh made for it, so that a second call makes
# no new groups
_GRIDS: dict = {}
# the default group that _AXES and _GRIDS were registered under
_WORLD: Optional[dist.ProcessGroup] = None
_DEVICE: Optional[torch.device] = None


def _members(mesh: Mesh) -> list:
    """The world ranks of the mesh's group."""
    if mesh.group is None:
        return list(range(dist.get_world_size()))
    return dist.get_process_group_ranks(mesh.group)


def _registered(axis_name):
    """The mesh bound to ``axis_name`` under the current default group (the
    registry is emptied when the default group changes), or None."""
    global _WORLD
    if _WORLD is not dist.group.WORLD:
        _AXES.clear()
        _GRIDS.clear()
        _WORLD = dist.group.WORLD
    return _AXES.get(axis_name)


def _bound_as(mesh: Mesh) -> Optional[Mesh]:
    """The mesh that ``mesh.axis_name`` is bound to, when it has the same
    ranks on the same device; None when the name is free. Raises when the
    name is bound to another group."""
    old = _registered(mesh.axis_name)
    if old is None or (old.device == mesh.device and _members(old) == _members(mesh)):
        return old
    raise ValueError(f"mesh axis {mesh.axis_name!r} is bound to the ranks {_members(old)}; "
                     f"it cannot be bound again to {_members(mesh)}")


def _register(mesh: Mesh) -> Mesh:
    """Bind ``mesh.axis_name`` to ``mesh`` (:func:`_bound_as`: keep the mesh
    of the same ranks that it is bound to); returns the bound mesh."""
    old = _bound_as(mesh)
    if old is None:
        _AXES[mesh.axis_name] = mesh
        return mesh
    return old


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
    rank's card if there is no group yet). Raises if the name is bound to
    another group (a :func:`make_global_mesh` axis of fewer ranks)."""
    dev = init_distributed(device)
    return _register(Mesh(axis_name, dist.get_rank(), dist.get_world_size(), dev))


def make_global_mesh(dp: Optional[int] = None, axis_names=("dp", "sp"), device=None):
    """The ranks of the whole group on a (dp, sp) grid, sp = world / dp,
    every axis registered: world rank r sits at (r // sp, r % sp), each row
    of sp consecutive ranks is an ``axis_names[1]`` group, each column an
    ``axis_names[0]`` group, and the pair names the whole group. ``dp``
    defaults to the number of hosts (``WORLD_SIZE // LOCAL_WORLD_SIZE``
    under torchrun; 1 without it). With one axis name it is
    :func:`make_mesh`'s 1-D mesh, which needs dp = world size. Every rank
    must call it alike: each creates every row and column group, in one
    order; a second call with the same names and dp returns the first's
    mesh and creates none. Raises when the world size is not divisible by
    dp, or when a name is bound to another group (:func:`make_mesh`'s whole
    group as ``"sp"``, say). Returns a :class:`GridMesh` (a :class:`Mesh`
    for one axis name)."""
    dev = init_distributed(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp is None:
        dp = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if dp < 1 or world % dp:
        raise ValueError(f"{world} ranks not divisible by dp={dp}")
    axis_names = tuple(axis_names)
    if len(axis_names) == 1:
        if dp != world:
            raise ValueError(f"1-axis mesh needs dp == world size, got {dp} != {world}")
        return make_mesh(axis_names[0], device=dev)
    if len(axis_names) != 2:
        raise ValueError(f"a global mesh has one or two axes, got {axis_names}")
    if _registered(axis_names) is not None and (axis_names, dp) in _GRIDS:
        return _GRIDS[axis_names, dp]
    sp = world // dp
    # dist.new_group is collective: every rank creates every group, in order
    rows = [dist.new_group(list(range(d * sp, (d + 1) * sp))) for d in range(dp)]
    cols = [dist.new_group(list(range(s, world, sp))) for s in range(sp)]
    d, s = divmod(rank, sp)
    dp_name, sp_name = axis_names
    axes = {dp_name: Mesh(dp_name, d, dp, dev, cols[s]),
            sp_name: Mesh(sp_name, s, sp, dev, rows[d]),
            axis_names: Mesh(axis_names, rank, world, dev)}
    for mesh in axes.values():
        _bound_as(mesh)  # raises before any name is bound
    axes = {name: _register(mesh) for name, mesh in axes.items()}
    grid = _GRIDS[axis_names, dp] = GridMesh(axis_names, axes, dev)
    return grid


def axis(axis_name) -> Mesh:
    """The mesh registered as ``axis_name`` (a name, or a tuple of the
    names of a :func:`make_global_mesh`); raises if none is."""
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
