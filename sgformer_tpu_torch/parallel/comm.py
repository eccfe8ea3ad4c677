"""The collectives of node-sharded training, differentiable: the counterpart
of the ``jax.lax`` collectives that the JAX package's sharded modules call.

Each function takes the mesh axis name (:mod:`.mesh`) and runs over that
axis's process group, with the gradient that the JAX collective's transpose
gives:

- :func:`all_reduce_sum` (``psum``): the backward all-reduces the cotangents;
- :func:`all_gather_rows` (tiled ``all_gather`` over rows): the backward
  reduce-scatters them (``psum_scatter``);
- :func:`all_to_all_rows` (``all_to_all``, slot i to rank i): the backward
  is the same all-to-all of the cotangents.

As under ``shard_map``, every rank seeds the backward of a replicated loss
(one made from all-reduced sums), so each rank's parameter gradient is S
times its share; the trainer averages them over the group
(:class:`~sgformer_tpu_torch.parallel.sharded.ShardedTrainer`), which gives
the global gradient, as the JAX ``pmean`` does.

The collectives run on the tensors' own device under whatever backend the
group has: NCCL for CUDA tensors, gloo for CPU tensors or for several ranks
sharing one card. No buffer is staged through the host: a collective the
backend refuses raises. ``axis_name`` may also be a tuple of the axes of a
:func:`~sgformer_tpu_torch.parallel.make_global_mesh` (the JAX
``psum(..., ("dp", "sp"))``), which runs over the whole group. :data:`calls`
counts each collective by (name, axis, backend, device type), so a run can
show what ran over which group and where.
:func:`all_reduce_` is the in-place sum without autograd, for code that
already sits inside an autograd Function (the attention kernels' partial
sums).
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

from sgformer_tpu_torch.parallel.mesh import Mesh, axis


# (collective, axis name, backend, device type) -> calls since the last reset
calls: Counter = Counter()


def _record(name: str, mesh: Mesh, t: torch.Tensor) -> None:
    calls[(name, mesh.axis_name, mesh.backend, t.device.type)] += 1


def all_reduce_(t: torch.Tensor, axis_name) -> torch.Tensor:
    """Sum ``t`` over the axis in place (no autograd); returns ``t``."""
    mesh = axis(axis_name)
    _record("all_reduce", mesh, t)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def gather_rows_(x: torch.Tensor, axis_name) -> torch.Tensor:
    """[S * B, ...]: every rank's [B, ...] rows in rank order (no autograd)."""
    mesh = axis(axis_name)
    x = x.contiguous()
    out = x.new_empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]))
    _record("all_gather_into_tensor", mesh, x)
    dist.all_gather_into_tensor(out, x, group=mesh.group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return all_reduce_(x.contiguous().clone(), axis_name)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.axis_name), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return gather_rows_(x, axis_name)

    @staticmethod
    def backward(ctx, g):
        mesh = axis(ctx.axis_name)
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // mesh.size,) + tuple(g.shape[1:]))
        _record("reduce_scatter_tensor", mesh, g)
        dist.reduce_scatter_tensor(out, g, op=dist.ReduceOp.SUM, group=mesh.group)
        return out, None


def _all_to_all(x: torch.Tensor, axis_name) -> torch.Tensor:
    mesh = axis(axis_name)
    x = x.contiguous()
    out = torch.empty_like(x)
    _record("all_to_all_single", mesh, x)
    dist.all_to_all_single(out, x, group=mesh.group)
    return out


class _AllToAllRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return _all_to_all(x, axis_name)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.axis_name), None


def all_reduce_sum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """The sum of ``x`` over the axis (every rank gets it), differentiable."""
    return _AllReduceSum.apply(x, axis_name)


def all_gather_rows(x: torch.Tensor, axis_name) -> torch.Tensor:
    """[S * B, ...]: every rank's [B, ...] rows in rank order, differentiable."""
    return _AllGatherRows.apply(x, axis_name)


def all_to_all_rows(x: torch.Tensor, axis_name) -> torch.Tensor:
    """x: [S, ...], slot j for rank j; returns [S, ...] whose slot i came
    from rank i. Differentiable."""
    if x.shape[0] != axis(axis_name).size:
        raise ValueError(f"x must have one slot per rank, got {x.shape[0]}")
    return _AllToAllRows.apply(x, axis_name)
