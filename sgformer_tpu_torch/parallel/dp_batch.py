"""Data-parallel mini-batches x node-sharded execution: the port of
``sgformer_tpu/parallel/dp_batch.py``.

The SGFormer reference trains its random-partition batches one after the
other on one GPU (``large/main-batch.py``). On a (dp, sp) grid of ranks
(:func:`~sgformer_tpu_torch.parallel.make_global_mesh`) dp batches train at
once: each dp group (a row of sp ranks) takes its own node-induced subgraph,
node-sharded over its ``"sp"`` ranks, and a step

- runs the forward and the backward on this rank's shard, the attention's
  and the BatchNorm's sums all-reduced over ``"sp"`` (the model is built
  with ``axis_name="sp"``);
- takes the loss over every train node of every group
  (:func:`.sharded.sharded_loss` over ``("dp", "sp")``: (Σ loss·mask,
  Σ mask) all-reduced, divided by ``max(Σ mask, 1)``, since a remainder
  step may carry no train node);
- averages the gradients over ``("dp", "sp")``: every rank seeds the
  replicated loss, so each rank's gradient is dp·sp times its share and the
  mean is the global gradient (:func:`.sharded.average_gradients`);
- takes the Adam step, then sets the BatchNorm running statistics to their
  mean over the dp groups weighted by each group's real-node count, so that
  a short (or empty) group of the epoch's remainder step weighs in
  proportion (0 when empty).

Each rank builds only its own group's batch and its own shard of it
(:func:`build_dp_sp_batch`). Every group, the remainder step's short ones
too, is padded to the full batch's ceil(B / sp) rows a rank, as in the JAX
package, the pad rows masked out of the attention, the BatchNorm statistics
and the loss; this keeps every kernel off a launch over zero rows. The JAX
package pads each shard's edges to one length for its compiled shapes; the
port pads no edges.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from sgformer_tpu_torch.graph import gcn_norm_weights, induced_edges, sort_by_dst
from sgformer_tpu_torch.nn.norm import MaskedBatchNorm
from sgformer_tpu_torch.parallel.comm import all_reduce_
from sgformer_tpu_torch.parallel.mesh import GridMesh, shard_rows
from sgformer_tpu_torch.parallel.partition import ShardCsr, ShardGraph
from sgformer_tpu_torch.parallel.sharded import average_gradients, sharded_loss


@dataclasses.dataclass
class DPBatch:
    """This rank's shard of its group's batch, on its device: the shard
    graph, its rows' features ([B_s, F]), labels ([B_s] int64, or [B_s, C]
    f32 for the BCE loss), train mask and node mask ([B_s] f32, 1 on real
    rows), and the group's real-node count (all its shards')."""

    graph: ShardGraph
    x: torch.Tensor
    label: torch.Tensor
    train_mask: torch.Tensor
    node_mask: torch.Tensor
    group_nodes: int


def build_dp_sp_batch(edge_index: torch.Tensor, node_batch, num_nodes_total: int, sp: int,
                      sp_rank: int, *, pad_nodes_to: Optional[int] = None,
                      axis_name: str = "sp") -> tuple:
    """Shard ``sp_rank`` of the group batch ``node_batch`` (node ids),
    split into ``sp`` contiguous blocks of ``ceil(pad_nodes_to / sp)`` rows
    (``pad_nodes_to``: the full batch's size; default the batch's own).

    The edges are the batch's node-induced subgraph relabelled to places in
    ``node_batch`` and stably sorted by destination, weighted by
    ``gcn_norm_weights`` over the batch's real nodes (what
    :func:`~sgformer_tpu_torch.train.build_subgraph_batch` computes); the
    shard keeps those into its rows, sources batch-local ([B_s, sp B_s]).
    The shard has no PyG edges and no halo. Built on ``edge_index``'s
    device ([2, E] int32 tensor). Returns (graph, idx, node_mask): idx the
    shard's node ids ([B_s] int64, pad rows 0) and node_mask 1 on its real
    rows."""
    dev = edge_index.device
    node_batch = torch.as_tensor(node_batch, device=dev).long()
    b = int(node_batch.numel())
    b_target = b if pad_nodes_to is None else int(pad_nodes_to)
    if b > b_target:
        raise ValueError(f"a group batch of {b} nodes is longer than pad_nodes_to={b_target}")
    block = shard_rows(max(b_target, 1), sp)
    src, dst = sort_by_dst(*induced_edges(edge_index, node_batch, num_nodes_total))
    weight = gcn_norm_weights(src, dst, b)
    lo, hi = min(sp_rank * block, b), min((sp_rank + 1) * block, b)
    e0, e1 = torch.searchsorted(dst, torch.tensor([lo, hi], dtype=dst.dtype,
                                                  device=dev)).tolist()
    gcn = ShardCsr.build(src[e0:e1], dst[e0:e1] - lo, weight[e0:e1], block, block * sp, dev)
    graph = ShardGraph(gcn=gcn, pyg=None, halo=None, num_nodes=block, total_nodes=block * sp,
                       num_real_nodes=b, num_edges=int(src.numel()), num_shards=sp,
                       rank=sp_rank, axis_name=axis_name)
    idx = torch.zeros(block, dtype=torch.int64, device=dev)
    idx[:hi - lo] = node_batch[lo:hi]
    node_mask = torch.zeros(block, device=dev)
    node_mask[:hi - lo] = 1.0
    return graph, idx, node_mask


def sync_batch_stats(model, group_nodes: int, dp_axis: str) -> None:
    """Every BatchNorm's running statistics set to their mean over the dp
    groups weighted by each group's real-node count ``group_nodes`` (equal
    within a group, whose sp ranks hold equal statistics): one all-reduce
    over ``dp_axis`` of (count·stats, count)."""
    stats = [t for mod in model.modules() if isinstance(mod, MaskedBatchNorm)
             for t in (mod.running_mean, mod.running_var)]
    if not stats:
        return
    count = stats[0].new_full((1,), float(group_nodes))
    flat = all_reduce_(torch.cat([t.reshape(-1) * count for t in stats] + [count]), dp_axis)
    flat = flat[:-1] / flat[-1]
    at = 0
    for t in stats:
        t.copy_(flat[at:at + t.numel()].view_as(t))
        at += t.numel()


def make_dp_sp_train_step(model, optimizer: torch.optim.Optimizer, mesh: GridMesh,
                          loss: str = "nll"):
    """The dp x sp step on this rank's shard, the counterpart of the JAX
    ``make_dp_sp_train_step``: ``step(batch)`` runs the replicated loss
    over the grid's two axes, its backward, the gradients averaged over
    both, the Adam step and the BatchNorm statistics weighted over dp, and
    returns the loss without waiting for it."""
    dp_axis, _ = axes = mesh.axis_names

    def step(batch: DPBatch) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        value = sharded_loss(model, batch.x, batch.graph, batch.label, batch.node_mask,
                             batch.train_mask, axes, loss)
        value.backward()
        average_gradients(model, axes)
        optimizer.step()
        with torch.no_grad():
            sync_batch_stats(model, batch.group_nodes, dp_axis)
        return value.detach()

    return step
