"""``DPBatchTrainer``: the ``main-batch.py`` loop on a (dp, sp) grid of
ranks, the port of ``sgformer_tpu/parallel/dp_trainer.py``.

Where :class:`~sgformer_tpu_torch.train.BatchTrainer` trains its random
batches one after the other, this trainer trains dp of them at once, one per
dp group, each node-sharded over its group's sp ranks (:mod:`.dp_batch`
holds the step and its collectives). One process a card: world rank r sits
at (r // sp, r % sp), so ``torchrun --nproc_per_node sp`` on each of dp
hosts gives one dp group a host, as the JAX package lays dp over DCN.

The epoch covers all nodes: ``n // (B dp)`` full steps, then one step of the
remaining nodes split as evenly as possible across the groups, each group
padded to the full batch's shape (:func:`.dp_batch.build_dp_sp_batch`).
Every rank draws the same permutation from ``np.random.default_rng(seed)``
and takes its group's slice.

Where it differs from the JAX trainer, and why. The parameters start equal
on every rank, drawn from one seeded CPU generator (or loaded, ``init_state
(seed, state=)``); the JAX trainer's init on a warm batch under
``shard_map`` fixes its compiled shapes and has no counterpart. Dropout is
seeded per world rank (:func:`.sharded.rank_seed`): JAX folds its dp and sp
indices into its key, so the masks cannot match. The eval runs an unsharded
twin of the model (every ``axis_name`` None, the parameters and BatchNorm
statistics copied in before each eval) over each split in batches of B,
built by :func:`~sgformer_tpu_torch.train.build_subgraph_batch` at their
real size (JAX pads the tail and masks it: the same values); the batches
are dealt round-robin over every rank and the hits all-reduced. As in the
JAX trainer, it counts argmax accuracy whatever ``config.metric`` says.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from sgformer_tpu_torch.parallel.comm import all_reduce_
from sgformer_tpu_torch.parallel.dp_batch import (DPBatch, build_dp_sp_batch,
                                                  make_dp_sp_train_step)
from sgformer_tpu_torch.parallel.mesh import GridMesh, init_distributed, make_global_mesh
from sgformer_tpu_torch.parallel.sharded import rank_seed
from sgformer_tpu_torch.train.batch_trainer import (BatchTrainConfig, BatchTrainer,
                                                    build_subgraph_batch)


def unsharded_twin(model):
    """A copy of ``model`` (which holds no dropout generator) whose
    attention and BatchNorm reduce over no mesh axis: every module's
    ``axis_name`` and the config's set to None."""
    twin = copy.deepcopy(model)
    for mod in twin.modules():
        if getattr(mod, "axis_name", None) is not None:
            mod.axis_name = None
    config = getattr(twin, "config", None)
    if dataclasses.is_dataclass(config) and getattr(config, "axis_name", None) is not None:
        twin.config = dataclasses.replace(config, axis_name=None)
    return twin


class DPBatchTrainer(BatchTrainer):
    """Runs ``config.runs`` runs of the ``main-batch.py`` loop, dp batches a
    step: :class:`~sgformer_tpu_torch.train.BatchTrainer`'s loop (its
    ``init_state``, ``fit``, ``record_losses`` and ``final_state``) with its
    hooks overridden, so that an epoch's steps, each rank's batch, the step
    and the eval are the grid's.

    Args:
      model: a model of the port built with ``axis_name`` the grid's second
        axis (``SGFormerConfig(axis_name="sp")``, or the baselines'
        ``axis_name=``); GAT refuses it, and ``gnn="gcn"`` (the PyG edges,
        which a dp batch does not build) raises at its first step.
      edge_index: [2, E] (src, dst) of the full graph, numpy or a tensor;
        x: [N, F] features; label: [N, 1] int labels (or [N, C] for
        ``loss='bce'``). Every rank passes the same; they are kept on this
        rank's device.
      config: :class:`~sgformer_tpu_torch.train.BatchTrainConfig`
        (``eval_mode`` is not read: the eval is the split sweep above).
      mesh: a :class:`~sgformer_tpu_torch.parallel.mesh.GridMesh`; when
        None, :func:`make_global_mesh` over the whole group (started on
        ``device`` if nothing has) with ``dp`` groups of ``sp`` ranks
        (default world / dp).
      eval_func: taken for the JAX trainer's signature and, as there, not
        read.
      device: "cuda" (this rank's card) unless the caller asks for "cpu".

    Only rank 0 prints. After :meth:`fit` every rank holds the last run's
    state dict in ``final_state``.
    """

    def __init__(self, model, edge_index, x, label, config: BatchTrainConfig,
                 mesh: Optional[GridMesh] = None, dp: int = 2, sp: Optional[int] = None,
                 eval_func=None, device="cuda"):
        if mesh is None:
            init_distributed(device)
            world = dist.get_world_size()
            sp = sp or world // dp
            if dp * sp != world:
                raise ValueError(f"mesh shape ({dp}, {sp}) != world size {world}")
            mesh = make_global_mesh(dp, device=device)
        self.mesh = mesh
        self.axes = mesh.axis_names
        self.dp, self.sp = (mesh.shape[a] for a in self.axes)
        self.writes_logs = mesh.rank == 0
        super().__init__(model, edge_index, x, label, config, eval_func=eval_func,
                         device=mesh.device)
        self.model.set_dropout_generator(None)
        self.twin = unsharded_twin(self.model)
        self.model.set_dropout_generator(self.generator)
        self.step = None

    def init_state(self, seed: int, state: Optional[dict] = None) -> torch.optim.Optimizer:
        """:meth:`BatchTrainer.init_state` (the parameters from a CPU
        generator seeded ``seed``, the same on every rank, or ``state``) and
        the dp x sp step on its optimizer."""
        optimizer = super().init_state(seed, state)
        self.step = make_dp_sp_train_step(self.model, optimizer, self.mesh, self.config.loss)
        return optimizer

    def dropout_seed(self, seed: int) -> int:
        return rank_seed(seed, self.mesh.rank)

    # -- batches and steps -----------------------------------------------------

    def num_batches(self) -> int:
        """Steps of an epoch; the last holds the remainder."""
        per_step = self.config.batch_size * self.dp
        return self.num_nodes // per_step + (self.num_nodes % per_step > 0)

    def batch_nodes(self, perm: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's group's nodes at step ``i`` of the permutation
        ``perm``: a slice of B, or on the remainder step its share of the
        leftover nodes (split as evenly as possible, the first groups one
        larger)."""
        b, dp, g = self.config.batch_size, self.dp, self.mesh.coords[0]
        base = i * b * dp
        if base + b * dp <= self.num_nodes:
            return perm[base + g * b:base + (g + 1) * b]
        rest = self.num_nodes - base
        lo = g * (rest // dp) + min(g, rest % dp)
        return perm[base + lo:base + lo + rest // dp + (g < rest % dp)]

    def build_batch(self, node_batch, train_set: Optional[torch.Tensor] = None) -> DPBatch:
        """This rank's shard of the group batch ``node_batch`` (node ids),
        padded to the full batch's shape; its train mask from ``train_set``
        ([N] bool on the device; none when None)."""
        graph, idx, node_mask = build_dp_sp_batch(
            self.edge_index, node_batch, self.num_nodes, self.sp, self.mesh.coords[1],
            pad_nodes_to=self.config.batch_size, axis_name=self.axes[1])
        label = (self.label_onehot if self.config.loss == "bce" else self.label)[idx]
        train_mask = (torch.zeros_like(node_mask) if train_set is None
                      else node_mask * train_set[idx].float())
        return DPBatch(graph, self.x[idx], label, train_mask, node_mask, len(node_batch))

    def train_step(self, batch: DPBatch) -> torch.Tensor:
        """One dp x sp step (:func:`.dp_batch.make_dp_sp_train_step`);
        returns the replicated loss without waiting for it."""
        if self.step is None:
            raise RuntimeError("call init_state(seed) before training")
        return self.step(batch)

    # -- evaluation ------------------------------------------------------------

    def evaluate(self, split_idx: dict, np_rng=None) -> tuple:
        """(train, valid, test, 0.0): each split's argmax accuracy through
        the unsharded twin, its batches of B dealt round-robin over every
        rank, the hits all-reduced: every rank returns the same."""
        self.twin.load_state_dict(self.model.state_dict())
        self.twin.eval()
        b, world, rank = self.config.batch_size, self.mesh[self.axes].size, self.mesh.rank
        splits = ("train", "valid", "test")
        idx = {s: torch.as_tensor(np.asarray(split_idx[s]), device=self.device).long()
               for s in splits}
        hits = torch.zeros(len(splits), dtype=torch.float64, device=self.device)
        turn = 0
        with torch.no_grad():
            for k, s in enumerate(splits):
                for i in range(0, idx[s].numel(), b):
                    if turn % world == rank:
                        bidx = idx[s][i:i + b]
                        graph = build_subgraph_batch(self.edge_index, bidx, self.num_nodes)
                        pred = self.twin(self.x[bidx], graph).argmax(dim=-1)
                        hits[k] += (pred == self.label[bidx]).sum()
                    turn += 1
        all_reduce_(hits, self.axes)
        return tuple(hits[k].item() / max(idx[s].numel(), 1)
                     for k, s in enumerate(splits)) + (0.0,)
