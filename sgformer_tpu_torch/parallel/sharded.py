"""Node-sharded full-graph training on ``torch.distributed``: the port of
``sgformer_tpu/parallel/sharded.py``.

Each rank holds one contiguous block of nodes (:mod:`.partition`) and runs
the whole step on it: both model branches, the masked loss, the backward,
the gradient all-reduce, Adam and the BatchNorm statistics. The traffic of a
step (``SURVEY.md`` §5 of the JAX package):

- attention: one all-reduce of the reduce kernels' sums ([H, M, D] + [H, M]
  + 3 scalars) per TransConv layer, and one of the backward's (P, ds, dinv)
  (:func:`sgformer_tpu_torch.kernels.attention.fused_linear_attention`);
- GCN branch: per layer, one [S B, F] all-gather of the activation, or with
  the halo one [S H, F] all-to-all of the boundary rows (and its transpose
  in the backward);
- BatchNorm: one all-reduce of (count, Σx, Σx²) per norm layer;
- the loss: one all-reduce of (Σ loss, Σ mask); the gradients: one
  all-reduce of every parameter's gradient, averaged.

As under ``shard_map``, every rank seeds the backward of the replicated loss,
so each rank's gradient is S times its share; their mean is the global
gradient, as the JAX ``pmean`` gives it. The JAX package runs one process
over every device; here each rank is a process with its own card (or, under
gloo, several ranks share one).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from sgformer_tpu_torch.parallel.comm import all_reduce_, all_reduce_sum, gather_rows_
from sgformer_tpu_torch.parallel.mesh import Mesh, axis, feed_process_local, make_mesh
from sgformer_tpu_torch.parallel.partition import idx_to_mask, partition_graph
from sgformer_tpu_torch.train.trainer import Trainer, TrainConfig, bce_per_node, nll_per_node

_GOLDEN = 0x9E3779B97F4A7C15


def rank_seed(seed: int, rank: int) -> int:
    """The dropout seed of ``rank``: ``seed`` folded with the rank (rank 0
    keeps ``seed``), as the JAX step folds ``axis_index`` into its key."""
    return (seed + rank * _GOLDEN) % 2 ** 64


def sharded_loss(model, x, graph, target, node_mask, train_mask, axis_name,
                 loss: str = "nll") -> torch.Tensor:
    """The masked loss over every shard's train rows, from a train-mode
    forward on this shard: (Σ loss, Σ mask) all-reduced over ``axis_name``
    (a name, or a tuple of a grid's names), divided by ``max(Σ mask, 1)``
    (a data-parallel remainder step may carry no train row), so every rank
    holds the same value. ``target``: int64 labels (NLL) or f32 one-hot
    rows (BCE), this shard's rows."""
    model.train()
    out = model(x, graph, node_mask=node_mask)
    per = bce_per_node(out, target) if loss == "bce" else nll_per_node(out, target)
    sums = all_reduce_sum(torch.stack([(per * train_mask).sum(), train_mask.sum()]),
                          axis_name)
    return sums[0] / sums[1].clamp(min=1.0)


def average_gradients(model, axis_name) -> None:
    """Every parameter's gradient averaged over the axis, in one
    all-reduce (a parameter without one counts as 0)."""
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    all_reduce_(flat, axis_name).div_(axis(axis_name).size)
    at = 0
    for p in params:
        p.grad.copy_(flat[at:at + p.numel()].view_as(p))
        at += p.numel()


def eval_logits(model, x, graph, node_mask, axis_name: str) -> torch.Tensor:
    """[S B, C] eval-mode logits of every shard (padding rows included),
    without autograd, on every rank."""
    model.eval()
    with torch.no_grad():
        return gather_rows_(model(x, graph, node_mask=node_mask), axis_name)


class ShardedTrainer(Trainer):
    """Full-graph trainer on a node-sharded process group: the loop and
    semantics of :class:`~sgformer_tpu_torch.train.Trainer` (``init_state``,
    ``train_step``, ``multi_step``, ``eval_step``, ``fit``), every step on
    this rank's shard.

    The model must be built with ``axis_name`` matching the mesh axis
    (``SGFormerConfig(axis_name=...)``, ``GCN``/``MLP(axis_name=...)`` and
    the other baselines with BatchNorm), so that its attention and
    BatchNorm reduce over it. It is :class:`Trainer` with its placement
    hooks overridden: the graph is this rank's shard, x and the labels its
    rows, dropout seeded per rank, the gradients averaged over the axis
    before each optimizer step, and the loss and the eval all-reduced and
    gathered. Every rank passes the
    same graph, features and labels (host arrays or tensors) and keeps only
    its own rows of x and the labels on its device. Parameters start equal
    on every rank (drawn from the same seeded CPU generator); dropout draws
    from a generator per rank, seeded :func:`rank_seed`. ``eval_step``
    gathers the real rows' logits to every rank, in the caller's node order.
    Only rank 0 prints.

    Args:
      mesh: the mesh axis (:func:`~sgformer_tpu_torch.parallel.make_mesh`);
        when None, ``axis_name`` over the default group on ``device``
        ("cuda", this rank's card, unless the caller asks for "cpu"),
        which is started if nothing has.
      use_halo: aggregate the GCN edges through the halo exchange (else
        over the all-gathered rows).
    """

    def __init__(self, model, graph, x, label, config: TrainConfig, mesh: Optional[Mesh] = None,
                 axis_name: str = "sp", eval_func: Optional[Callable] = None,
                 use_halo: bool = True, device="cuda"):
        self.mesh = mesh if mesh is not None else make_mesh(axis_name, device=device)
        self.axis_name = self.mesh.axis_name
        self.use_halo = use_halo
        self.num_real_nodes = graph.num_nodes
        self.writes_logs = self.mesh.rank == 0
        super().__init__(model, graph, x, label, config, eval_func=eval_func,
                         device=self.mesh.device)
        self.node_mask = self.place_rows(torch.ones(self.num_real_nodes))

    def place_graph(self, graph):
        """This rank's shard of ``graph`` (:func:`partition_graph`)."""
        return partition_graph(graph, self.mesh.size, self.mesh.rank, self.axis_name,
                               with_halo=self.use_halo, device=self.device)

    def place_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """This rank's rows, padded to the shard's (:func:`feed_process_local`)."""
        return feed_process_local(rows, self.mesh, self.num_real_nodes)

    def dropout_seed(self, seed: int) -> int:
        return rank_seed(seed, self.mesh.rank)

    def reduce_gradients(self) -> None:
        """The gradients averaged over the axis (:func:`average_gradients`)."""
        average_gradients(self.model, self.axis_name)

    def prepare_train_idx(self, split_idx: dict) -> torch.Tensor:
        """This rank's rows of the train mask ([B] f32), the split mapped to
        the graph's node order."""
        mask = idx_to_mask(self.order.graph_ids(split_idx["train"]), self.num_real_nodes)
        return self.place_rows(torch.from_numpy(mask))

    @property
    def target(self) -> torch.Tensor:
        """This shard's labels as the loss reads them."""
        return self.label_onehot if self.config.loss == "bce" else self.label

    def loss(self, train_mask: torch.Tensor) -> torch.Tensor:
        """:func:`sharded_loss` on this rank's shard."""
        return sharded_loss(self.model, self.x, self.graph, self.target, self.node_mask,
                            train_mask, self.axis_name, self.config.loss)

    def eval_step(self) -> torch.Tensor:
        """[N, C] f32 logits of every shard in eval mode, in the caller's
        node order, on every rank."""
        full = eval_logits(self.model, self.x, self.graph, self.node_mask, self.axis_name)
        return self.order.to_caller(full[:self.num_real_nodes])
