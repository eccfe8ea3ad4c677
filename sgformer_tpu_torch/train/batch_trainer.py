"""Random-partition mini-batch trainer: the port of
``sgformer_tpu/train/batch_trainer.py`` (the SGFormer reference's
``large/main-batch.py`` loop).

What it computes, as the JAX package does:

- each epoch draws a fresh random node permutation and slices it into
  ``n // batch_size + (n % batch_size > 0)`` batches; the remainder batch is
  trained too;
- each batch trains one step on its node-induced subgraph (cross-batch edges
  dropped, nodes relabelled to their place in the batch), with the GCN
  normalisation taken on that subgraph; the attention branch sees only the
  batch's nodes (N in the kernels is the batch's size);
- the loss is ``sum(per_node * m) / max(sum(m), 1)`` over the batch's train
  nodes, so a batch without any still takes an Adam step;
- eval is either a full-graph forward of ``full_graph`` on the trainer's
  device (``eval_mode='full'``) or a streaming sweep over random batches of
  all nodes that counts the correct predictions of each split
  (``eval_mode='batch'``).

Where it differs, and why. Each batch's subgraph is built on the trainer's
device (:func:`build_subgraph_batch`: a pass over every edge of the full
graph through a bool membership table, the kept edges' positions in the
batch, a stable sort by destination, the degree normalisation, the
transposed CSR and both hub plans), so the card is not left waiting for the
host to walk the full edge list. The JAX package fixes
XLA's compiled shapes: it pads each batch's edges up a ladder of buckets
(``edge_bucket``, with ``BucketOverflowError`` to climb it), and pads the
tail batch and each eval batch to ``batch_size`` nodes with a ``node_mask``
that keeps the pad rows out of the attention, the BatchNorm statistics and
the loss. PyTorch on the card compiles no shapes, so none of that has a
counterpart here (nor the ladder's ``ladder_base`` or ``use_pallas``'s
chunk plans): the tail batch and every eval batch run at their real size
with no mask, which computes the same values (``tests/
test_torch_batch.py`` holds the two against each other). The JAX
``eval_device='cpu'`` offload of the full-graph eval has no counterpart
either: a caller who wants that eval on the CPU builds the trainer with
``device='cpu'``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from sgformer_tpu_torch.data.metrics import METRICS
from sgformer_tpu_torch.device import resolve_device
from sgformer_tpu_torch.graph import (Graph, gcn_norm_weights, graph_from_sorted, induced_edges,
                                      pyg_gcn_norm, sort_by_dst)
from sgformer_tpu_torch.train.logger import RunLogger
from sgformer_tpu_torch.train.optim import dual_weight_decay_adam
from sgformer_tpu_torch.train.trainer import (TrainConfig, _logsumexp, bce_on_host, bce_per_node,
                                              nll_per_node)


@dataclasses.dataclass(frozen=True)
class BatchTrainConfig(TrainConfig):
    """The JAX ``BatchTrainConfig`` without ``ladder_base``, ``use_pallas``
    and ``eval_device`` (see the module's docstring)."""

    batch_size: int = 10000
    eval_mode: str = "full"  # 'full' | 'batch' (streaming)


def build_subgraph_batch(edge_index, node_idx, num_nodes_total: int, *,
                         with_pyg_norm: bool = False) -> Graph:
    """The node-induced, relabelled, degree-normalised subgraph of
    ``node_idx``, built on ``edge_index``'s device (numpy input: the CPU).

    ``edge_index``: [2, E] int32 or int64 (src, dst) of the full graph;
    ``node_idx``: the batch's node ids. The edges are those with both ends
    in the batch, relabelled to their ends' places in ``node_idx`` and
    stably sorted by destination, the JAX function's edges in its order;
    their weights are ``gcn_norm_weights`` of the subgraph, in f64 then f32,
    and, with ``with_pyg_norm``, the PyG ``gcn_norm`` edges too. The graph
    is not taken as symmetric (the edge list need not be), so it carries the
    transposed CSRs that the gradient walks; every tensor, the hub plans
    included, is bitwise the same on the card and on the CPU."""
    if not isinstance(edge_index, torch.Tensor):
        edge_index = torch.from_numpy(np.asarray(edge_index))
    node_idx = torch.as_tensor(node_idx, device=edge_index.device).long()
    b = int(node_idx.numel())
    src, dst = sort_by_dst(*induced_edges(edge_index, node_idx, num_nodes_total))
    weight = gcn_norm_weights(src, dst, b)
    pyg = pyg_gcn_norm(src, dst, b) if with_pyg_norm else None
    return graph_from_sorted(src, dst, weight, b, symmetric=False, pyg=pyg)


@dataclasses.dataclass
class Batch:
    """One batch on the trainer's device: its node ids, subgraph, feature
    rows, labels ([b] int64, or [b, C] f32 for the BCE loss) and train mask
    ([b] f32)."""

    node_idx: torch.Tensor
    graph: Graph
    x: torch.Tensor
    label: torch.Tensor
    train_mask: torch.Tensor


class BatchTrainer:
    """Runs ``config.runs`` runs of the ``main-batch.py`` loop.

    Args:
      model: a model of the port whose ``forward(x, graph)`` gives [n, C]
        logits (:class:`sgformer_tpu_torch.SGFormer`).
      edge_index: [2, E] (src, dst) of the full graph, numpy or a tensor; it
        is kept as an int32 tensor on the device, as are ``x`` and the labels.
      x: [N, F] node features; label: [N, 1] int labels (or [N, C]
        multilabel for ``loss='bce'``).
      config: :class:`BatchTrainConfig`.
      eval_func: metric on (labels, logits) for the full-graph eval;
        ``METRICS[config.metric]`` by default.
      full_graph: ``preprocess_graph(...)`` of the full graph, which
        ``eval_mode='full'`` reads.
      with_pyg_norm: also build each batch's PyG ``gcn_norm`` edges (the
        ``gnn='gcn'`` backbone reads them).
      device: where training runs; "cuda" unless the caller asks for "cpu".

    After :meth:`fit`, ``final_state`` holds the last run's state dict and,
    when ``record_losses`` is set, ``train_losses`` its per-batch losses.

    The data-parallel trainer (:class:`~sgformer_tpu_torch.parallel.
    DPBatchTrainer`) overrides the hooks :meth:`dropout_seed`,
    :meth:`num_batches`, :meth:`batch_nodes`, :meth:`build_batch`,
    :meth:`train_step` and :meth:`evaluate`, and prints only where
    ``writes_logs`` is set.
    """

    writes_logs = True

    def __init__(self, model, edge_index, x, label, config: BatchTrainConfig,
                 eval_func: Optional[Callable] = None, full_graph: Optional[Graph] = None,
                 with_pyg_norm: bool = False, device="cuda"):
        if config.eval_mode not in ("full", "batch"):
            raise ValueError(f"eval_mode must be 'full' or 'batch', got {config.eval_mode!r}")
        self.device = resolve_device(device)
        self.config = config
        self.model = model.to(self.device)
        if not isinstance(edge_index, torch.Tensor):
            edge_index = torch.from_numpy(np.asarray(edge_index))
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, dtype=np.float32))
        self.x = x.to(self.device, torch.float32)
        self.num_nodes = int(self.x.shape[0])
        if self.num_nodes >= 2 ** 31:
            raise ValueError("build_subgraph_batch holds node ids in int32: at most 2^31 - 1 nodes")
        self.edge_index = edge_index.to(self.device, torch.int32).contiguous()
        label = np.asarray(label)
        self.label_np = label
        # flattened as the JAX trainer flattens it (its streaming counts and
        # valid loss read this)
        self.label = torch.as_tensor(label.reshape(-1).astype(np.int64), device=self.device)
        if config.loss == "bce":
            if label.ndim == 1 or label.shape[1] == 1:
                onehot = np.eye(int(label.max()) + 1, dtype=np.float32)[label.reshape(-1)]
            else:
                onehot = label.astype(np.float32)
            self.label_onehot = torch.as_tensor(onehot, device=self.device)
        self.eval_func = eval_func or METRICS[config.metric]
        self.full_graph = None if full_graph is None else full_graph.to(self.device)
        self.with_pyg_norm = with_pyg_norm
        # the one generator of every dropout mask
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.dropout_seed(config.seed))
        self.model.set_dropout_generator(self.generator)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.record_losses = False
        self.train_losses: list = []
        self.final_state: Optional[dict] = None

    # -- state ---------------------------------------------------------------

    def init_state(self, seed: int, state: Optional[dict] = None) -> torch.optim.Optimizer:
        """Draw the parameters from a CPU generator seeded ``seed`` (or load
        ``state``, a state dict of the model, afresh), reset or load the
        BatchNorm statistics with them, and make a fresh optimizer."""
        cfg = self.config
        if state is None:
            self.model.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            self.model.load_state_dict(state)
        self.optimizer = dual_weight_decay_adam(
            self.model, cfg.lr, cfg.trans_weight_decay, cfg.gnn_weight_decay)
        return self.optimizer

    def dropout_seed(self, seed: int) -> int:
        """The dropout generator's seed for ``seed``."""
        return seed

    # -- batches and steps -----------------------------------------------------

    def num_batches(self) -> int:
        """Batches of an epoch; the last holds the remainder."""
        b = self.config.batch_size
        return self.num_nodes // b + (self.num_nodes % b > 0)

    def batch_nodes(self, perm: torch.Tensor, i: int) -> torch.Tensor:
        """The node ids of batch ``i`` of the epoch's permutation ``perm``."""
        b = self.config.batch_size
        return perm[i * b:(i + 1) * b]

    def build_batch(self, node_idx, train_set: Optional[torch.Tensor] = None) -> Batch:
        """The batch of ``node_idx`` (a tensor or array of node ids); its
        train mask from ``train_set`` ([N] bool on the device; none when
        None)."""
        node_idx = torch.as_tensor(node_idx, device=self.device).long()
        graph = build_subgraph_batch(self.edge_index, node_idx, self.num_nodes,
                                     with_pyg_norm=self.with_pyg_norm)
        label = (self.label_onehot if self.config.loss == "bce" else self.label)[node_idx]
        if train_set is None:
            mask = torch.zeros(node_idx.numel(), device=self.device)
        else:
            mask = train_set[node_idx].float()
        return Batch(node_idx, graph, self.x[node_idx], label, mask)

    def loss(self, batch: Batch) -> torch.Tensor:
        """Forward in train mode (dropout from the trainer's generator,
        BatchNorm statistics updated) and the loss on the batch's train
        nodes."""
        self.model.train()
        out = self.model(batch.x, batch.graph)
        if self.config.loss == "bce":
            per = bce_per_node(out, batch.label)
        else:
            per = nll_per_node(out, batch.label)
        m = batch.train_mask
        return (per * m).sum() / m.sum().clamp(min=1.0)

    def train_step(self, batch: Batch) -> torch.Tensor:
        """One step on ``batch``: loss, backward, Adam. Returns the loss on
        the device, without waiting for it."""
        if self.optimizer is None:
            raise RuntimeError("call init_state(seed) before training")
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(batch)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def forward(self, batch: Batch) -> torch.Tensor:
        """[b, C] f32 logits of the batch in eval mode, without autograd."""
        self.model.eval()
        with torch.no_grad():
            return self.model(batch.x, batch.graph)

    # -- evaluation ------------------------------------------------------------

    def eval_logits_full(self) -> np.ndarray:
        """[N, C] logits of ``full_graph`` in eval mode on the trainer's
        device, copied to the host."""
        if self.full_graph is None:
            raise ValueError("full-graph eval needs full_graph=preprocess_graph(...)")
        self.model.eval()
        with torch.no_grad():
            return self.model(self.x, self.full_graph).cpu().numpy()

    def evaluate_full(self, out: np.ndarray, split_idx: dict) -> tuple:
        """(train, valid, test) metric and the valid loss, on the host: the
        metrics and, for the NLL loss, the valid NLL as the JAX trainer's
        ``_full_metrics`` computes them; for ``loss='bce'`` the valid BCE of
        the full-graph :class:`Trainer` (the JAX batch trainer takes an NLL
        of the flattened labels whatever the loss)."""
        res = []
        for split in ("train", "valid", "test"):
            idx = np.asarray(split_idx[split])
            res.append(self.eval_func(self.label_np[idx], out[idx]))
        vidx = np.asarray(split_idx["valid"])
        logits = out[vidx]
        if self.config.loss == "bce":
            res.append(bce_on_host(logits, self.label_onehot.cpu().numpy()[vidx]))
        else:
            logp = logits - _logsumexp(logits)
            label_flat = self.label_np.reshape(-1)
            res.append(float(-logp[np.arange(len(vidx)), label_flat[vidx]].mean()))
        return tuple(res)

    def evaluate_streaming(self, split_idx: dict, np_rng: np.random.Generator) -> dict:
        """The reference's ``evaluate_batch``: one random permutation of all
        nodes drawn from ``np_rng``, cut into batches of ``batch_size``; each
        batch's argmax against its labels, counted per split on the device.
        Returns each split's accuracy."""
        b = self.config.batch_size
        masks = {}
        for split in ("train", "valid", "test"):
            m = torch.zeros(self.num_nodes, dtype=torch.bool, device=self.device)
            m[torch.as_tensor(np.asarray(split_idx[split]), device=self.device).long()] = True
            masks[split] = m
        perm = torch.from_numpy(np_rng.permutation(self.num_nodes)).to(self.device)
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        total = dict.fromkeys(masks, zero)
        correct = dict.fromkeys(masks, zero)
        for i in range(0, self.num_nodes, b):
            batch = self.build_batch(perm[i:i + b])
            hit = self.forward(batch).argmax(dim=-1) == self.label[batch.node_idx]
            for split, m in masks.items():
                mb = m[batch.node_idx]
                total[split] = total[split] + mb.sum()
                correct[split] = correct[split] + (hit & mb).sum()
        return {s: int(correct[s]) / max(int(total[s]), 1) for s in masks}

    def evaluate(self, split_idx: dict, np_rng: np.random.Generator) -> tuple:
        """The logged result: ``eval_mode='batch'``'s accuracies (and a valid
        loss of 0), or the full-graph eval's metrics and valid loss."""
        if self.config.eval_mode == "batch":
            accs = self.evaluate_streaming(split_idx, np_rng)
            return (accs["train"], accs["valid"], accs["test"], 0.0)
        return self.evaluate_full(self.eval_logits_full(), split_idx)

    # -- main loop -------------------------------------------------------------

    def fit(self, split_idx_lst: list, np_rng: Optional[np.random.Generator] = None,
            init_state: Optional[dict] = None) -> RunLogger:
        """Train ``config.runs`` runs; returns the RunLogger.

        ``np_rng`` draws every permutation in the JAX trainer's order (each
        epoch's training permutation, then the streaming eval's), so both
        train on the same batches from the same seed; by default
        ``default_rng(config.seed)``. ``init_state``, a state dict of the
        model, is loaded afresh at the start of each run in place of the
        parameters drawn from ``config.seed + run``."""
        cfg = self.config
        logger = RunLogger(cfg.runs, mode=cfg.mode)
        if np_rng is None:
            np_rng = np.random.default_rng(cfg.seed)
        self.generator.manual_seed(self.dropout_seed(cfg.seed))
        for run in range(cfg.runs):
            split_idx = split_idx_lst[run % len(split_idx_lst)]
            train_set = torch.zeros(self.num_nodes, dtype=torch.bool, device=self.device)
            train_set[torch.as_tensor(np.asarray(split_idx["train"]),
                                      device=self.device).long()] = True
            self.init_state(cfg.seed + run, init_state)
            losses = []
            for epoch in range(cfg.epochs):
                perm = torch.from_numpy(np_rng.permutation(self.num_nodes)).to(self.device)
                for i in range(self.num_batches()):
                    loss = self.train_step(self.build_batch(self.batch_nodes(perm, i),
                                                            train_set))
                    if self.record_losses:
                        losses.append(loss)
                if epoch % cfg.eval_step == 0:
                    result = self.evaluate(split_idx, np_rng)
                    logger.add_result(run, result)
                    if (self.writes_logs and cfg.display_step > 0
                            and epoch % cfg.display_step == 0):
                        print(f"Epoch: {epoch:02d}, Loss: {float(loss):.4f}, "
                              f"Train: {100 * result[0]:.2f}%, "
                              f"Valid: {100 * result[1]:.2f}%, "
                              f"Test: {100 * result[2]:.2f}%")
            if self.writes_logs and cfg.display_step >= 0:
                logger.print_statistics(run)
            self.final_state = {k: v.detach().clone()
                                for k, v in self.model.state_dict().items()}
            if self.record_losses:
                self.train_losses = torch.stack(losses).cpu().tolist() if losses else []
        return logger
