"""Full-graph trainer: the port of ``sgformer_tpu/train/trainer.py``.

One train step is a forward of both branches in train mode, the masked
full-N loss on the train nodes, the backward (the backward attention kernels
and the SpMM on A^T on the card), an Adam step with a weight decay for each
branch, and the BatchNorm statistics updated by the forward. The model's
parameters and statistics are the state; the optimizer holds the moments.

Every random number comes from an explicit generator: parameters from a CPU
generator seeded per run (``config.seed + run``), dropout masks from the
trainer's one device generator, seeded from ``config.seed``.

A graph with a clustering reorder (``preprocess_graph(reorder=True)``,
``Graph.node_perm``) trains in its own node order: the trainer permutes x
and the labels into it and maps the train split through the inverse, as the
JAX trainer does; ``eval_step`` returns the logits in the caller's node
order, so the splits and labels of :meth:`Trainer.evaluate` stay the
caller's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sgformer_tpu_torch.data.metrics import METRICS
from sgformer_tpu_torch.device import resolve_device
from sgformer_tpu_torch.graph import NodeOrder
from sgformer_tpu_torch.train.logger import RunLogger
from sgformer_tpu_torch.train.optim import dual_weight_decay_adam
from sgformer_tpu_torch.utils.rng import train_generator


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 0.01
    trans_weight_decay: float = 1e-3
    gnn_weight_decay: float = 1e-3
    epochs: int = 100
    eval_step: int = 1
    patience: int = 0  # early stop on the valid metric; 0 = off
    metric: str = "acc"
    mode: str = "max_acc"
    loss: str = "nll"  # 'nll' (log_softmax + NLL) | 'bce' (BCE with logits)
    runs: int = 1
    seed: int = 123
    display_step: int = -1  # print every k epochs; -1 = silent
    # weight of the edge-regularisation losses of a model that returns
    # (logits, link_losses) (NodeFormer): the loss subtracts lamda times
    # their mean
    lamda: float = 1.0
    # the JAX package's choice of PRNG bit generator (utils/rng.py): torch
    # has one generator family a device, so it is accepted and ignored and
    # every value draws the same numbers (utils.rng.train_generator)
    rng_impl: str = "auto"


def _train_mask(n: int, idx: torch.Tensor) -> torch.Tensor:
    mask = torch.zeros(n, dtype=torch.float32, device=idx.device)
    mask[idx] = 1.0
    return mask


def nll_per_node(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """[N] f32 -log_softmax(logits)[i, labels[i]]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels[:, None]).squeeze(1)


def bce_per_node(logits: torch.Tensor, labels_onehot: torch.Tensor) -> torch.Tensor:
    """[N] f32 binary cross-entropy with logits, averaged over classes."""
    z = logits.float()
    lab = labels_onehot.float()
    return (-lab * F.logsigmoid(z) - (1.0 - lab) * F.logsigmoid(-z)).mean(dim=-1)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """log_softmax + NLL on the nodes ``idx``, in f32, as a masked full-N
    sum divided by the number of indices (the JAX package's form)."""
    nll = nll_per_node(logits, labels)
    return (nll * _train_mask(logits.shape[0], idx)).sum() / idx.shape[0]


def bce_loss(logits: torch.Tensor, labels_onehot: torch.Tensor,
             idx: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy with logits, averaged over classes, on the nodes
    ``idx``, in f32; the masked full-N form of :func:`cross_entropy_loss`."""
    per = bce_per_node(logits, labels_onehot)
    return (per * _train_mask(logits.shape[0], idx)).sum() / idx.shape[0]


class Trainer:
    """Runs ``config.runs`` training runs of (reset parameters, epoch loop,
    evaluation and model selection).

    Args:
      model: :class:`sgformer_tpu_torch.SGFormer` or a zoo model; its
        ``forward(x, graph)`` returns [N, C] logits, or (logits,
        link_losses) (NodeFormer).
      graph: :class:`sgformer_tpu_torch.graph.Graph` from ``preprocess_graph``.
      x: [N, F] node features (numpy array or tensor).
      label: [N, 1] int labels (or [N, C] multilabel for ``loss='bce'``).
      config: :class:`TrainConfig`.
      eval_func: metric on (labels, logits); ``METRICS[config.metric]`` by
        default.
      model_kwargs: extra keyword arguments of every forward (the train
        step, the eval and ``time_test``), as the JAX ``Trainer`` takes
        them: ``H2GCN``'s ``h2_graphs``, ``NodeFormer``'s ``adjs`` and
        ``Graphormer``'s ``inputs``, on ``device``.
      device: where training runs; "cuda" unless the caller asks for "cpu".
    """

    def __init__(self, model, graph, x, label, config: TrainConfig,
                 eval_func: Optional[Callable] = None, model_kwargs: Optional[dict] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.model = model.to(self.device)
        self.model_kwargs = model_kwargs or {}
        self.eval_func = eval_func or METRICS[config.metric]
        # the caller's labels, which evaluate() reads, and the graph's order
        self.label_np = np.asarray(label)
        self.order = NodeOrder(graph.node_perm, self.device)
        self.graph = self.place_graph(graph)
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, dtype=np.float32))
        self.x = self.place_rows(self.order.to_graph(x).to(torch.float32))
        label = self.order.to_graph(self.label_np)
        if config.loss == "bce":
            self.label_onehot = self.place_rows(torch.as_tensor(onehot(label),
                                                                dtype=torch.float32))
        self.label = self.place_rows(torch.as_tensor(label.reshape(-1).astype(np.int64)))
        # the one generator of every dropout mask
        self.generator = train_generator(self.dropout_seed(config.seed), config.rng_impl,
                                         self.device)
        self.model.set_dropout_generator(self.generator)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.final_state: Optional[dict] = None

    # -- placement (a node-sharded trainer overrides these) ------------------

    # whether this process prints the progress lines and statistics (in a
    # node-sharded group only rank 0 does)
    writes_logs = True

    def place_graph(self, graph):
        """The graph the steps run on: ``graph`` on the device."""
        return graph.to(self.device)

    def place_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Node-indexed rows, in the graph's order, as the steps read them:
        all of them, on the device."""
        return rows.to(self.device)

    def dropout_seed(self, seed: int) -> int:
        """The dropout generator's seed for ``seed``."""
        return seed

    def reduce_gradients(self) -> None:
        """Between the backward and the optimizer step: nothing here."""

    def seed_dropout(self, seed: int) -> None:
        """Seed the dropout generator for a run."""
        self.generator.manual_seed(self.dropout_seed(seed))

    # -- state -------------------------------------------------------------

    def init_state(self, seed: int) -> torch.optim.Optimizer:
        """Draw the parameters again from a CPU generator seeded ``seed``,
        reset the BatchNorm statistics and make a fresh optimizer."""
        cfg = self.config
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.optimizer = dual_weight_decay_adam(
            self.model, cfg.lr, cfg.trans_weight_decay, cfg.gnn_weight_decay
        )
        return self.optimizer

    def prepare_train_idx(self, split_idx: dict) -> torch.Tensor:
        """The train split's node ids, in the graph's order, as a device
        tensor."""
        return torch.as_tensor(self.order.graph_ids(split_idx["train"]), device=self.device)

    # -- steps ---------------------------------------------------------------

    def loss(self, train_idx: torch.Tensor) -> torch.Tensor:
        """Forward in train mode (dropout from the trainer's generator,
        BatchNorm statistics updated) and the loss on ``train_idx``; a model
        that returns (logits, link_losses) has ``lamda`` times the mean of
        its link losses subtracted."""
        self.model.train()
        out = self.model(self.x, self.graph, **self.model_kwargs)
        link_losses = None
        if isinstance(out, tuple):
            out, link_losses = out
        if self.config.loss == "bce":
            loss = bce_loss(out, self.label_onehot, train_idx)
        else:
            loss = cross_entropy_loss(out, self.label, train_idx)
        if link_losses:
            loss = loss - self.config.lamda * sum(link_losses) / len(link_losses)
        return loss

    def train_step(self, train_idx: torch.Tensor) -> torch.Tensor:
        """One step: loss, backward, Adam. Returns the loss on the device,
        without waiting for it."""
        if self.optimizer is None:
            raise RuntimeError("call init_state(seed) before training")
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(train_idx)
        loss.backward()
        self.reduce_gradients()
        self.optimizer.step()
        return loss.detach()

    def multi_step(self, train_idx: torch.Tensor, k: int) -> torch.Tensor:
        """``k`` train steps; the losses stay on the device as one [k]
        tensor, so the caller syncs once per block."""
        return torch.stack([self.train_step(train_idx) for _ in range(k)])

    def eval_step(self) -> torch.Tensor:
        """[N, C] f32 logits in eval mode, without autograd, in the caller's
        node order."""
        self.model.eval()
        with torch.no_grad():
            out = self.model(self.x, self.graph, **self.model_kwargs)
        return self.order.to_caller(out[0] if isinstance(out, tuple) else out)

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, out: np.ndarray, split_idx: dict) -> tuple:
        """(train, valid, test) metric and the valid loss, on the host."""
        res = []
        for split in ("train", "valid", "test"):
            idx = np.asarray(split_idx[split])
            res.append(self.eval_func(self.label_np[idx], out[idx]))
        vidx = np.asarray(split_idx["valid"])
        logits = out[vidx]
        if self.config.loss == "bce":
            vloss = bce_on_host(logits, onehot(self.label_np)[vidx])
        else:
            logp = logits - _logsumexp(logits)
            vloss = float(-logp[np.arange(len(vidx)), self.label_np[vidx].reshape(-1)].mean())
        res.append(vloss)
        return tuple(res)

    # -- main loop -----------------------------------------------------------

    def fit(self, split_idx_lst: list[dict]) -> RunLogger:
        """Run ``config.runs`` training runs; returns the RunLogger.

        Between evaluations (``eval_step`` > 1) the epochs run as one block
        of train steps whose losses are read once, after the block."""
        cfg = self.config
        logger = RunLogger(cfg.runs, mode=cfg.mode)
        self.seed_dropout(cfg.seed)
        for run in range(cfg.runs):
            split_idx = split_idx_lst[run % len(split_idx_lst)]
            train_idx = self.prepare_train_idx(split_idx)
            self.init_state(cfg.seed + run)
            best_val = float("-inf")
            patience_ctr = 0
            epoch = 0
            while epoch < cfg.epochs:
                k = 1
                if cfg.eval_step > 1 and epoch % cfg.eval_step != 0:
                    next_eval = -(-epoch // cfg.eval_step) * cfg.eval_step
                    k = min(next_eval, cfg.epochs - 1) - epoch + 1
                loss = self.multi_step(train_idx, k)[-1]
                epoch += k
                if (epoch - 1) % cfg.eval_step == 0:
                    out = self.eval_step().cpu().numpy()
                    result = self.evaluate(out, split_idx)
                    logger.add_result(run, result)
                    if (self.writes_logs and cfg.display_step > 0
                            and (epoch - 1) % cfg.display_step == 0):
                        print(
                            f"Epoch: {epoch - 1:02d}, "
                            f"Loss: {float(loss):.4f}, "
                            f"Train: {100 * result[0]:.2f}%, "
                            f"Valid: {100 * result[1]:.2f}%, "
                            f"Test: {100 * result[2]:.2f}%"
                        )
                    if cfg.patience > 0:
                        if result[1] > best_val:
                            best_val = result[1]
                            patience_ctr = 0
                        else:
                            patience_ctr += 1
                            if patience_ctr >= cfg.patience:
                                break
            if self.writes_logs and cfg.display_step >= 0:
                logger.print_statistics(run)
            # the last run's final parameters and statistics
            self.final_state = {k: v.detach().clone()
                                for k, v in self.model.state_dict().items()}
        return logger


def onehot(label: np.ndarray) -> np.ndarray:
    """The f32 BCE targets of ``label``: one-hot rows of [N, 1] class ids,
    or the [N, C] multilabel array itself."""
    label = np.asarray(label)
    if label.shape[1] == 1:
        return np.eye(int(label.max()) + 1, dtype=np.float32)[label.reshape(-1)]
    return label.astype(np.float32)


def bce_on_host(logits: np.ndarray, labels_onehot: np.ndarray) -> float:
    """The valid loss of ``loss='bce'``: the mean binary cross-entropy of
    the logits (clipped to [-30, 30]) against one-hot or multilabel targets,
    in numpy."""
    z = np.clip(logits, -30, 30)
    return float(np.mean(np.maximum(z, 0) - z * labels_onehot + np.log1p(np.exp(-np.abs(z)))))


def _logsumexp(x):
    m = x.max(axis=-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=-1, keepdims=True))
