"""Neighbour-sampled trainer, papers100M's mode: the port of
``sgformer_tpu/train/sampled_trainer.py`` (the SGFormer reference's
``100M/nb-sample.py`` loop).

What it computes, as the JAX package does:

- train, valid and test each sweep their own seeds in batches of
  ``batch_size`` (the train seeds shuffled every epoch); each batch is the
  seeds' sampled neighbourhood (:class:`sgformer_tpu_torch.sample.
  NeighborSampler`, fanouts per hop), seeds first;
- the loss is the NLL of the seed rows only, ``sum(per[:num_seeds]) /
  num_seeds``: the epoch's remainder batch trains its true seed count;
- each epoch ends with a streaming accuracy (the argmax of the seed rows)
  over the valid and test seeds (the train seeds too with ``eval_train``),
  best-on-valid selection, and at the end of a run the best state saved with
  ``save_model``; ``use_pretrained`` restores the saved parameters at the
  start of a run and keeps the freshly initialised BatchNorm statistics, as
  the JAX trainer does;
- before the parameters are drawn, the JAX trainer samples one batch of the
  first train seeds to trace its model's ``init``; this trainer draws that
  batch too, so that both take the same batches from the same generator.

How it runs. The host samples through the C++ sampler, the JAX trainer's
default (bitwise its batches and f32 GCN weights; the hop path, the JAX
trainer's ``use_native=False``, with ``trainer.sampler.use_native = False``), in a prefetch thread that also
gathers the batch's feature rows, casts them as ``transfer_dtype`` asks and
pins them; ``sampler_workers`` threads sample batches side by side under it,
as in the JAX trainer, in the train loop and the eval sweeps alike. Each
batch's graph is built on the card (:func:`build_sampled_graph`: the row
pointers, the transposed CSR the gradient walks and both hub plans).

Where it differs, and why. The JAX trainer pads every batch to static node
and edge caps for XLA, caps that also truncate large batches; this one runs
each batch at its real size (see ``sample/neighbor.py``), so ``node_cap``,
``edge_cap`` and the ``node_mask`` have no counterpart.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from sgformer_tpu_torch.data.feature_store import FeatureStore
from sgformer_tpu_torch.device import resolve_device
from sgformer_tpu_torch.graph import Graph, gcn_norm_weights, graph_from_sorted
from sgformer_tpu_torch.sample.neighbor import NeighborSampler, PrefetchIterator, SampledBatch
from sgformer_tpu_torch.train.checkpoint import read_state, save_state
from sgformer_tpu_torch.train.logger import RunLogger
from sgformer_tpu_torch.train.optim import dual_weight_decay_adam
from sgformer_tpu_torch.train.trainer import TrainConfig, nll_per_node

_TRANSFER = {"f32": torch.float32, "bf16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class SampledTrainConfig(TrainConfig):
    """The JAX ``SampledTrainConfig`` without ``node_cap`` and ``edge_cap``
    (batches run uncapped, at their real size)."""

    batch_size: int = 1000
    fanouts: tuple = (15, 10, 5)
    save_model: bool = False
    # the best-on-valid state is saved as model_dir/model.pt
    model_dir: str = "models/ckpt"
    use_pretrained: bool = False
    prefetch_depth: int = 2
    # threads that sample batches side by side (the C++ sampler releases the
    # GIL; PyG's num_workers, nb-sample.py:131); 0 samples in the prefetch
    # thread
    sampler_workers: int = 0
    # sweep the train seeds each epoch too (the reference's 100M loop does
    # not: train accuracy is recorded as 0.0)
    eval_train: bool = False
    # type of the feature rows sent to the card: 'auto' is bf16 when the
    # model computes in bf16 (it casts x at entry, so the host cast gives
    # the same values at half the bytes), else f32; or 'f32' / 'bf16'
    transfer_dtype: str = "auto"


def build_sampled_graph(batch: SampledBatch, device) -> Graph:
    """The :class:`Graph` of a sampled batch on ``device``: its dst-sorted
    local edges, their GCN weights (the C++ sampler's ``edge_weight``, which
    the JAX trainer trains on, else ``gcn_norm_weights`` computed there) and
    the CSRs built there. Sampled edges run child -> parent, so the graph is
    not symmetric and carries the transposed CSR (and its hub plan: a source
    sampled by many parents is a long row of A^T) that the gradient walks.
    Bitwise the same on every device."""
    dev = resolve_device(device)
    src = torch.from_numpy(batch.edge_src).to(dev)
    dst = torch.from_numpy(batch.edge_dst).to(dev)
    if batch.edge_weight is not None:
        weight = torch.from_numpy(batch.edge_weight).to(dev)
    else:
        weight = gcn_norm_weights(src, dst, batch.num_nodes)
    return graph_from_sorted(src, dst, weight, batch.num_nodes, symmetric=False)


@dataclasses.dataclass
class DeviceBatch:
    """One sampled batch on the trainer's device: its graph, its feature rows
    ([n, F] in the transfer type) and its seeds' labels ([num_seeds]
    int64)."""

    graph: Graph
    x: torch.Tensor
    label: torch.Tensor
    num_seeds: int


class SampledTrainer:
    """Runs ``config.runs`` runs of the ``nb-sample.py`` loop.

    Args:
      model: a model of the port whose ``forward(x, graph)`` gives [n, C]
        logits (:class:`sgformer_tpu_torch.SGFormer`).
      edge_index: the full graph as a [2, E] (src, dst) edge list (numpy, or
        a tensor, whose CSR is sorted on its device) or a prebuilt
        :class:`sgformer_tpu_torch.sample.CSRGraph` (``data.prep.load_csr``).
        The CSR stays on the host, where the sampler reads it.
      x: [N, F] node features: an array or tensor (kept on the host as f32)
        or a :class:`sgformer_tpu_torch.data.feature_store.FeatureStore`.
      label: [N] or [N, 1] int labels.
      config: :class:`SampledTrainConfig`.
      device: where training runs; "cuda" unless the caller asks for "cpu".

    After :meth:`fit`, ``best_state`` holds the best-on-valid state dict,
    ``final_state`` the last one and, when ``record_losses`` is set,
    ``train_losses`` the last run's per-batch losses.
    """

    def __init__(self, model, edge_index, x, label, config: SampledTrainConfig, device="cuda"):
        want = config.transfer_dtype
        if want == "auto":
            want = getattr(getattr(model, "config", None), "compute_dtype", "f32")
        if want not in _TRANSFER:
            raise ValueError(f"transfer_dtype must be 'auto', 'f32' or 'bf16', got {want!r}")
        self.device = resolve_device(device)
        self.config = config
        self.model = model.to(self.device)
        if isinstance(x, FeatureStore):
            self.x = x
        elif isinstance(x, torch.Tensor):
            self.x = x.detach().to("cpu", torch.float32)
        else:
            self.x = torch.from_numpy(np.asarray(x, dtype=np.float32))
        self.transfer_dtype = _TRANSFER[want]
        self.num_nodes = int(self.x.shape[0])
        self.label = np.asarray(label).reshape(-1).astype(np.int64)
        self.sampler = NeighborSampler(edge_index, self.num_nodes, config.fanouts,
                                       config.batch_size, seed=config.seed)
        # the one generator of every dropout mask
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.model.set_dropout_generator(self.generator)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.record_losses = False
        self.train_losses: list = []
        self.best_state: Optional[dict] = None
        self.final_state: Optional[dict] = None

    @property
    def checkpoint_path(self) -> str:
        return os.path.join(self.config.model_dir, "model.pt")

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

    def restore_parameters(self) -> None:
        """Copy the saved checkpoint's parameters into the model; its
        statistics (BatchNorm's running mean and variance) stay as they
        are."""
        saved = read_state(self.checkpoint_path)
        params = dict(self.model.named_parameters())
        missing = sorted(params.keys() - saved.keys())
        if missing:
            raise KeyError(f"{self.checkpoint_path} lacks the parameters {missing}")
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(saved[name])

    # -- batches -------------------------------------------------------------

    def gather_x(self, node_ids: np.ndarray) -> torch.Tensor:
        """The batch's feature rows on the host in the transfer type, pinned
        when the trainer runs on the card."""
        if isinstance(self.x, FeatureStore):
            rows = self.x[node_ids]
        else:
            rows = self.x.index_select(0, torch.from_numpy(node_ids))
        rows = rows.to(self.transfer_dtype)
        return rows.pin_memory() if self.device.type == "cuda" else rows

    def prepared_epoch(self, seeds, *, shuffle: bool = True,
                       workers: Optional[int] = None) -> PrefetchIterator:
        """``(batch, x_rows)`` of each batch of ``seeds``, sampled (by
        ``workers`` threads, by default ``config.sampler_workers``) and
        gathered ahead of the card in a prefetch thread."""
        if workers is None:
            workers = self.config.sampler_workers

        def produce():
            for batch in self.sampler.epoch(seeds, shuffle=shuffle, workers=workers):
                yield batch, self.gather_x(batch.node_ids)

        return PrefetchIterator(produce(), depth=self.config.prefetch_depth)

    def to_device(self, batch: SampledBatch, x_rows: torch.Tensor) -> DeviceBatch:
        """The batch on the trainer's device, its graph built there."""
        label = torch.from_numpy(self.label[batch.node_ids[:batch.num_seeds]])
        return DeviceBatch(build_sampled_graph(batch, self.device),
                           x_rows.to(self.device, non_blocking=True), label.to(self.device),
                           batch.num_seeds)

    # -- steps -----------------------------------------------------------------

    def loss(self, batch: DeviceBatch) -> torch.Tensor:
        """Forward in train mode (dropout from the trainer's generator,
        BatchNorm statistics updated) and the mean NLL of the seed rows."""
        self.model.train()
        out = self.model(batch.x, batch.graph)
        return nll_per_node(out[:batch.num_seeds], batch.label).sum() / batch.num_seeds

    def train_step(self, batch: DeviceBatch) -> torch.Tensor:
        """One step on ``batch``: loss, backward, Adam. Returns the loss on
        the device, without waiting for it."""
        if self.optimizer is None:
            raise RuntimeError("call init_state(seed) before training")
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(batch)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def forward(self, batch: DeviceBatch) -> torch.Tensor:
        """[n, C] f32 logits of the batch in eval mode, without autograd."""
        self.model.eval()
        with torch.no_grad():
            return self.model(batch.x, batch.graph)

    def accuracy(self, seeds) -> float:
        """Streaming accuracy over ``seeds`` in order: the argmax of each
        batch's seed rows against their labels, counted on the device."""
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        total = 0
        with self.prepared_epoch(seeds, shuffle=False) as batches:
            for batch, x_rows in batches:
                b = self.to_device(batch, x_rows)
                correct += (self.forward(b)[:b.num_seeds].argmax(dim=-1) == b.label).sum()
                total += b.num_seeds
        return int(correct) / max(total, 1)

    # -- main loop -------------------------------------------------------------

    def fit(self, split_idx_lst: list, np_rng: Optional[np.random.Generator] = None,
            init_state: Optional[dict] = None) -> RunLogger:
        """Train ``config.runs`` runs; returns the RunLogger.

        ``np_rng`` replaces the sampler's generator (by default
        ``default_rng(config.seed)``, drawn since the trainer was made): it
        draws every sample and permutation in the JAX trainer's order.
        ``init_state``, a state dict of the model, is loaded afresh at the
        start of each run in place of the parameters drawn from
        ``config.seed + run``."""
        cfg = self.config
        logger = RunLogger(cfg.runs, mode=cfg.mode)
        if np_rng is not None:
            self.sampler.rng = np_rng
        self.generator.manual_seed(cfg.seed)
        best_state = None
        for run in range(cfg.runs):
            split_idx = split_idx_lst[run % len(split_idx_lst)]
            train_seeds = np.asarray(split_idx["train"])
            # the batch the JAX trainer samples to trace its init
            self.sampler.sample(train_seeds[:cfg.batch_size])
            self.init_state(cfg.seed + run, init_state)
            if cfg.use_pretrained:
                self.restore_parameters()
            best_val, losses = -1.0, []
            loss = torch.zeros(())
            for epoch in range(cfg.epochs):
                with self.prepared_epoch(train_seeds, shuffle=True) as batches:
                    for batch, x_rows in batches:
                        loss = self.train_step(self.to_device(batch, x_rows))
                        if self.record_losses:
                            losses.append(loss)
                splits = ("train", "valid", "test") if cfg.eval_train else ("valid", "test")
                accs = {s: self.accuracy(np.asarray(split_idx[s])) for s in splits}
                accs.setdefault("train", 0.0)
                logger.add_result(run, (accs["train"], accs["valid"], accs["test"], 0.0))
                if accs["valid"] > best_val:
                    best_val = accs["valid"]
                    best_state = {k: v.detach().clone()
                                  for k, v in self.model.state_dict().items()}
                if cfg.display_step > 0 and epoch % cfg.display_step == 0:
                    print(f"Epoch {epoch:02d} loss {float(loss):.4f} train {accs['train']:.4f} "
                          f"valid {accs['valid']:.4f} test {accs['test']:.4f}")
            if cfg.save_model and best_state is not None:
                save_state(self.checkpoint_path, best_state, cfg.epochs)
            if cfg.display_step >= 0:
                logger.print_statistics(run)
            self.final_state = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
            if self.record_losses:
                self.train_losses = torch.stack(losses).cpu().tolist() if losses else []
        self.best_state = best_state
        return logger

