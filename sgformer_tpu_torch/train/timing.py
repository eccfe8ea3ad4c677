"""Time and memory of full-graph training: the port of
``sgformer_tpu/train/timing.py``.

Trains a fixed number of epochs without evaluation or early stopping, then
times one forward without autograd. Times are host wall clock around work
that ends in ``torch.cuda.synchronize``; peak memory is
``torch.cuda.max_memory_allocated`` since a reset just before the timed
loop. ``trace_dir`` records the timed loop with ``torch.profiler`` and
writes ``trace.json`` (Chrome trace format) there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

import torch

from sgformer_tpu_torch.utils.memory import device_memory_stats


@dataclasses.dataclass
class TimeTestResult:
    total_train_s: float
    per_epoch_ms: float
    forward_ms: float
    edges_per_sec: float
    peak_memory_mb: Optional[float]  # None on the CPU
    device: str  # torch.cuda.get_device_name, or "cpu"
    losses: list  # every step's loss, warm-up steps first

    def as_dict(self):
        return dataclasses.asdict(self)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_test(trainer, split_idx: dict, *, epochs: int = 50, warmup: int = 3,
              trace_dir: Optional[str] = None) -> TimeTestResult:
    """Time ``epochs`` train steps of ``trainer`` (a full-graph Trainer)
    after ``warmup`` untimed ones, from parameters drawn anew from
    ``config.seed``, then one forward."""
    dev = trainer.device
    seed = trainer.config.seed
    trainer.init_state(seed)
    trainer.seed_dropout(seed)
    train_idx = trainer.prepare_train_idx(split_idx)
    losses = [trainer.train_step(train_idx) for _ in range(warmup)]
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    prof = None
    ctx = contextlib.nullcontext()
    if trace_dir is not None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        ctx = prof = profile(activities=activities)
    with ctx:
        t0 = time.perf_counter()
        for _ in range(epochs):
            losses.append(trainer.train_step(train_idx))
        _sync(dev)
        total = time.perf_counter() - t0
    if prof is not None:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

    trainer.eval_step()
    _sync(dev)
    t0 = time.perf_counter()
    trainer.eval_step()
    _sync(dev)
    fwd = time.perf_counter() - t0

    peak = device_memory_stats(dev).get("peak_bytes_in_use")
    num_edges = trainer.graph.num_edges
    return TimeTestResult(
        total_train_s=total,
        per_epoch_ms=1e3 * total / epochs,
        forward_ms=1e3 * fwd,
        edges_per_sec=num_edges * epochs / total,
        peak_memory_mb=None if peak is None else peak / 2**20,
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        losses=torch.stack(losses).tolist(),
    )
