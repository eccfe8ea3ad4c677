"""Checkpoints of a training run: the port of
``sgformer_tpu/train/checkpoint.py`` (orbax there, ``torch.save`` here).

A checkpoint holds the model's parameters and statistics, the optimizer's
state and the step, and optionally the state of the dropout generator, so
an interrupted run resumes exactly; :func:`save_state` writes a model state
alone (the sampled trainer's best-on-valid state, as the JAX sampled trainer
saves its ``best_state``). It is read back with
``torch.load(weights_only=True)``, which unpickles tensors and plain
containers only.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn


def save_checkpoint(path: str, model: nn.Module, optimizer: torch.optim.Optimizer,
                    step: int, generator: Optional[torch.Generator] = None) -> None:
    """Write {model, optimizer, step[, generator]} to ``path``."""
    payload = {
        "model": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "step": int(step),
    }
    if generator is not None:
        payload["generator"] = generator.get_state()
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    torch.save(payload, path)


def load_checkpoint(path: str, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    generator: Optional[torch.Generator] = None) -> int:
    """Restore ``model`` (and ``optimizer``, ``generator`` when given) in
    place from ``path``; returns the saved step. Tensors are read onto the
    CPU and copied to where the model's and the optimizer's live."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"])
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])
    if generator is not None:
        if "generator" not in payload:
            raise KeyError(f"{path} holds no generator state")
        generator.set_state(payload["generator"])
    return payload["step"]


def save_state(path: str, state: dict, step: int) -> None:
    """Write a model state dict alone, {model, step}, to ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"model": state, "step": int(step)}, path)


def read_state(path: str) -> dict:
    """The model state dict of a checkpoint, its tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)["model"]
