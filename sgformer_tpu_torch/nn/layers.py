"""Shared building blocks: the port of ``sgformer_tpu/nn/layers.py``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sgformer_tpu_torch.device import resolve_device
from sgformer_tpu_torch.nn.norm import MaskedBatchNorm


def uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    """U(-bound, bound) of ``shape`` from ``generator`` (a CPU generator)."""
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def glorot_uniform(shape, generator: torch.Generator) -> torch.Tensor:
    """flax's ``glorot_uniform``: U(-b, b) with b = sqrt(6 / (fan_in +
    fan_out)), fan_in = shape[-2] and fan_out = shape[-1], each times the
    product of the other dimensions (so (1, H, D) gives fan_in H, fan_out
    D)."""
    receptive = math.prod(shape[:-2])
    return uniform(shape, math.sqrt(6.0 / ((shape[-2] + shape[-1]) * receptive)), generator)


class TorchLinear(nn.Module):
    """Dense layer with PyTorch's default ``nn.Linear`` initialisation,
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias, drawn from
    ``generator`` (or left for :meth:`GraphModel.reset_parameters` when it
    is None). The weight is stored [out, in] (the flax kernel is its
    transpose). Applied as ``x @ W + b`` in x's type, the product first and
    the bias added after, as the JAX layer does; the parameters stay f32."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        if bias:
            self.bias = nn.Parameter(torch.empty(out_features))
        else:
            self.register_parameter("bias", None)
        if generator is not None:
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw weight, then bias, from ``generator`` (a CPU generator; the
        draws are copied to the parameters' device)."""
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        for p in (self.weight, self.bias):
            if p is not None:
                p.copy_(uniform(p.shape, bound, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class LayerNorm(nn.LayerNorm):
    """LayerNorm with torch's eps=1e-5 that computes in f32 and returns the
    input's type, as the JAX branch does around its f32-parameter flax
    LayerNorm."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        ).to(x.dtype)


class Dropout(nn.Module):
    """Inverted dropout: the identity in eval mode; in train mode each
    element is kept with probability ``1 - rate`` and scaled by its inverse.
    The mask is drawn from ``generator``, which must be on x's device; a
    train-mode call that would draw a mask without one raises, so no mask
    comes from torch's global generator. The JAX package's masks come from
    JAX keys, so the two never give the same mask."""

    def __init__(self, rate: float, generator: torch.Generator | None = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if self.generator is None:
            raise RuntimeError(
                "Dropout in train mode needs an explicit torch.Generator "
                "(SGFormer(..., dropout_generator=...) or set_dropout_generator)"
            )
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, device=x.device, generator=self.generator) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class GraphModel(nn.Module):
    """What ``train.Trainer`` asks of every model of the port, written once:
    :meth:`set_dropout_generator` and :meth:`reset_parameters`.

    A model draws its parameters in the order :meth:`reset_parameters`
    walks its modules (the zoo builds its modules without drawing and then
    calls it once), so a model built from a generator seeded s equals one
    reset from a generator seeded s."""

    def set_dropout_generator(self, generator: torch.Generator | None) -> None:
        """Draw every dropout mask from ``generator`` from now on."""
        for mod in self.modules():
            if isinstance(mod, Dropout):
                mod.generator = generator

    def finish_init(self, generator: torch.Generator | None,
                    dropout_generator: torch.Generator | None, device) -> None:
        """The end of a zoo model's constructor: draw every parameter from
        ``generator`` (a new one seeded 0 when None), set the dropout
        generator and move to ``device`` ("cuda" unless the caller asks for
        the CPU)."""
        dev = resolve_device(device)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))
        self.set_dropout_generator(dropout_generator)
        self.to(dev)

    def reset_own_parameters(self, generator: torch.Generator) -> None:
        """Draw the parameters the model holds itself, outside any
        submodule (none here; ``LINK`` and ``GPRGNN`` have some)."""

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter again from ``generator`` (a CPU generator),
        module by module in registration order: a module that owns
        parameters has its own ``reset_parameters(generator)`` (``TorchLinear``
        and the layers with raw flax parameters), a model its
        :meth:`reset_own_parameters`; norms go back to scale 1, shift 0, and
        BatchNorm statistics to mean 0, variance 1."""
        for mod in self.modules():
            if isinstance(mod, GraphModel):
                # this model, or one nested in it: its submodules come next
                mod.reset_own_parameters(generator)
            elif isinstance(mod, (LayerNorm, MaskedBatchNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if isinstance(mod, MaskedBatchNorm):
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)
            elif hasattr(mod, "reset_parameters"):
                mod.reset_parameters(generator)
