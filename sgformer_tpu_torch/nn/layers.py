"""Shared building blocks: the port of ``sgformer_tpu/nn/layers.py``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class TorchLinear(nn.Module):
    """Dense layer with PyTorch's default ``nn.Linear`` initialisation,
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias, drawn from
    ``generator``. The weight is stored [out, in] (the flax kernel is its
    transpose). Applied as ``x @ W + b`` in x's type, the product first and
    the bias added after, as the JAX layer does; the parameters stay f32."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = True,
                 generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        if bias:
            self.bias = nn.Parameter(torch.empty(out_features))
        else:
            self.register_parameter("bias", None)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw weight, then bias, from ``generator`` (a CPU generator; the
        draws are copied to the parameters' device)."""
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        for p in (self.weight, self.bias):
            if p is not None:
                p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))

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
