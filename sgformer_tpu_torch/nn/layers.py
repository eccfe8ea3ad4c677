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


class Draws(nn.Module):
    """A module that draws random numbers in train mode (dropout masks,
    NodeFormer's projections and Gumbel noise, Graphormer's layer drop and
    quantisation noise) from ``generator``, a ``torch.Generator`` on the
    model's device that :meth:`GraphModel.set_dropout_generator` sets. A
    draw without one raises, so no draw comes from torch's global
    generator. The JAX package draws from JAX keys, so the two never draw
    the same numbers."""

    generator: torch.Generator | None = None

    def draw_generator(self) -> torch.Generator:
        if self.generator is None:
            raise RuntimeError(
                f"{type(self).__name__} in train mode needs an explicit torch.Generator "
                "(SGFormer(..., dropout_generator=...) or set_dropout_generator)"
            )
        return self.generator


class Dropout(Draws):
    """Inverted dropout: the identity in eval mode; in train mode each
    element is kept with probability ``1 - rate`` and scaled by its inverse.
    The mask is drawn from ``generator``, which must be on x's device."""

    def __init__(self, rate: float, generator: torch.Generator | None = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, device=x.device, generator=self.draw_generator()) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Embed(nn.Embedding):
    """flax ``nn.Embed``: a [num, features] table drawn N(0, 1/features)
    (flax's default embedding init) from a CPU generator (nn.Embedding's
    own init, without one, draws nothing: the model's reset draws it)."""

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        if generator is not None:
            self.weight.copy_(torch.randn(self.weight.shape, generator=generator)
                              / math.sqrt(self.weight.shape[1]))


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral`` as ``MultiHeadDotProductAttention`` uses it,
    with its parameters in the flax layout: ``kernel`` [*in_shape,
    *out_shape] and ``bias`` [*out_shape], the kernel drawn from flax's
    ``lecun_normal`` (a normal truncated at two deviations, fan-in the
    product of ``in_shape``) and the bias 0. Contracts x's last
    ``len(in_shape)`` axes."""

    FLAX_PARAMS = ("kernel", "bias")

    def __init__(self, in_shape: tuple, out_shape: tuple):
        super().__init__()
        self.n_in = len(in_shape)
        self.kernel = nn.Parameter(torch.empty(*in_shape, *out_shape))
        self.bias = nn.Parameter(torch.empty(*out_shape))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = math.prod(self.kernel.shape[: self.n_in])
        # flax's variance_scaling: the truncated normal's deviation corrected
        # to the target's
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        self.kernel.copy_(nn.init.trunc_normal_(torch.empty(self.kernel.shape), std=std,
                                                a=-2.0 * std, b=2.0 * std, generator=generator))
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_shape = self.kernel.shape[self.n_in:]
        in_size = math.prod(self.kernel.shape[: self.n_in])
        k = self.kernel.to(x.dtype).reshape(in_size, -1)
        y = torch.einsum("...i,io->...o", x.reshape(*x.shape[: x.ndim - self.n_in], in_size), k)
        return y.reshape(*y.shape[:-1], *out_shape) + self.bias.to(y.dtype)


class GraphModel(nn.Module):
    """What ``train.Trainer`` asks of every model of the port, written once:
    :meth:`set_dropout_generator` and :meth:`reset_parameters`.

    A model draws its parameters in the order :meth:`reset_parameters`
    walks its modules (the zoo builds its modules without drawing and then
    calls it once), so a model built from a generator seeded s equals one
    reset from a generator seeded s."""

    def set_dropout_generator(self, generator: torch.Generator | None) -> None:
        """Draw every dropout mask and every other train-mode draw (each
        :class:`Draws` module's) from ``generator`` from now on."""
        for mod in self.modules():
            if isinstance(mod, Draws):
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
