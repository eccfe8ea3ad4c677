"""TransConv, the global attention branch of SGFormer: the port of
``sgformer_tpu/nn/transconv.py``.

``kernel`` selects the attention:

- ``"simple"``: SGFormer's O(N) linear attention, through the reduce and
  apply kernels on the card (the default);
- ``"softmax"``: full softmax attention, O(N^2);
- ``"gat"``: scaled dot-product attention, O(N^2);
- ``"performer"``: NodeFormer's positive-random-feature kernel, O(N*M).

The three ablations are the plain PyTorch of
:mod:`sgformer_tpu_torch.ops.attention_variants`, as the JAX package
computes them in XLA. Performer's projection is the buffer ``projection``
[2*D, D], drawn once from a CPU generator seeded 0: the counterpart of the
JAX layer's fixed ``PRNGKey(performer_seed)`` at its defaults (2*D
features, seed 0, which no caller changes), the same projection on every
call and in every run. It is no flax variable, so it is not in the state
dict; a test overwrites it with the JAX draw.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from sgformer_tpu_torch.kernels import attention as _attention_kernel
from sgformer_tpu_torch.nn.layers import Dropout, LayerNorm, TorchLinear
from sgformer_tpu_torch.ops import attention_variants as variants
from sgformer_tpu_torch.ops.attention import linear_attention

ATTENTION_KERNELS = ("simple", "softmax", "gat", "performer")


def _check_kernel(kernel: str, axis_name: str | None = None) -> None:
    if kernel not in ATTENTION_KERNELS:
        raise ValueError(f"unknown attention kernel: {kernel}")
    if axis_name is not None and kernel != "simple":
        raise ValueError(f"attention {kernel!r} cannot run node-sharded (axis_name): only "
                         f"'simple' reduces its node sums over the mesh axis")


class TransConvLayer(nn.Module):
    """Q/K/V projections, global attention, mean over heads."""

    def __init__(self, in_channels: int, out_channels: int, *, num_heads: int = 1,
                 use_weight: bool = True, kernel: str = "simple",
                 axis_name: str | None = None, generator: torch.Generator):
        super().__init__()
        _check_kernel(kernel, axis_name)
        self.axis_name = axis_name
        if not use_weight and num_heads != 1:
            raise ValueError("use_weight=False needs num_heads == 1")
        self.out_channels = out_channels
        self.num_heads = num_heads
        self.use_weight = use_weight
        hd = out_channels * num_heads
        self.Wq = TorchLinear(in_channels, hd, generator=generator)
        self.Wk = TorchLinear(in_channels, hd, generator=generator)
        self.Wv = TorchLinear(in_channels, hd, generator=generator) if use_weight else None
        self.kernel = kernel
        if kernel == "performer":
            proj = variants.create_projection_matrix(
                2 * out_channels, out_channels, torch.Generator().manual_seed(0))
            self.register_buffer("projection", proj, persistent=False)

    def forward(self, query_input, source_input, output_attn: bool = False,
                node_mask=None):
        h, d = self.num_heads, self.out_channels
        qs = self.Wq(query_input).reshape(-1, h, d)
        ks = self.Wk(source_input).reshape(-1, h, d)
        if self.use_weight:
            vs = self.Wv(source_input).reshape(-1, h, d)
        else:
            vs = source_input.reshape(-1, 1, d)
        if self.kernel == "simple":
            if output_attn:
                out, attn = linear_attention(qs, ks, vs, output_attn=True,
                                             node_mask=node_mask, axis_name=self.axis_name)
                return out.mean(dim=1), attn
            out = _attention_kernel.fused_linear_attention(qs, ks, vs, node_mask=node_mask,
                                                           axis_name=self.axis_name)
            return out.mean(dim=1)
        if self.kernel == "performer":
            if output_attn:
                raise ValueError("performer kernel has no dense attention map")
            return variants.performer_attention(qs, ks, vs,
                                                projection=self.projection).mean(dim=1)
        fn = variants.softmax_attention if self.kernel == "softmax" else variants.gat_attention
        if output_attn:
            out, attn = fn(qs, ks, vs, output_attn=True)
            return out.mean(dim=1), attn
        return fn(qs, ks, vs).mean(dim=1)


class TransConv(nn.Module):
    """Input MLP, then attention layers with residual, LayerNorm, activation
    and dropout.

    ``residual_mode``: ``"alpha"`` blends ``alpha*x + (1-alpha)*prev``
    (medium and 100M tiers); ``"mean"`` takes ``(x + prev)/2`` (large tier).
    ``remat`` recomputes each attention layer in the backward pass instead
    of keeping its activations, as the JAX module's ``nn.remat`` does; the
    layer holds no dropout, so the recompute draws nothing. ``axis_name``:
    the mesh axis of node-sharded training, over which the attention's node
    sums are all-reduced ('simple' only).
    """

    def __init__(self, in_channels: int, hidden_channels: int, *, num_layers: int = 2,
                 num_heads: int = 1, alpha: float = 0.5, dropout: float = 0.5,
                 use_bn: bool = True, use_residual: bool = True,
                 use_weight: bool = True, use_act: bool = False,
                 residual_mode: str = "alpha", kernel: str = "simple",
                 remat: bool = False, axis_name: str | None = None,
                 generator: torch.Generator):
        super().__init__()
        if residual_mode not in ("alpha", "mean"):
            raise ValueError(f"unknown residual_mode {residual_mode!r}")
        _check_kernel(kernel, axis_name)
        self.num_layers = num_layers
        self.alpha = alpha
        self.use_bn = use_bn
        self.use_residual = use_residual
        self.use_act = use_act
        self.residual_mode = residual_mode
        self.remat = remat
        self.dropout = Dropout(dropout)
        self.fc_in = TorchLinear(in_channels, hidden_channels, generator=generator)
        if use_bn:
            self.ln_in = LayerNorm(hidden_channels)
        for i in range(num_layers):
            self.add_module(f"conv_{i}", TransConvLayer(
                hidden_channels, hidden_channels, num_heads=num_heads,
                use_weight=use_weight, kernel=kernel, axis_name=axis_name,
                generator=generator,
            ))
            if use_bn:
                self.add_module(f"ln_{i}", LayerNorm(hidden_channels))

    def forward(self, x, output_attn: bool = False, node_mask=None):
        x = self.fc_in(x)
        if self.use_bn:
            x = self.ln_in(x)
        x = self.dropout(torch.relu(x))
        prev = x
        attns = []
        for i in range(self.num_layers):
            conv = getattr(self, f"conv_{i}")
            if output_attn:
                x, attn = conv(x, x, True, node_mask)
                attns.append(attn)
            elif self.remat and torch.is_grad_enabled():
                x = checkpoint(conv, x, x, False, node_mask,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = conv(x, x, False, node_mask)
            if self.use_residual:
                if self.residual_mode == "alpha":
                    x = self.alpha * x + (1.0 - self.alpha) * prev
                else:
                    x = (x + prev) / 2.0
            if self.use_bn:
                x = getattr(self, f"ln_{i}")(x)
            if self.use_act:
                x = torch.relu(x)
            x = self.dropout(x)
            prev = x
        if output_attn:
            return x, torch.stack(attns, dim=0)  # [L, N, N]
        return x
