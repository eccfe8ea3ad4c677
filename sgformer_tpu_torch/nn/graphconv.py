"""GraphConv, the shallow GCN branch of the large and 100M tiers: the port of
``sgformer_tpu/nn/graphconv.py``. The aggregation is
:meth:`sgformer_tpu_torch.graph.Graph.propagate`, the CSR SpMM kernel on the
card (on a node shard, :meth:`sgformer_tpu_torch.parallel.ShardGraph.
propagate`, with ``axis_name`` set for the BatchNorm statistics)."""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from sgformer_tpu_torch.nn.layers import Dropout, TorchLinear
from sgformer_tpu_torch.nn.norm import MaskedBatchNorm


class GraphConvLayer(nn.Module):
    """SpMM aggregation, then a Linear on it (or on it beside the initial
    features, with ``use_init``)."""

    def __init__(self, in_channels: int, out_channels: int, *, use_weight: bool = True,
                 use_init: bool = False, generator: torch.Generator):
        super().__init__()
        self.use_init = use_init
        self.use_weight = use_weight
        if use_init:
            self.W = TorchLinear(2 * in_channels, out_channels, generator=generator)
        elif use_weight:
            self.W = TorchLinear(in_channels, out_channels, generator=generator)

    def forward(self, x, graph, x0):
        x = graph.propagate(x, kind="gcn")
        if self.use_init:
            x = self.W(torch.cat([x, x0], dim=1))
        elif self.use_weight:
            x = self.W(x)
        return x


class GraphConv(nn.Module):
    """Input MLP, then conv layers with BatchNorm, ReLU, dropout and an
    additive residual. ``remat`` recomputes each conv layer (aggregation
    and Linear, no dropout) in the backward pass, as the JAX module does."""

    def __init__(self, in_channels: int, hidden_channels: int, *, num_layers: int = 2,
                 dropout: float = 0.5, use_bn: bool = True, use_residual: bool = True,
                 use_weight: bool = True, use_init: bool = False, use_act: bool = True,
                 remat: bool = False, axis_name: str | None = None,
                 generator: torch.Generator):
        super().__init__()
        self.num_layers = num_layers
        self.use_bn = use_bn
        self.use_residual = use_residual
        self.use_act = use_act
        self.remat = remat
        self.dropout = Dropout(dropout)
        self.fc_in = TorchLinear(in_channels, hidden_channels, generator=generator)
        if use_bn:
            self.bn_in = MaskedBatchNorm(hidden_channels, axis_name=axis_name)
        for i in range(num_layers):
            self.add_module(f"conv_{i}", GraphConvLayer(
                hidden_channels, hidden_channels, use_weight=use_weight,
                use_init=use_init, generator=generator,
            ))
            if use_bn:
                self.add_module(f"bn_{i}", MaskedBatchNorm(hidden_channels,
                                                           axis_name=axis_name))

    def forward(self, x, graph, node_mask=None):
        x = self.fc_in(x)
        if self.use_bn:
            x = self.bn_in(x, node_mask)
        x = self.dropout(torch.relu(x))
        # the reference never updates x0 inside its layer loop, so both the
        # x0 each conv sees and the residual are the input-MLP activation
        x0 = x
        for i in range(self.num_layers):
            conv = getattr(self, f"conv_{i}")
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(conv, x, graph, x0,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = conv(x, graph, x0)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x, node_mask)
            if self.use_act:
                x = torch.relu(x)
            x = self.dropout(x)
            if self.use_residual:
                x = x + x0
        return x
