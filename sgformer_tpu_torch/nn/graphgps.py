"""GraphGPS, local GCN message passing beside global Performer attention
and a feed-forward block in each layer: the port of
``sgformer_tpu/nn/graphgps.py``.

The local branch is :class:`GCNConv` on the PyG edges (the CSR SpMM kernel
on the card; the graph needs ``preprocess_graph(..., with_pyg_norm=True)``);
the global branch the plain einsums of positive random features, as the
JAX package computes them in XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from sgformer_tpu_torch.nn.gcn import GCNConv
from sgformer_tpu_torch.nn.layers import Dropout, GraphModel, TorchLinear
from sgformer_tpu_torch.nn.norm import MaskedBatchNorm
from sgformer_tpu_torch.ops.attention_variants import (create_projection_matrix,
                                                       performer_attention)


class PerformerSelfAttention(nn.Module):
    """FAVOR+ self-attention with the defaults of ``performer_pytorch``'s
    ``SelfAttention``: ``dim_head`` 64 whatever ``dim`` is, ``int(dim_head *
    ln dim_head)`` random features, no bias on the Q/K/V projections, a bias
    on the output one, kernel eps 1e-4. The projection is the buffer
    ``projection`` [M, dim_head], drawn with the parameters (so anew on
    every reset, as the JAX module draws it at init) and carried from the
    flax ``batch_stats/.../projection``."""

    FLAX_BATCH_STATS = ("projection",)

    def __init__(self, dim: int, *, heads: int = 4, dim_head: int = 64,
                 nb_features: Optional[int] = None, dropout: float = 0.0):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        inner = heads * dim_head
        m = nb_features or int(dim_head * math.log(dim_head))
        self.to_q = TorchLinear(dim, inner, bias=False)
        self.to_k = TorchLinear(dim, inner, bias=False)
        self.to_v = TorchLinear(dim, inner, bias=False)
        self.register_buffer("projection", torch.empty(m, dim_head))
        self.to_out = TorchLinear(inner, dim)
        self.dropout = Dropout(dropout)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.projection.copy_(create_projection_matrix(*self.projection.shape, generator))

    def forward(self, x):
        h, dh = self.heads, self.dim_head
        q = self.to_q(x).reshape(-1, h, dh)
        k = self.to_k(x).reshape(-1, h, dh)
        v = self.to_v(x).reshape(-1, h, dh)
        out = performer_attention(q, k, v, projection=self.projection, tau=1.0,
                                  numerical_stabilizer=1e-4)
        return self.dropout(self.to_out(out.reshape(-1, h * dh)))


class GPSLayer(nn.Module):
    """h = BN(x + GCN(x)) + BN(x + Attn(x)); then h = BN(h + FF(h))."""

    def __init__(self, dim: int, *, num_heads: int = 4, dropout: float = 0.0,
                 attn_dropout: float = 0.0, use_bn: bool = True):
        super().__init__()
        self.use_bn = use_bn
        self.drop = Dropout(dropout)
        self.local = GCNConv(dim, dim)
        if use_bn:
            self.norm1_local = MaskedBatchNorm(dim)
        self.self_attn = PerformerSelfAttention(dim, heads=num_heads, dropout=attn_dropout)
        if use_bn:
            self.norm1_attn = MaskedBatchNorm(dim)
        self.ff1 = TorchLinear(dim, dim * 2)
        self.ff2 = TorchLinear(dim * 2, dim)
        if use_bn:
            self.norm2 = MaskedBatchNorm(dim)

    def forward(self, x, graph, node_mask=None):
        h_local = x + self.local(x, graph)
        if self.use_bn:
            h_local = self.norm1_local(h_local, node_mask)
        h_attn = x + self.drop(self.self_attn(x))
        if self.use_bn:
            h_attn = self.norm1_attn(h_attn, node_mask)
        h = h_local + h_attn
        ff = self.drop(torch.relu(self.ff1(h)))
        h = h + self.drop(self.ff2(ff))
        if self.use_bn:
            h = self.norm2(h, node_mask)
        return h


class GraphGPS(GraphModel):
    """pre_mp linear, GPS layers, post_mp linear."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int, *,
                 num_layers: int = 2, num_heads: int = 4, dropout: float = 0.5,
                 attn_dropout: float = 0.0, use_bn: bool = True,
                 generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        self.drop = Dropout(dropout)
        self.pre_mp = TorchLinear(in_channels, hidden_channels)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", GPSLayer(
                hidden_channels, num_heads=num_heads, dropout=dropout,
                attn_dropout=attn_dropout, use_bn=use_bn))
        self.post_mp = TorchLinear(hidden_channels, out_channels)
        self.finish_init(generator, dropout_generator, device)

    def forward(self, x, graph, node_mask=None):
        x = self.drop(torch.relu(self.pre_mp(x)))
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, graph, node_mask)
        return self.post_mp(x)
