"""DIFFormer, the diffusion-based transformer baseline: the port of
``sgformer_tpu/nn/difformer.py``.

Kernels: ``simple`` (linear attention with a sum-of-values numerator term
and a +N normaliser) and ``sigmoid`` (O(N^2) sigmoid-score attention), both
the plain einsums the JAX package computes in XLA. The SGFormer attention
kernels do not serve here: their numerator adds ``n * v`` per row where
DIFFormer adds the sum of v over the rows. Each layer adds a GCN
aggregation of the value tensor over the graph, :meth:`Graph.propagate` on
[N, H*D]: the CSR SpMM kernel on the card, forward and backward.
"""

from __future__ import annotations

import torch
from torch import nn

from sgformer_tpu_torch.nn.layers import Dropout, GraphModel, LayerNorm, TorchLinear


def difformer_attention(qs, ks, vs, kernel: str = "simple", output_attn: bool = False):
    """qs, ks: [N, H, M]; vs: [N, H, D]. Returns [N, H, D] in v's type (and
    the [N, N] head-mean attention map with ``output_attn``); every product
    is taken in f32."""
    if kernel == "simple":
        qf = qs.float() / qs.float().square().sum().sqrt()
        kf = ks.float() / ks.float().square().sum().sqrt()
        vf = vs.float()
        n = qs.shape[0]
        kvs = torch.einsum("lhm,lhd->hmd", kf, vf)
        num = torch.einsum("nhm,hmd->nhd", qf, kvs) + vf.sum(dim=0)[None]
        den = torch.einsum("nhm,hm->nh", qf, kf.sum(dim=0))[..., None] + n
        out = (num / den).to(vs.dtype)
        if output_attn:
            attn = torch.einsum("nhm,lhm->nlh", qf, kf) / den[:, None, :, 0]
            return out, attn.mean(dim=-1)
        return out
    if kernel == "sigmoid":
        scores = torch.sigmoid(torch.einsum("nhm,lhm->nlh", qs.float(), ks.float()))
        attn = scores / scores.sum(dim=1, keepdim=True)
        out = torch.einsum("nlh,lhd->nhd", attn, vs.float()).to(vs.dtype)
        if output_attn:
            return out, attn.mean(dim=-1)
        return out
    raise ValueError(f"unknown DIFFormer kernel {kernel}")


class DIFFormerConv(nn.Module):
    """Q/K/V projections, DIFFormer attention, the value GCN, mean over
    heads."""

    def __init__(self, in_channels: int, out_channels: int, *, num_heads: int = 1,
                 kernel: str = "simple", use_graph: bool = True, use_weight: bool = True,
                 graph_weight: float = -1.0, use_source: bool = False):
        super().__init__()
        if not use_weight and num_heads != 1:
            raise ValueError("use_weight=False needs num_heads == 1")
        self.out_channels = out_channels
        self.num_heads = num_heads
        self.kernel = kernel
        self.use_graph = use_graph
        self.use_weight = use_weight
        self.graph_weight = graph_weight
        self.use_source = use_source
        hd = out_channels * num_heads
        self.Wq = TorchLinear(in_channels, hd)
        self.Wk = TorchLinear(in_channels, hd)
        self.Wv = TorchLinear(in_channels, hd) if use_weight else None

    def forward(self, query_input, source_input, graph=None, x0=None,
                output_attn: bool = False):
        h, d = self.num_heads, self.out_channels
        qs = self.Wq(query_input).reshape(-1, h, d)
        ks = self.Wk(source_input).reshape(-1, h, d)
        if self.use_weight:
            vs = self.Wv(source_input).reshape(-1, h, d)
        else:
            vs = source_input.reshape(-1, 1, d)
        res = difformer_attention(qs, ks, vs, self.kernel, output_attn)
        attn_out, attn = res if output_attn else (res, None)
        if self.use_graph:
            n = vs.shape[0]
            gcn_out = graph.propagate(vs.reshape(n, -1), kind="gcn").reshape(vs.shape)
            if self.graph_weight > 0:
                out = (1 - self.graph_weight) * attn_out + self.graph_weight * gcn_out
            else:
                out = attn_out + gcn_out
        else:
            out = attn_out
        out = out.mean(dim=1)
        if self.use_source:
            out = out + x0
        if output_attn:
            return out, attn
        return out


class DIFFormer(GraphModel):
    """Input MLP, alpha-residual conv stack with LayerNorm between layers,
    output linear; ``forward(x, graph)`` gives [N, out_channels] logits."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int, *,
                 num_layers: int = 2, num_heads: int = 1, kernel: str = "simple",
                 alpha: float = 0.5, dropout: float = 0.5, use_bn: bool = True,
                 use_residual: bool = True, use_weight: bool = True, use_graph: bool = True,
                 graph_weight: float = -1.0, use_source: bool = False,
                 generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        self.alpha = alpha
        self.use_bn = use_bn
        self.use_residual = use_residual
        self.dropout = Dropout(dropout)
        self.fc_in = TorchLinear(in_channels, hidden_channels)
        if use_bn:
            self.ln_in = LayerNorm(hidden_channels)
        for i in range(num_layers):
            self.add_module(f"conv_{i}", DIFFormerConv(
                hidden_channels, hidden_channels, num_heads=num_heads, kernel=kernel,
                use_graph=use_graph, use_weight=use_weight, graph_weight=graph_weight,
                use_source=use_source))
            if use_bn:
                self.add_module(f"ln_{i}", LayerNorm(hidden_channels))
        self.fc_out = TorchLinear(hidden_channels, out_channels)
        self.finish_init(generator, dropout_generator, device)

    def forward(self, x, graph, node_mask=None, output_attn: bool = False):
        x = self.fc_in(x)
        if self.use_bn:
            x = self.ln_in(x)
        x = self.dropout(torch.relu(x))
        x0 = prev = x
        attns = []
        for i in range(self.num_layers):
            conv = getattr(self, f"conv_{i}")
            if output_attn:
                x, attn = conv(x, x, graph, x0, output_attn=True)
                attns.append(attn)
            else:
                x = conv(x, x, graph, x0)
            if self.use_residual:
                x = self.alpha * x + (1 - self.alpha) * prev
            if self.use_bn:
                x = getattr(self, f"ln_{i}")(x)
            x = self.dropout(x)
            prev = x
        out = self.fc_out(x)
        if output_attn:
            return out, torch.stack(attns, dim=0)
        return out
