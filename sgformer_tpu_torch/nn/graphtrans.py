"""GraphTrans, a GCN encoder followed by a transformer encoder over the node
sequence: the port of ``sgformer_tpu/nn/graphtrans.py``.

The encoder layer is torch's post-LN ``TransformerEncoderLayer`` (ReLU
feed-forward); its attention is written out in flax
``MultiHeadDotProductAttention``'s layout and scale, as the JAX package
runs it: ``query``/``key``/``value`` kernels [in, H, D] with biases [H, D],
an ``out`` kernel [H, D, out], q scaled by 1/sqrt(D), a softmax over the
keys in f32 and dropout on the weights. The products are plain einsums
(O(N^2) scores), as the JAX package computes them in XLA; the GCN's
aggregations are the CSR SpMM kernel on the card (the graph needs
``preprocess_graph(..., with_pyg_norm=True)``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from sgformer_tpu_torch.nn.gcn import GCN
from sgformer_tpu_torch.nn.layers import DenseGeneral, Dropout, GraphModel, LayerNorm, TorchLinear


class MultiHeadDotProductAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention(num_heads, qkv_features)`` on one
    sequence: [L, d_model] -> [L, d_model]."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of num_heads {num_heads}")
        head = (num_heads, d_model // num_heads)
        self.query = DenseGeneral((d_model,), head)
        self.key = DenseGeneral((d_model,), head)
        self.value = DenseGeneral((d_model,), head)
        self.out = DenseGeneral(head, (d_model,))
        self.dropout = Dropout(dropout)

    def forward(self, x):
        q = self.query(x)  # [L, H, D]
        k = self.key(x)
        v = self.value(x)
        q = q / math.sqrt(q.shape[-1])
        w = torch.softmax(torch.einsum("qhd,khd->hqk", q.float(), k.float()), dim=-1)
        w = self.dropout(w).to(v.dtype)
        return self.out(torch.einsum("hqk,khd->qhd", w, v))


class TransformerEncoderLayer(nn.Module):
    """torch-style post-LN encoder layer."""

    def __init__(self, d_model: int, n_head: int, dim_feedforward: int, dropout: float = 0.1):
        super().__init__()
        self.drop = Dropout(dropout)
        self.self_attn = MultiHeadDotProductAttention(d_model, n_head, dropout)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = TorchLinear(d_model, dim_feedforward)
        self.linear2 = TorchLinear(dim_feedforward, d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, x):
        x = self.norm1(x + self.drop(self.self_attn(x)))
        ff = self.drop(torch.relu(self.linear1(x)))
        return self.norm2(x + self.drop(self.linear2(ff)))


class GraphTrans(GraphModel):
    """GCN, a linear to ``d_model``, an optional input LayerNorm, the
    encoder stack, a final LayerNorm and the output linear."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int, *,
                 gnn_emb_dim: int = 64, d_model: int = 64, num_layers: int = 2,
                 num_trans_layers: int = 3, num_trans_head: int = 4,
                 dim_feedforward: int = 256, dropout: float = 0.5, trans_dropout: float = 0.1,
                 use_bn: bool = True, norm_input: bool = True,
                 generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        self.num_trans_layers = num_trans_layers
        self.norm_input = norm_input
        self.gnn = GCN(in_channels, hidden_channels, gnn_emb_dim, num_layers=num_layers,
                       dropout=dropout, use_bn=use_bn, device=device)
        self.gnn2transformer = TorchLinear(gnn_emb_dim, d_model)
        if norm_input:
            self.input_ln = LayerNorm(d_model)
        for i in range(num_trans_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(
                d_model, num_trans_head, dim_feedforward, dropout=trans_dropout))
        self.final_ln = LayerNorm(d_model)
        self.output = TorchLinear(d_model, out_channels)
        self.finish_init(generator, dropout_generator, device)

    def forward(self, x, graph, node_mask=None):
        h = self.gnn2transformer(self.gnn(x, graph, node_mask=node_mask))
        if self.norm_input:
            h = self.input_ln(h)
        for i in range(self.num_trans_layers):
            h = getattr(self, f"layer_{i}")(h)
        return self.output(self.final_ln(h))
