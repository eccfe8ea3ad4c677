"""Vanilla GCN, the medium-tier GNN branch and a standalone baseline: the
port of ``sgformer_tpu/nn/gcn.py``.

A stack of PyG ``GCNConv`` layers (glorot kernel, the PyG ``gcn_norm``
aggregation, zero-initialised bias added after the aggregation) with
BatchNorm, ReLU and dropout between layers and a plain last conv. The
aggregation is :meth:`sgformer_tpu_torch.graph.Graph.propagate` on the
``pyg_*`` edges, the CSR SpMM kernel on the card; the graph needs
``preprocess_graph(..., with_pyg_norm=True)``.
"""

from __future__ import annotations

import torch
from torch import nn

from sgformer_tpu_torch.nn.layers import Dropout, GraphModel, glorot_uniform
from sgformer_tpu_torch.nn.norm import MaskedBatchNorm


class GCNConv(nn.Module):
    """``out = A_pyg @ (x @ kernel) + bias``. ``kernel`` is [in, out], the
    flax layout, applied as ``x @ kernel`` in x's type."""

    FLAX_PARAMS = ("kernel", "bias")

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_channels, out_channels))
        self.bias = nn.Parameter(torch.empty(out_channels))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.kernel.copy_(glorot_uniform(tuple(self.kernel.shape), generator))
        self.bias.zero_()

    def forward(self, x: torch.Tensor, graph) -> torch.Tensor:
        x = graph.propagate(x @ self.kernel.to(x.dtype), kind="pyg")
        return x + self.bias.to(x.dtype)


class GCN(GraphModel):
    """GCN stack; the output width is ``out_channels`` (the hidden width
    when it is SGFormer's branch). ``axis_name``: the mesh axis of
    node-sharded training, whose BatchNorm statistics all-reduce over it
    (the aggregation is then the shard graph's)."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int, *,
                 num_layers: int = 2, dropout: float = 0.5, use_bn: bool = True,
                 axis_name: str | None = None,
                 generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        self.use_bn = use_bn
        self.dropout = Dropout(dropout)
        dims = [hidden_channels] * (num_layers - 1) + [out_channels]
        width = in_channels
        for i, d in enumerate(dims):
            self.add_module(f"conv_{i}", GCNConv(width, d))
            if use_bn and i < num_layers - 1:
                self.add_module(f"bn_{i}", MaskedBatchNorm(d, axis_name=axis_name))
            width = d
        self.finish_init(generator, dropout_generator, device)

    def forward(self, x: torch.Tensor, graph, node_mask=None) -> torch.Tensor:
        for i in range(self.num_layers - 1):
            x = getattr(self, f"conv_{i}")(x, graph)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x, node_mask)
            x = self.dropout(torch.relu(x))
        return getattr(self, f"conv_{self.num_layers - 1}")(x, graph)
