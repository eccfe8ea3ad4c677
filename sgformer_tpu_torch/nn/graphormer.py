"""Graphormer, a transformer encoder with degree and spatial encodings: the
port of ``sgformer_tpu/nn/graphormer.py``.

Integer "single-embedding" node features summed over the feature columns,
in- and out-degree embeddings, a per-head spatial-position attention bias,
an optional graph token, pre-LN encoder layers with a GELU feed-forward,
and the output head (LN(GELU(W x)), an optional vocabulary projection with
a learned bias, then the final linear). The attention is plain einsums over
[N+1, N+1] scores (medium-tier graphs only), as the JAX package computes it
in XLA.

:func:`graphormer_inputs` and :func:`collate_graphs` are the JAX package's
host preprocessing, bitwise (numpy and scipy). A model takes their dict
with every array a tensor on its device (:func:`inputs_to`), so that no
forward copies the [N, N] spatial positions from the host. Every train-mode
draw (dropout, LayerDrop, quantisation noise) comes from the generator that
:meth:`GraphModel.set_dropout_generator` sets.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sgformer_tpu_torch.nn.layers import (Draws, Dropout, Embed, GraphModel, LayerNorm,
                                          TorchLinear, uniform)


class QuantNoiseLinear(Draws):
    """Linear with fairseq's ``quant_noise`` block dropout on the weight: in
    train mode, with ``p > 0``, random ``block_size``-row blocks of each
    output column of the [in, out] kernel are zeroed and the survivors
    scaled by 1/(1-p). ``p = 0`` is a plain linear layer. ``kernel`` and
    ``bias`` keep the flax layout (applied as ``x @ kernel + bias``) and
    torch's ``nn.Linear`` init."""

    FLAX_PARAMS = ("kernel", "bias")

    def __init__(self, in_features: int, features: int, *, p: float = 0.0,
                 block_size: int = 8, use_bias: bool = True):
        super().__init__()
        self.p = p
        self.block_size = block_size
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        if use_bias:
            self.bias = nn.Parameter(torch.empty(features))
        else:
            self.FLAX_PARAMS = ("kernel",)
            self.register_parameter("bias", None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.kernel.shape[0])
        self.kernel.copy_(uniform(self.kernel.shape, bound, generator))
        if self.bias is not None:
            self.bias.copy_(uniform(self.bias.shape, bound, generator))

    def forward(self, x):
        kernel = self.kernel
        if self.p > 0.0 and self.training:
            in_features, features = kernel.shape
            if in_features % self.block_size:
                raise ValueError("in_features must be a multiple of qn_block_size")
            gen = self.draw_generator()
            nblocks = in_features // self.block_size
            drop = torch.rand((nblocks, 1, features), generator=gen, device=gen.device) < self.p
            mask = drop.expand(nblocks, self.block_size, features).reshape(in_features, features)
            kernel = torch.where(mask, torch.zeros_like(kernel), kernel) / (1.0 - self.p)
        y = x @ kernel.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def convert_to_single_emb(x: np.ndarray, offset: int = 512) -> np.ndarray:
    """Shift each feature column into its own ``offset``-sized vocabulary
    slice (+1 keeps 0 for padding)."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    feature_offset = 1 + np.arange(0, offset * x.shape[1], offset, dtype=np.int64)
    return x.astype(np.int64) + feature_offset[None, :]


def graphormer_inputs(edge_index, node_feat, num_nodes: int, *, spatial: str = "bfs",
                      max_dist: int = 510, seed: int = 0) -> dict:
    """Host preprocessing: integer features, in- and out-degrees (capped at
    511) and the [N, N] spatial positions: shortest-path hop counts on the
    undirected graph capped at ``max_dist`` (``spatial='bfs'``), or the
    reference's random stub (``'random'``, from numpy seeded ``seed``)."""
    x_int = convert_to_single_emb(node_feat)
    src, dst = np.asarray(edge_index)
    in_degree = np.bincount(dst, minlength=num_nodes).astype(np.int64)
    out_degree = np.bincount(src, minlength=num_nodes).astype(np.int64)
    if spatial == "random":
        rng = np.random.default_rng(seed)
        spatial_pos = rng.integers(0, 1000, size=(num_nodes, num_nodes))
    else:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import shortest_path

        a = sp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(num_nodes, num_nodes))
        dist = shortest_path(a, method="D", unweighted=True, directed=False)
        dist[~np.isfinite(dist)] = max_dist
        spatial_pos = np.minimum(dist, max_dist).astype(np.int64)
    return {
        "x": x_int,
        "in_degree": np.minimum(in_degree, 511),
        "out_degree": np.minimum(out_degree, 511),
        "spatial_pos": spatial_pos,
    }


def collate_graphs(graphs: list, max_nodes: Optional[int] = None) -> dict:
    """Pad and stack per-graph :func:`graphormer_inputs` into one [G, Nmax,
    ...] batch: integer ids shifted by +1 so that 0 pads; ``attn_bias``
    [G, Nmax+1, Nmax+1] is -inf on the pad key columns (0 elsewhere), which
    masks padding out of every softmax; also ``num_nodes`` [G] and
    ``node_mask`` [G, Nmax]."""
    sizes = [g["x"].shape[0] for g in graphs]
    n_max = max_nodes if max_nodes is not None else max(sizes)
    if not all(s <= n_max for s in sizes):
        raise ValueError(f"a graph has more than max_nodes = {n_max} nodes")
    count = len(graphs)
    fdim = graphs[0]["x"].shape[1]
    x = np.zeros((count, n_max, fdim), dtype=np.int64)
    in_deg = np.zeros((count, n_max), dtype=np.int64)
    out_deg = np.zeros((count, n_max), dtype=np.int64)
    spatial = np.zeros((count, n_max, n_max), dtype=np.int64)
    attn_bias = np.full((count, n_max + 1, n_max + 1), -np.inf, dtype=np.float32)
    mask = np.zeros((count, n_max), dtype=np.float32)
    for i, (g, n) in enumerate(zip(graphs, sizes)):
        x[i, :n] = g["x"] + 1
        in_deg[i, :n] = g["in_degree"] + 1
        out_deg[i, :n] = g["out_degree"] + 1
        spatial[i, :n, :n] = g["spatial_pos"] + 1
        attn_bias[i, : n + 1, : n + 1] = 0.0
        attn_bias[i, n + 1:, : n + 1] = 0.0  # pad query rows see the real keys
        mask[i, :n] = 1.0
    return {
        "x": x,
        "in_degree": in_deg,
        "out_degree": out_deg,
        "spatial_pos": spatial,
        "attn_bias": attn_bias,
        "num_nodes": np.asarray(sizes, dtype=np.int64),
        "node_mask": mask,
    }


def inputs_to(inputs: dict, device) -> dict:
    """``inputs`` with every array a tensor on ``device`` (None stays)."""
    moved = {}
    for key, value in inputs.items():
        if value is not None and not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.asarray(value))
        moved[key] = None if value is None else value.to(device)
    return moved


class GraphormerLayer(nn.Module):
    """Pre-LN encoder layer; q/k/v/out are :class:`QuantNoiseLinear` (plain
    linear layers when ``q_noise`` is 0)."""

    def __init__(self, dim: int, heads: int, ffn_dim: int, *, dropout: float = 0.0,
                 attn_dropout: float = 0.0, q_noise: float = 0.0, qn_block_size: int = 8):
        super().__init__()
        self.heads = heads
        qn = dict(p=q_noise, block_size=qn_block_size)
        self.drop = Dropout(dropout)
        self.attn_ln = LayerNorm(dim)
        self.q = QuantNoiseLinear(dim, dim, **qn)
        self.k = QuantNoiseLinear(dim, dim, **qn)
        self.v = QuantNoiseLinear(dim, dim, **qn)
        self.attn_drop = Dropout(attn_dropout)
        self.out = QuantNoiseLinear(dim, dim, **qn)
        self.ffn_ln = LayerNorm(dim)
        self.fc1 = TorchLinear(dim, ffn_dim)
        self.fc2 = TorchLinear(ffn_dim, dim)

    def forward(self, x, attn_bias):
        dim = x.shape[-1]
        heads, d = self.heads, dim // self.heads
        lead = x.shape[:-1]  # (N+1,) for one graph, (G, N+1) for a padded batch
        h = self.attn_ln(x)
        q = self.q(h).reshape(*lead, heads, d)
        k = self.k(h).reshape(*lead, heads, d)
        v = self.v(h).reshape(*lead, heads, d)
        scores = torch.einsum("...nhd,...mhd->...hnm", q.float(), k.float()) / math.sqrt(d)
        w = self.attn_drop(torch.softmax(scores + attn_bias, dim=-1))
        attn = torch.einsum("...hnm,...mhd->...nhd", w, v.float()).to(x.dtype)
        x = x + self.drop(self.out(attn.reshape(*lead, dim)))
        h = F.gelu(self.fc1(self.ffn_ln(x)), approximate="none")
        return x + self.drop(self.fc2(self.drop(h)))


class LayerDrop(Draws):
    """fairseq LayerDrop's draw: in train mode, which of ``num_layers``
    layers run (each skipped with probability ``rate``); None (all run) in
    eval mode or at rate 0."""

    def __init__(self, rate: float, num_layers: int):
        super().__init__()
        self.rate = rate
        self.num_layers = num_layers

    def forward(self) -> Optional[torch.Tensor]:
        if not self.training or self.rate <= 0.0:
            return None
        gen = self.draw_generator()
        return torch.rand(self.num_layers, generator=gen, device=gen.device) > self.rate


class Graphormer(GraphModel):
    """``forward(x, graph, inputs=...)`` gives [N, C] logits (the graph
    token dropped; [G, N, C] for a collated batch); ``x`` and ``graph`` are
    unused, ``inputs`` is :func:`graphormer_inputs`' dict (or
    :func:`collate_graphs`'), its arrays tensors on the model's device.

    The options are the JAX module's: ``layerdrop`` (each layer skipped with
    that probability in a train-mode forward), ``q_noise``/``qn_block_size``
    (quantisation noise on the attention projections), ``use_edge_bias``
    (a per-head bias from ``inputs['attn_edge_type']`` [N, N, Fe], mean over
    the columns), ``use_virtual_distance`` (a learned per-head bias on the
    graph token's row and column), ``use_graph_token``, ``use_embed_out``
    (the vocabulary projection with a learned scalar bias before ``fc``) and
    ``inputs['attn_bias']`` (an additive [N+1, N+1] base bias, the collated
    batch's -inf padding)."""

    def __init__(self, in_channels: int, out_channels: int, *, embed_dim: int = 64,
                 num_layers: int = 2, num_heads: int = 1, ffn_dim: Optional[int] = None,
                 dropout: float = 0.0, attn_dropout: float = 0.0, num_atoms: int = 512 * 9,
                 num_degree: int = 512, num_spatial: int = 1024, num_edges: int = 512 * 3,
                 layerdrop: float = 0.0, q_noise: float = 0.0, qn_block_size: int = 8,
                 use_edge_bias: bool = False, use_virtual_distance: bool = False,
                 use_graph_token: bool = True, use_embed_out: bool = False,
                 generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        if use_virtual_distance and not use_graph_token:
            raise ValueError("virtual distance needs the graph token")
        dim = embed_dim
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_atoms, self.num_degree, self.num_spatial = num_atoms, num_degree, num_spatial
        self.num_edges = num_edges
        self.use_edge_bias = use_edge_bias
        self.use_virtual_distance = use_virtual_distance
        self.use_graph_token = use_graph_token
        self.use_embed_out = use_embed_out
        self.atom_encoder = Embed(num_atoms + 1, dim)
        self.in_degree_encoder = Embed(num_degree, dim)
        self.out_degree_encoder = Embed(num_degree, dim)
        own = []
        if use_graph_token:
            self.graph_token = nn.Parameter(torch.empty(1, dim))
            own.append("graph_token")
        self.spatial_pos_encoder = Embed(num_spatial, num_heads)
        if use_edge_bias:
            self.edge_encoder = Embed(num_edges + 1, num_heads)
        if use_virtual_distance:
            self.graph_token_virtual_distance = nn.Parameter(torch.empty(1, num_heads))
            own.append("graph_token_virtual_distance")
        self.layerdrop = LayerDrop(layerdrop, num_layers)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", GraphormerLayer(
                dim, num_heads, ffn_dim or dim, dropout=dropout, attn_dropout=attn_dropout,
                q_noise=q_noise, qn_block_size=qn_block_size))
        self.lm_head_transform = TorchLinear(dim, dim)
        self.head_ln = LayerNorm(dim)
        if use_embed_out:
            self.embed_out = TorchLinear(dim, out_channels, bias=False)
            self.lm_output_learned_bias = nn.Parameter(torch.empty(1))
            own.append("lm_output_learned_bias")
        self.FLAX_PARAMS = tuple(own)
        self.fc = TorchLinear(out_channels if use_embed_out else dim, out_channels)
        self.finish_init(generator, dropout_generator, device)

    def reset_own_parameters(self, generator: torch.Generator) -> None:
        for name in ("graph_token", "graph_token_virtual_distance"):
            if name in self.FLAX_PARAMS:
                p = getattr(self, name)
                p.copy_(0.02 * torch.randn(p.shape, generator=generator))
        if self.use_embed_out:
            self.lm_output_learned_bias.zero_()

    def forward(self, x=None, graph=None, node_mask=None, inputs: Optional[dict] = None):
        if inputs is None:
            raise ValueError("Graphormer needs inputs=graphormer_inputs(edge_index, x, n) "
                             "on its device (inputs_to)")
        h = self.atom_encoder(inputs["x"].clamp(0, self.num_atoms)).sum(dim=-2)  # [..., N, dim]
        h = h + self.in_degree_encoder(inputs["in_degree"].clamp(0, self.num_degree - 1))
        h = h + self.out_degree_encoder(inputs["out_degree"].clamp(0, self.num_degree - 1))
        if self.use_graph_token:
            tok = self.graph_token.to(h.dtype).expand(*h.shape[:-2], 1, h.shape[-1])
            h = torch.cat([tok, h], dim=-2)  # [..., N+1, dim]

        # per-head spatial bias, a zero row and column for the graph token
        sp = self.spatial_pos_encoder(inputs["spatial_pos"].clamp(0, self.num_spatial - 1))
        bias = torch.movedim(sp, -1, -3)  # [..., H, N, N]
        if self.use_edge_bias and inputs.get("attn_edge_type") is not None:
            ed = self.edge_encoder(inputs["attn_edge_type"].clamp(0, self.num_edges))
            bias = bias + torch.movedim(ed.mean(dim=-2), -1, -3)
        if self.use_graph_token:
            bias = F.pad(bias, (1, 0, 1, 0))
        if self.use_virtual_distance:
            t = self.graph_token_virtual_distance[0][:, None]  # [H, 1]
            # the graph token attends and is attended with a learned distance
            bias = bias.clone()
            bias[..., 1:, 0] += t
            bias[..., 0, :] += t
        if inputs.get("attn_bias") is not None:
            bias = bias + inputs["attn_bias"][..., None, :, :]

        keep = self.layerdrop()
        for i in range(self.num_layers):
            h_new = getattr(self, f"layer_{i}")(h, bias)
            h = h_new if keep is None else torch.where(keep[i], h_new, h)

        if self.use_graph_token:
            h = h[..., 1:, :]  # drop the graph token
        h = self.head_ln(F.gelu(self.lm_head_transform(h), approximate="none"))
        if self.use_embed_out:
            h = self.embed_out(h) + self.lm_output_learned_bias
        return self.fc(h)
