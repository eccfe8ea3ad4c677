"""NodeFormer, the kernelised-softmax graph transformer with Gumbel
sampling, relational bias and an edge-level regularisation loss: the port
of ``sgformer_tpu/nn/nodeformer.py``.

The attention is the plain einsums of positive random features, as the JAX
package computes them in XLA. The relational bias aggregates v over each
adjacency power (A+I, (A+I)^2, ...) with NodeFormer's own weights
``rsqrt(max(d_in[dst], 1)) * rsqrt(max(d_in[src], 1))``, ``d_in`` counted on
that adjacency: each power is built once as a port :class:`Graph`
(:func:`build_nodeformer_graphs`), so the aggregation is the CSR SpMM kernel
on the card, its gradient a walk of the power's transpose.

Random draws, each from an explicit generator on the model's device:

- a train-mode forward draws a new projection for each layer, as the JAX
  trainer draws one from its per-step ``performer`` key, and the Gumbel
  uniforms, both from the generator that
  :meth:`GraphModel.set_dropout_generator` sets (the trainer's);
- an eval-mode forward uses the fixed buffer ``eval_projection``, drawn
  once from a CPU generator seeded 0: the counterpart of the JAX layer's
  ``PRNGKey(0)``. It is no flax variable, so it is not in the state dict;
  a test overwrites it with the JAX draw.

``forward(..., draws=...)`` passes a layer's train-mode draws in instead.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from sgformer_tpu_torch.device import resolve_device
from sgformer_tpu_torch.graph import (Graph, add_self_loops, graph_from_sorted,
                                      remove_self_loops, sort_by_dst)
from sgformer_tpu_torch.nn.layers import Draws, Dropout, GraphModel, LayerNorm, TorchLinear
from sgformer_tpu_torch.ops.attention_variants import (create_projection_matrix,
                                                       softmax_kernel_transformation)


def build_nodeformer_adjs(edge_index, num_nodes: int, rb_order: int = 2) -> list:
    """[A+I, (A+I)^2, ...] as [2, E] int64 numpy edge lists (source,
    destination), on the host with scipy, in the JAX function's order."""
    import scipy.sparse as sp

    if isinstance(edge_index, torch.Tensor):
        edge_index = edge_index.cpu()
    else:
        edge_index = torch.from_numpy(np.asarray(edge_index))
    adj = add_self_loops(remove_self_loops(edge_index), num_nodes).numpy()
    adjs = [adj]
    cur = adj
    s0, d0 = adj
    a0 = sp.csr_matrix((np.ones(len(s0)), (d0, s0)), shape=(num_nodes,) * 2)
    for _ in range(rb_order - 1):
        src, dst = cur
        a = sp.csr_matrix((np.ones(len(src)), (dst, src)), shape=(num_nodes,) * 2)
        prod = (a @ a0).tocoo()
        cur = np.stack([prod.col, prod.row]).astype(np.int64)
        adjs.append(cur)
    return adjs


def nodeformer_graph(edge_index, num_nodes: int, *, device="cuda") -> Graph:
    """One adjacency's edges as a :class:`Graph` on ``device``, sorted by
    destination (duplicates kept, as the JAX segment sums keep them), with
    NodeFormer's weights in ``gcn_weight``. ``symmetric`` is False, so the
    gradient walks the transposed CSR whatever the edges are."""
    dev = resolve_device(device)
    src, dst = sort_by_dst(*torch.as_tensor(edge_index).to(dev).int())
    d_in = torch.bincount(dst, minlength=num_nodes).float().clamp(min=1.0)
    weight = torch.rsqrt(d_in[dst.long()]) * torch.rsqrt(d_in[src.long()])
    return graph_from_sorted(src, dst, weight, num_nodes, symmetric=False)


def build_nodeformer_graphs(edge_index, num_nodes: int, rb_order: int = 2, *,
                            device="cuda") -> list:
    """:func:`build_nodeformer_adjs` as :func:`nodeformer_graph` s: the
    ``adjs`` a NodeFormer takes."""
    return [nodeformer_graph(a, num_nodes, device=device)
            for a in build_nodeformer_adjs(edge_index, num_nodes, rb_order)]


def _edge_attention(q_prime, k_prime, den, src, dst):
    num = torch.einsum("ehm,ehm->eh", q_prime[dst], k_prime[src])
    return num / den[dst, :, 0]


class NodeFormerConv(Draws):
    """One NodeFormer layer; ``forward`` returns (out, link loss or None)."""

    def __init__(self, in_channels: int, out_channels: int, *, num_heads: int = 4,
                 nb_random_features: int = 30, use_gumbel: bool = True,
                 nb_gumbel_sample: int = 10, rb_order: int = 2, rb_trans: str = "sigmoid",
                 use_edge_loss: bool = True):
        super().__init__()
        self.out_channels = out_channels
        self.num_heads = num_heads
        self.nb_random_features = nb_random_features
        self.use_gumbel = use_gumbel
        self.nb_gumbel_sample = nb_gumbel_sample
        self.rb_order = rb_order
        self.rb_trans = rb_trans
        self.use_edge_loss = use_edge_loss
        hd = out_channels * num_heads
        self.Wq = TorchLinear(in_channels, hd)
        self.Wk = TorchLinear(in_channels, hd)
        self.Wv = TorchLinear(in_channels, hd)
        if rb_order >= 1:
            self.FLAX_PARAMS = ("b",)
            self.b = nn.Parameter(torch.empty(rb_order, num_heads))
        self.Wo = TorchLinear(hd, out_channels)
        self.register_buffer("eval_projection", create_projection_matrix(
            nb_random_features, out_channels, torch.Generator().manual_seed(0)),
            persistent=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.rb_order >= 1:
            self.b.fill_(0.1 if self.rb_trans == "sigmoid" else 1.0)

    def draw(self, n: int) -> tuple:
        """A train-mode forward's (projection, Gumbel uniforms or None) for
        n nodes, from the module's generator."""
        gen = self.draw_generator()
        proj = create_projection_matrix(self.nb_random_features, self.out_channels, gen)
        if not self.use_gumbel:
            return proj, None
        shape = (n, self.num_heads, self.nb_gumbel_sample)
        return proj, torch.rand(shape, generator=gen, device=gen.device).clamp_min_(1e-20)

    def forward(self, z, adjs: Sequence[Graph], tau: float = 0.25,
                draws: Optional[tuple] = None):
        n = z.shape[0]
        h, d = self.num_heads, self.out_channels
        q = self.Wq(z).reshape(n, h, d)
        k = self.Wk(z).reshape(n, h, d)
        v = self.Wv(z).reshape(n, h, d)
        uniforms = None
        if self.training:
            proj, uniforms = draws if draws is not None else self.draw(n)
        else:
            proj = self.eval_projection

        q_prime = softmax_kernel_transformation(q / math.sqrt(tau), True, proj)  # [N, H, M]
        k_prime = softmax_kernel_transformation(k / math.sqrt(tau), False, proj)
        den = torch.einsum("nhm,hm->nh", q_prime, k_prime.sum(dim=0))[..., None]
        vf = v.float()
        if self.use_gumbel and self.training:
            # K Gumbel perturbations of the keys
            gumbels = -torch.log(-torch.log(uniforms)) / tau  # [N, H, K]
            k_g = k_prime[:, :, None, :] * torch.exp(gumbels)[..., None]  # [N, H, K, M]
            kvs_g = torch.einsum("nhkm,nhd->hkmd", k_g, vf)
            num_g = torch.einsum("nhm,hkmd->nhkd", q_prime, kvs_g)
            den_g = torch.einsum("nhm,hkm->nhk", q_prime, k_g.sum(dim=0))[..., None]
            z_next = (num_g / den_g).mean(dim=2)  # [N, H, D]
        else:
            kvs = torch.einsum("nhm,nhd->hmd", k_prime, vf)
            z_next = torch.einsum("nhm,hmd->nhd", q_prime, kvs) / den

        # relational bias: a per-head scalar times each power's aggregation
        # of v, through the CSR SpMM kernel
        order = min(self.rb_order, len(adjs))
        for i in range(order):
            agg = adjs[i].propagate(v.reshape(n, h * d), kind="gcn").reshape(n, h, d)
            b_i = torch.sigmoid(self.b[i]) if self.rb_trans == "sigmoid" else self.b[i]
            z_next = z_next + agg * b_i[None, :, None]

        out = self.Wo(z_next.to(z.dtype).reshape(n, h * d))
        if not self.use_edge_loss:
            return out, None
        g0 = adjs[0]
        src, dst = g0.edge_src.long(), g0.edge_dst.long()
        weight = _edge_attention(q_prime, k_prime, den, src, dst)
        d_in = torch.diff(g0.indptr).float()
        d_norm = 1.0 / d_in.clamp(min=1.0)[dst]
        return out, torch.mean(torch.log(weight + 1e-20) * d_norm[:, None])


class NodeFormer(GraphModel):
    """``forward(x, graph, adjs=...)`` returns ``(logits, link_losses)``;
    the trainer subtracts ``lamda * mean(link_losses)`` from the loss.
    ``adjs`` is :func:`build_nodeformer_graphs`' list; without it the
    graph's own edges serve as the one adjacency."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int, *,
                 num_layers: int = 2, num_heads: int = 4, dropout: float = 0.0,
                 nb_random_features: int = 30, use_bn: bool = True, use_gumbel: bool = True,
                 use_residual: bool = True, use_act: bool = False, use_jk: bool = False,
                 nb_gumbel_sample: int = 10, rb_order: int = 2, rb_trans: str = "sigmoid",
                 use_edge_loss: bool = True, tau: float = 1.0,
                 generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        self.use_bn = use_bn
        self.use_residual = use_residual
        self.use_act = use_act
        self.use_jk = use_jk
        self.tau = tau
        self.dropout = Dropout(dropout)
        self.fc_in = TorchLinear(in_channels, hidden_channels)
        if use_bn:
            self.ln_in = LayerNorm(hidden_channels)
        for i in range(num_layers):
            self.add_module(f"conv_{i}", NodeFormerConv(
                hidden_channels, hidden_channels, num_heads=num_heads,
                nb_random_features=nb_random_features, use_gumbel=use_gumbel,
                nb_gumbel_sample=nb_gumbel_sample, rb_order=rb_order, rb_trans=rb_trans,
                use_edge_loss=use_edge_loss))
            if use_bn:
                self.add_module(f"ln_{i}", LayerNorm(hidden_channels))
        width = hidden_channels * (num_layers + 1) if use_jk else hidden_channels
        self.fc_out = TorchLinear(width, out_channels)
        self.finish_init(generator, dropout_generator, device)

    def forward(self, x, graph, node_mask=None, adjs: Optional[Sequence[Graph]] = None,
                draws: Optional[Sequence[tuple]] = None):
        """``draws``: each layer's (projection, Gumbel uniforms or None) for
        a train-mode forward, instead of drawing them."""
        if adjs is None:
            adjs = [nodeformer_graph(torch.stack([graph.edge_src, graph.edge_dst]),
                                     graph.num_nodes, device=graph.device)]
        z = self.fc_in(x)
        if self.use_bn:
            z = self.ln_in(z)
        z = self.dropout(torch.nn.functional.elu(z))
        layers = [z]
        link_losses = []
        for i in range(self.num_layers):
            z, ll = getattr(self, f"conv_{i}")(z, adjs, self.tau,
                                               None if draws is None else draws[i])
            if ll is not None:
                link_losses.append(ll)
            if self.use_residual:
                z = z + layers[i]
            if self.use_bn:
                z = getattr(self, f"ln_{i}")(z)
            if self.use_act:
                z = torch.nn.functional.elu(z)
            z = self.dropout(z)
            layers.append(z)
        if self.use_jk:
            z = torch.cat(layers, dim=-1)
        return self.fc_out(z), link_losses
