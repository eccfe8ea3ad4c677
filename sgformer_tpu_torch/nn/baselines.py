"""The large-tier baseline zoo: the port of ``sgformer_tpu/nn/baselines.py``.

Every model is a :class:`~sgformer_tpu_torch.nn.layers.GraphModel` with
``forward(x, graph, node_mask=None) -> [N, C]`` logits, so ``train.Trainer``
drives each of them as it drives SGFormer. Constructors take the input width
first (torch modules are not shaped by their first call, as flax's are),
then the JAX module's fields with its defaults, then ``generator`` (a CPU
generator for the parameters), ``dropout_generator`` and ``device``.
Submodule and parameter names are the flax names, so
:func:`sgformer_tpu_torch.convert.load_flax_variables` fills each model from
a JAX checkpoint.

On the card the models aggregate only through the port's kernels: the hop
models through :meth:`Graph.propagate` (the CSR SpMM), ``LINK`` through the
same kernel with unit weights, and ``GATConv`` through
:meth:`Graph.propagate_edge_values` (the per-edge-value SpMM forward and for
dx, the SDDMM for the values' gradient). ``H2GCN`` aggregates through
:meth:`Graph.propagate` on its two edge sets (``graph.build_h2_graphs``),
which ``train.Trainer`` passes to every forward as ``model_kwargs``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sgformer_tpu_torch.kernels import spmm as _spmm_kernel
from sgformer_tpu_torch.nn.gcn import GCNConv
from sgformer_tpu_torch.nn.layers import (
    Dropout,
    GraphModel,
    TorchLinear,
    glorot_uniform,
    uniform,
)
from sgformer_tpu_torch.nn.norm import MaskedBatchNorm
from sgformer_tpu_torch.ops.spmm import edge_softmax


class MLP(GraphModel):
    """Linear stack with BatchNorm, ReLU and dropout; the graph is unused.
    ``axis_name``: the mesh axis of node-sharded training, whose BatchNorm
    statistics all-reduce over it."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int, *,
                 num_layers: int = 2, dropout: float = 0.5, use_bn: bool = True,
                 axis_name: str | None = None, generator=None, dropout_generator=None,
                 device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        self.use_bn = use_bn
        self.dropout = Dropout(dropout)
        dims = [hidden_channels] * (num_layers - 1) + [out_channels]
        width = in_channels
        for i, d in enumerate(dims):
            self.add_module(f"lin_{i}", TorchLinear(width, d))
            if use_bn and i < num_layers - 1:
                self.add_module(f"bn_{i}", MaskedBatchNorm(d, axis_name=axis_name))
            width = d
        self.finish_init(generator, dropout_generator, device)

    def forward(self, x, graph=None, node_mask=None):
        for i in range(self.num_layers - 1):
            x = getattr(self, f"lin_{i}")(x)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x, node_mask)
            x = self.dropout(torch.relu(x))
        return getattr(self, f"lin_{self.num_layers - 1}")(x)


class LINK(GraphModel):
    """Logistic regression on adjacency rows: out[i] = sum over the edges
    j -> i of weight[j], plus bias. The sum is the CSR SpMM with unit
    weights; its gradient in ``weight`` the same kernel on the transposed
    order. ``x`` is unused."""

    FLAX_PARAMS = ("weight", "bias")

    def __init__(self, num_nodes: int, out_channels: int, *, generator=None,
                 dropout_generator=None, device="cuda"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_nodes, out_channels))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.finish_init(generator, dropout_generator, device)

    def reset_own_parameters(self, generator):
        self.weight.copy_(uniform(tuple(self.weight.shape), self.weight.shape[0] ** -0.5,
                                  generator))
        self.bias.zero_()

    def forward(self, x, graph, node_mask=None):
        ones = torch.ones(graph.num_edges, device=self.weight.device)
        agg = _spmm_kernel.csr_spmm_autograd(
            self.weight, (graph.indptr, graph.edge_src, graph.edge_dst, ones),
            (graph.t_indptr, graph.t_edge_src, graph.t_edge_dst, ones),
            graph.hub_segments, graph.t_hub_segments, graph.hub_edges, *graph.walk_orders)
        return agg + self.bias


class SGC(GraphModel):
    """K-hop propagated features, then one linear. Hop by hop, so A^K is
    never formed, which is also what the reference's SGCMem computes."""

    def __init__(self, in_channels: int, out_channels: int, *, hops: int = 2,
                 generator=None, dropout_generator=None, device="cuda"):
        super().__init__()
        self.hops = hops
        self.lin = TorchLinear(in_channels, out_channels)
        self.finish_init(generator, dropout_generator, device)

    def forward(self, x, graph, node_mask=None):
        for _ in range(self.hops):
            x = graph.propagate(x, kind="gcn")
        return self.lin(x)


class SGCMem(SGC):
    """SGC computed hop by hop to bound memory: the base class already is."""


class SGC2(GraphModel):
    """K-hop propagation, then an MLP (``axis_name``: as :class:`MLP`'s)."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int, *,
                 hops: int = 2, num_layers: int = 2, dropout: float = 0.5,
                 use_bn: bool = True, axis_name: str | None = None, generator=None,
                 dropout_generator=None, device="cuda"):
        super().__init__()
        self.hops = hops
        self.mlp = MLP(in_channels, hidden_channels, out_channels, num_layers=num_layers,
                       dropout=dropout, use_bn=use_bn, axis_name=axis_name, device=device)
        self.finish_init(generator, dropout_generator, device)

    def forward(self, x, graph, node_mask=None):
        for _ in range(self.hops):
            x = graph.propagate(x, kind="gcn")
        return self.mlp(x, graph, node_mask=node_mask)


class SIGN(GraphModel):
    """[x, Ax, ..., A^K x] through one linear each, summed (the first linear
    of the reference on their concatenation), then BatchNorm, ReLU, dropout
    and the remaining linears; ``num_layers`` counts all linears
    (``axis_name``: the mesh axis its BatchNorm statistics reduce over)."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int, *,
                 hops: int = 2, num_layers: int = 2, dropout: float = 0.5,
                 use_bn: bool = True, axis_name: str | None = None, generator=None,
                 dropout_generator=None, device="cuda"):
        super().__init__()
        self.hops = hops
        self.use_bn = use_bn
        self.n_lins = max(num_layers, 2)
        self.dropout = Dropout(dropout)
        for k in range(hops + 1):
            self.add_module(f"hop_{k}", TorchLinear(in_channels, hidden_channels))
        for i in range(1, self.n_lins):
            if use_bn:
                self.add_module(f"bn_{i - 1}", MaskedBatchNorm(hidden_channels,
                                                               axis_name=axis_name))
            width = out_channels if i == self.n_lins - 1 else hidden_channels
            self.add_module(f"lin_{i}", TorchLinear(hidden_channels, width))
        self.finish_init(generator, dropout_generator, device)

    def forward(self, x, graph, node_mask=None):
        h = x
        z = self.hop_0(h)
        for k in range(1, self.hops + 1):
            h = graph.propagate(h, kind="gcn")
            z = z + getattr(self, f"hop_{k}")(h)
        for i in range(1, self.n_lins):
            if self.use_bn:
                z = getattr(self, f"bn_{i - 1}")(z, node_mask)
            z = self.dropout(torch.relu(z))
            z = getattr(self, f"lin_{i}")(z)
        return z


class GATConv(nn.Module):
    """PyG ``GATConv``: per-head linear, additive attention with LeakyReLU,
    per-destination edge softmax, attention-coefficient dropout, and the
    weighted aggregation through :meth:`Graph.propagate_edge_values`. Heads
    are concatenated (``concat``) or averaged; the bias is added after.
    Self-loops come from the graph's edge set."""

    FLAX_PARAMS = ("att_src", "att_dst", "bias")

    def __init__(self, in_channels: int, out_channels: int, *, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2, dropout: float = 0.0):
        super().__init__()
        self.heads, self.out_channels = heads, out_channels
        self.concat = concat
        self.negative_slope = negative_slope
        self.lin = TorchLinear(in_channels, heads * out_channels, bias=False)
        self.att_src = nn.Parameter(torch.empty(1, heads, out_channels))
        self.att_dst = nn.Parameter(torch.empty(1, heads, out_channels))
        self.bias = nn.Parameter(torch.empty(heads * out_channels if concat else out_channels))
        self.att_dropout = Dropout(dropout)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's ``glorot_uniform`` of (1, H, D) for the attention vectors
        (fan_in H, fan_out D), a zero bias; ``lin`` draws its own."""
        self.att_src.copy_(glorot_uniform(tuple(self.att_src.shape), generator))
        self.att_dst.copy_(glorot_uniform(tuple(self.att_dst.shape), generator))
        self.bias.zero_()

    def forward(self, x, graph):
        h = self.lin(x).reshape(-1, self.heads, self.out_channels)
        alpha_src = (h * self.att_src.to(h.dtype)).sum(-1)  # [N, H]
        alpha_dst = (h * self.att_dst.to(h.dtype)).sum(-1)
        src, dst = graph.edge_src.long(), graph.edge_dst.long()
        e = F.leaky_relu(alpha_src[src] + alpha_dst[dst], self.negative_slope)
        w = self.att_dropout(edge_softmax(e, graph.edge_dst, graph.num_nodes))
        out = graph.propagate_edge_values(h, w.float())
        if self.concat:
            return out.reshape(-1, self.heads * self.out_channels) + self.bias.to(out.dtype)
        return out.mean(dim=1) + self.bias.to(out.dtype)


class GAT(GraphModel):
    """GATConv stack: heads concatenated on the hidden layers and averaged
    on the last; input dropout, then BatchNorm, ELU and dropout between
    layers; attention-coefficient dropout at the same rate.

    ``axis_name`` (node-sharded training) is refused: a node shard's graph
    has no per-edge-value aggregation, in this package as in the JAX one
    (whose ``ShardGraph`` has no ``propagate_edge_values``)."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int, *,
                 num_layers: int = 2, heads: int = 2, out_heads: int = 1,
                 dropout: float = 0.5, use_bn: bool = True, axis_name: str | None = None,
                 generator=None, dropout_generator=None, device="cuda"):
        if axis_name is not None:
            raise ValueError("GAT cannot train node-sharded (axis_name): a shard's graph has "
                             "no per-edge-value aggregation")
        super().__init__()
        self.num_layers = num_layers
        self.use_bn = use_bn
        self.dropout = Dropout(dropout)
        width = in_channels
        for i in range(num_layers - 1):
            self.add_module(f"conv_{i}", GATConv(width, hidden_channels, heads=heads,
                                                 dropout=dropout))
            width = hidden_channels * heads
            if use_bn:
                self.add_module(f"bn_{i}", MaskedBatchNorm(width))
        self.add_module(f"conv_{num_layers - 1}", GATConv(
            width, out_channels, heads=out_heads, concat=False, dropout=dropout))
        self.finish_init(generator, dropout_generator, device)

    def forward(self, x, graph, node_mask=None):
        x = self.dropout(x)
        for i in range(self.num_layers - 1):
            x = getattr(self, f"conv_{i}")(x, graph)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x, node_mask)
            x = self.dropout(F.elu(x))
        return getattr(self, f"conv_{self.num_layers - 1}")(x, graph)


class MixHopLayer(nn.Module):
    """Concatenation over j = 0..hops of ``(A^j x) W_j + (A^j 1) b_j``: the
    reference applies each linear before propagating, so its bias rides
    through the powers of A; the propagated ones column carries it."""

    def __init__(self, in_channels: int, out_channels: int, *, hops: int = 2):
        super().__init__()
        self.hops = hops
        self.FLAX_PARAMS = tuple(f"lin_{j}_{part}" for j in range(hops + 1)
                                 for part in ("kernel", "bias"))
        for j in range(hops + 1):
            self.register_parameter(f"lin_{j}_kernel",
                                    nn.Parameter(torch.empty(in_channels, out_channels)))
            self.register_parameter(f"lin_{j}_bias", nn.Parameter(torch.empty(out_channels)))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every kernel and bias."""
        bound = 1.0 / math.sqrt(self.lin_0_kernel.shape[0])
        for name in self.FLAX_PARAMS:
            p = getattr(self, name)
            p.copy_(uniform(tuple(p.shape), bound, generator))

    def forward(self, x, graph):
        h = x
        r = torch.ones(x.shape[0], 1, dtype=x.dtype, device=x.device)
        outs = []
        for j in range(self.hops + 1):
            if j > 0:
                h = graph.propagate(h, kind="gcn")
                r = graph.propagate(r, kind="gcn")
            kernel = getattr(self, f"lin_{j}_kernel").to(h.dtype)
            bias = getattr(self, f"lin_{j}_bias").to(h.dtype)
            outs.append(h @ kernel + r * bias[None, :])
        return torch.cat(outs, dim=1)


class MixHop(GraphModel):
    """MixHopLayer stack and a final projection; the last layer maps to
    ``out_channels`` and joins the projection with no BatchNorm, ReLU or
    dropout (``axis_name``: the mesh axis its BatchNorm statistics reduce
    over)."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int, *,
                 num_layers: int = 2, hops: int = 2, dropout: float = 0.5,
                 use_bn: bool = True, axis_name: str | None = None, generator=None,
                 dropout_generator=None, device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        self.use_bn = use_bn
        self.dropout = Dropout(dropout)
        width = in_channels
        for i in range(num_layers):
            last = i == num_layers - 1
            out = out_channels if last else hidden_channels
            self.add_module(f"mix_{i}", MixHopLayer(width, out, hops=hops))
            width = out * (hops + 1)
            if not last and use_bn:
                self.add_module(f"bn_{i}", MaskedBatchNorm(width, axis_name=axis_name))
        self.final = TorchLinear(width, out_channels)
        self.finish_init(generator, dropout_generator, device)

    def forward(self, x, graph, node_mask=None):
        for i in range(self.num_layers):
            x = getattr(self, f"mix_{i}")(x, graph)
            if i < self.num_layers - 1:
                if self.use_bn:
                    x = getattr(self, f"bn_{i}")(x, node_mask)
                x = self.dropout(torch.relu(x))
        return self.final(x)


class _JumpingKnowledge(GraphModel):
    """A conv stack whose layer outputs are joined (``jk_type`` 'cat' or
    'max') before a final linear; the last conv's output joins raw, the
    others after BatchNorm and the activation ``act`` (dropout follows the
    join)."""

    def _jk_init(self, convs, act, width: int, out_channels: int, num_layers: int,
                 dropout: float, use_bn: bool, jk_type: str,
                 axis_name: str | None = None) -> None:
        if jk_type not in ("cat", "max"):
            raise ValueError(f"jk_type must be 'cat' or 'max', got {jk_type!r}")
        self.act = act
        self.num_layers = num_layers
        self.use_bn = use_bn
        self.jk_type = jk_type
        self.dropout = Dropout(dropout)
        for i, conv in enumerate(convs):
            self.add_module(f"conv_{i}", conv)
            if use_bn and i < num_layers - 1:
                self.add_module(f"bn_{i}", MaskedBatchNorm(width, axis_name=axis_name))
        self.final = TorchLinear(width * num_layers if jk_type == "cat" else width,
                                 out_channels)

    def forward(self, x, graph, node_mask=None):
        xs = []
        for i in range(self.num_layers):
            x = getattr(self, f"conv_{i}")(x, graph)
            if i < self.num_layers - 1:
                if self.use_bn:
                    x = getattr(self, f"bn_{i}")(x, node_mask)
                x = self.act(x)
                xs.append(x)
                x = self.dropout(x)
            else:
                xs.append(x)
        z = torch.stack(xs).amax(dim=0) if self.jk_type == "max" else torch.cat(xs, dim=1)
        return self.final(z)


class GCNJK(_JumpingKnowledge):
    """GCN stack (``GCNConv`` on the PyG edges) with jumping knowledge
    (``axis_name``: the mesh axis its BatchNorm statistics reduce over)."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int, *,
                 num_layers: int = 2, dropout: float = 0.5, use_bn: bool = True,
                 jk_type: str = "cat", axis_name: str | None = None, generator=None,
                 dropout_generator=None, device="cuda"):
        super().__init__()
        convs = [GCNConv(in_channels if i == 0 else hidden_channels, hidden_channels)
                 for i in range(num_layers)]
        self._jk_init(convs, torch.relu, hidden_channels, out_channels, num_layers, dropout,
                      use_bn, jk_type, axis_name)
        self.finish_init(generator, dropout_generator, device)


class GATJK(_JumpingKnowledge):
    """GAT stack (heads concatenated, no attention dropout) with jumping
    knowledge."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int, *,
                 num_layers: int = 2, heads: int = 2, dropout: float = 0.5,
                 use_bn: bool = True, jk_type: str = "cat", generator=None,
                 dropout_generator=None, device="cuda"):
        super().__init__()
        width = hidden_channels * heads
        convs = [GATConv(in_channels if i == 0 else width, hidden_channels, heads=heads)
                 for i in range(num_layers)]
        self._jk_init(convs, F.elu, width, out_channels, num_layers, dropout, use_bn, jk_type)
        self.finish_init(generator, dropout_generator, device)


class APPNP(GraphModel):
    """Two-layer MLP, then K personalised-PageRank steps
    z <- (1 - alpha) A z + alpha h."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int, *,
                 dropout: float = 0.5, K: int = 10, alpha: float = 0.1,
                 generator=None, dropout_generator=None, device="cuda"):
        super().__init__()
        self.K, self.alpha = K, alpha
        self.dropout = Dropout(dropout)
        self.lin1 = TorchLinear(in_channels, hidden_channels)
        self.lin2 = TorchLinear(hidden_channels, out_channels)
        self.finish_init(generator, dropout_generator, device)

    def forward(self, x, graph, node_mask=None):
        x = self.dropout(torch.relu(self.lin1(self.dropout(x))))
        h = self.lin2(x)
        z = h
        for _ in range(self.K):
            z = (1 - self.alpha) * graph.propagate(z, kind="gcn") + self.alpha * h
        return z


class GPRGNN(GraphModel):
    """MLP, then learned per-hop weights gamma_k over A^k h, initialised to
    personalised PageRank: gamma_k = alpha (1 - alpha)^k, gamma_K =
    (1 - alpha)^K."""

    FLAX_PARAMS = ("gamma",)

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int, *,
                 dropout: float = 0.5, dprate: float = 0.5, K: int = 10, alpha: float = 0.1,
                 generator=None, dropout_generator=None, device="cuda"):
        super().__init__()
        self.K, self.alpha = K, alpha
        self.dropout = Dropout(dropout)
        self.dprop = Dropout(dprate)
        self.lin1 = TorchLinear(in_channels, hidden_channels)
        self.lin2 = TorchLinear(hidden_channels, out_channels)
        self.gamma = nn.Parameter(torch.empty(K + 1))
        self.finish_init(generator, dropout_generator, device)

    def reset_own_parameters(self, generator):
        k = torch.arange(self.K + 1, dtype=torch.float64)
        gamma = self.alpha * (1 - self.alpha) ** k
        gamma[-1] = (1 - self.alpha) ** self.K
        self.gamma.copy_(gamma.float())

    def forward(self, x, graph, node_mask=None):
        x = self.dropout(torch.relu(self.lin1(self.dropout(x))))
        h = self.dprop(self.lin2(x))
        z = self.gamma[0] * h
        for k in range(1, self.K + 1):
            h = graph.propagate(h, kind="gcn")
            z = z + self.gamma[k] * h
        return z


class H2GCN(GraphModel):
    """Heterophily GCN: ego and neighbour embeddings kept apart over the
    self-loop-free 1-hop (A1) and exact 2-hop (A2) neighbourhoods, each
    round's two aggregations concatenated, every round's output joined for
    the classifier. ``h2_graphs=(a1, a2)`` comes from
    :func:`sgformer_tpu_torch.graph.build_h2_graphs`; both aggregations run
    through :meth:`Graph.propagate` (the CSR SpMM kernel on the card).

    As in the JAX module, the head keeps the reference's: bias-free
    ``w_embed`` [in, hidden] and ``w_classify`` (flax's
    ``xavier_uniform``, stored in the flax layout and applied as
    ``x @ w``) and a softmax output, on which the trainer's log_softmax
    then runs. The graph argument is unused."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int, *,
                 num_layers: int = 2, dropout: float = 0.5, relu: bool = True,
                 softmax_output: bool = True, generator=None, dropout_generator=None,
                 device="cuda"):
        super().__init__()
        self.FLAX_PARAMS = ("w_embed", "w_classify")
        self.num_layers = num_layers
        self.relu = relu
        self.softmax_output = softmax_output
        self.dropout = Dropout(dropout)
        # each round doubles the width; z joins every round's output
        width = hidden_channels * (2 ** (num_layers + 1) - 1)
        self.w_embed = nn.Parameter(torch.empty(in_channels, hidden_channels))
        self.w_classify = nn.Parameter(torch.empty(width, out_channels))
        self.finish_init(generator, dropout_generator, device)

    def reset_own_parameters(self, generator):
        for p in (self.w_embed, self.w_classify):
            p.copy_(glorot_uniform(tuple(p.shape), generator))

    def forward(self, x, graph=None, node_mask=None, h2_graphs=None):
        if h2_graphs is None:
            raise ValueError("H2GCN needs h2_graphs=(a1_graph, a2_graph) from "
                             "sgformer_tpu_torch.graph.build_h2_graphs")
        a1, a2 = h2_graphs
        h = x @ self.w_embed.to(x.dtype)
        if self.relu:
            h = torch.relu(h)
        outs = [h]
        for _ in range(self.num_layers):
            h = torch.cat([a1.propagate(h, kind="gcn"), a2.propagate(h, kind="gcn")], dim=1)
            outs.append(h)
        z = self.dropout(torch.cat(outs, dim=1))
        logits = z @ self.w_classify.to(z.dtype)
        return torch.softmax(logits, dim=-1) if self.softmax_output else logits


class MultiLP:
    """Multi-hop label propagation, parameter-free: seed y from the train
    labels, then ``num_iters`` times z <- alpha A^hops z + (1 - alpha) y.
    [N, 1] int labels seed one-hot rows; a multilabel float [N, T] seeds as
    it is, or with ``mult_bin`` one 2-way one-hot pair per task, whose
    positive column is read back out."""

    def __init__(self, out_channels: int, alpha: float = 0.5, hops: int = 2,
                 num_iters: int = 50, mult_bin: bool = False):
        self.out_channels = out_channels
        self.alpha = alpha
        self.hops = hops
        self.num_iters = num_iters
        self.mult_bin = mult_bin

    @torch.no_grad()
    def predict(self, graph, label, train_idx) -> torch.Tensor:
        """[N, C] propagated label scores (f32, on the graph's device)."""
        dev = graph.device
        label = torch.as_tensor(label).to(dev)
        train_idx = torch.as_tensor(train_idx, dtype=torch.long).to(dev)
        if label.dim() == 1 or label.shape[1] == 1:
            seed = F.one_hot(label.reshape(-1)[train_idx].long(), self.out_channels).float()
        elif self.mult_bin:
            seed = torch.cat([F.one_hot(label[train_idx, t].long(), 2).float()
                              for t in range(label.shape[1])], dim=1)
        else:
            seed = label[train_idx].float()
        y = torch.zeros(graph.num_nodes, seed.shape[1], device=dev)
        y[train_idx] = seed
        z = y
        for _ in range(self.num_iters):
            for _ in range(self.hops):
                z = graph.propagate(z, kind="gcn")
            z = self.alpha * z + (1 - self.alpha) * y
        if self.mult_bin and label.dim() > 1 and label.shape[1] > 1:
            z = z[:, 1::2]
        return z
