"""The plain reference of SGFormer (Wu et al., NeurIPS 2023; the reference
code's ``large/`` tier): the large tier's model, its loss and an Adam
step, in plain PyTorch, f32, TF32 off.

It imports nothing of the program and takes nothing the program made: it
builds the normalised graph from the raw edges, the batch subgraphs from
the batch's node ids, and reads only the weights and inputs the benchmark
drew. Dropout masks are drawn from a generator seeded as the one the
benchmark hands the program, one ``torch.rand`` of the activation's shape a
dropout, in the model's order (the attention branch, then the GNN branch).

``precision`` selects the arithmetic: ``"f32"`` is the reference;
``"fp8"`` and ``"tf32"`` are the controls, the reference computed one step
below the precision a configuration states. ``"fp8"`` rounds every
activation, weight and activation gradient where a bf16 model holds them in
bf16 to float8 e4m3 with one absmax scale a tensor; ``"tf32"`` runs every
matrix product in TF32.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
NORM_EPS = 1e-5
FP8_MAX = 448.0


# -- parameters ----------------------------------------------------------------


def param_spec(model: dict, in_channels: int) -> list:
    """The model's leaves as (name, shape, low, high): each drawn uniform in
    [low, high]. Names are the program's state-dict keys. Dense layers take
    PyTorch's default U(-1/sqrt(fan_in), 1/sqrt(fan_in)); norm scales U(0.8,
    1.2) and shifts U(-0.1, 0.1); BatchNorm running means U(-0.1, 0.1) and
    variances U(0.8, 1.2), which only an eval-mode forward reads."""
    h = model["hidden_channels"]
    heads = model.get("trans_num_heads", 1)
    spec = []

    def dense(name, fan_in, out):
        b = 1.0 / math.sqrt(fan_in)
        spec.extend([(f"{name}.weight", (out, fan_in), -b, b), (f"{name}.bias", (out,), -b, b)])

    def norm(name, batch):
        spec.extend([(f"{name}.weight", (h,), 0.8, 1.2), (f"{name}.bias", (h,), -0.1, 0.1)])
        if batch:
            spec.extend([(f"{name}.running_mean", (h,), -0.1, 0.1),
                         (f"{name}.running_var", (h,), 0.8, 1.2)])

    dense("trans_conv.fc_in", in_channels, h)
    norm("trans_conv.ln_in", False)
    for i in range(model["trans_num_layers"]):
        for w in ("Wq", "Wk", "Wv"):
            dense(f"trans_conv.conv_{i}.{w}", h, h * heads)
        norm(f"trans_conv.ln_{i}", False)
    dense("graph_conv.fc_in", in_channels, h)
    norm("graph_conv.bn_in", True)
    w_in = 2 * h if model.get("gnn_use_init", False) else h
    for i in range(model["gnn_num_layers"]):
        dense(f"graph_conv.conv_{i}.W", w_in, h)
        norm(f"graph_conv.bn_{i}", True)
    dense("fc", h, model["out_channels"])
    return spec


def draw_weights(model: dict, in_channels: int, seed: int, device) -> dict:
    """Every leaf of :func:`param_spec` from one ``torch.rand`` on the device
    seeded ``seed``, as f32 tensors by name."""
    spec = param_spec(model, in_channels)
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, lo, hi in spec:
        k = math.prod(shape)
        out[name] = (lo + (hi - lo) * flat[at:at + k]).view(shape).clone()
        at += k
    return out


def is_buffer(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


# -- graphs ----------------------------------------------------------------------


def symmetric_edges(edge_index: torch.Tensor, num_nodes: int) -> tuple:
    """The raw edges made undirected, duplicates and self-loops removed, one
    self-loop a node added: (src, dst) int64."""
    src, dst = edge_index[0].long(), edge_index[1].long()
    s = torch.cat([src, dst])
    d = torch.cat([dst, src])
    keep = s != d
    key = torch.unique(d[keep] * num_nodes + s[keep])
    loop = torch.arange(num_nodes, device=edge_index.device)
    return torch.cat([key % num_nodes, loop]), torch.cat([key // num_nodes, loop])


def gcn_csr(src: torch.Tensor, dst: torch.Tensor, num_nodes: int) -> tuple:
    """(src, dst, weight) with weight = 1/sqrt(d_in[src] d_in[dst]) in f64,
    then f32, d_in counted over dst."""
    deg = torch.bincount(dst, minlength=num_nodes).double()
    dinv = torch.where(deg > 0, deg.rsqrt(), torch.zeros_like(deg))
    return src, dst, (dinv[src] * dinv[dst]).float()


def induced_csr(src: torch.Tensor, dst: torch.Tensor, nodes: torch.Tensor,
                num_nodes: int) -> tuple:
    """The subgraph on ``nodes`` (edges with both ends in it, relabelled to
    positions in ``nodes``), normalised on itself."""
    pos = torch.full((num_nodes,), -1, dtype=torch.long, device=src.device)
    pos[nodes] = torch.arange(nodes.numel(), device=src.device)
    ps, pd = pos[src], pos[dst]
    keep = (ps >= 0) & (pd >= 0)
    return gcn_csr(ps[keep], pd[keep], nodes.numel())


# -- precision ---------------------------------------------------------------------


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax()
    if not torch.isfinite(amax) or amax == 0:
        return t
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _RoundFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _fp8(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


class Precision:
    """Where the arithmetic is rounded. ``cast`` is applied wherever a model
    of the configured type holds a tensor in that type."""

    def __init__(self, mode: str):
        if mode not in ("f32", "fp8", "tf32"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        return _RoundFP8.apply(t) if self.mode == "fp8" else t

    @contextlib.contextmanager
    def matmuls(self):
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.mode == "tf32"
        torch.backends.cudnn.allow_tf32 = self.mode == "tf32"
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def control_precision(compute_dtype: str) -> str:
    """The control of a configuration: one step below its stated type."""
    return {"bf16": "fp8", "f32": "tf32"}[compute_dtype]


# -- the model ---------------------------------------------------------------------


class Reference:
    """SGFormer's large tier on one graph, plain PyTorch.

    ``model``: a configuration's ``model`` section; ``weights``: the leaves
    by name (copied, f32, trained in place by :meth:`adam_step`)."""

    def __init__(self, model: dict, weights: dict, precision: str = "f32"):
        self.cfg = model
        self.p = {k: v.detach().clone().float() for k, v in weights.items()}
        self.prec = Precision(precision)
        self.low = model["compute_dtype"] == "bf16"
        self.state: dict = {}
        self.t = 0

    def leaves(self) -> list:
        return [k for k in self.p if not is_buffer(k)]

    def _c(self, t):
        return self.prec.cast(t) if self.low else t

    def _w(self, name, params):
        return self._c(params[name])

    def _dense(self, x, name, params):
        y = self._c(x @ self._w(f"{name}.weight", params).t())
        return self._c(y + self._w(f"{name}.bias", params))

    def _layer_norm(self, x, name, params):
        y = F.layer_norm(x, (x.shape[1],), params[f"{name}.weight"], params[f"{name}.bias"],
                         NORM_EPS)
        return self._c(y)

    def _batch_norm(self, x, name, params, train):
        if train:
            mean = x.mean(dim=0)
            var = ((x - mean) ** 2).mean(dim=0)
        else:
            mean, var = params[f"{name}.running_mean"], params[f"{name}.running_var"]
        y = (x - mean) * torch.rsqrt(var + NORM_EPS)
        return self._c(y * params[f"{name}.weight"] + params[f"{name}.bias"])

    def _dropout(self, x, rate, gen):
        if gen is None or rate == 0.0:
            return x
        keep = 1.0 - rate
        mask = torch.rand(x.shape, device=x.device, generator=gen) < keep
        return self._c(torch.where(mask, x / keep, torch.zeros_like(x)))

    def _attention(self, x, i, params):
        n = x.shape[0]
        heads = self.cfg.get("trans_num_heads", 1)
        h = self.cfg["hidden_channels"]
        q = self._dense(x, f"trans_conv.conv_{i}.Wq", params).view(n, heads, h)
        k = self._dense(x, f"trans_conv.conv_{i}.Wk", params).view(n, heads, h)
        v = self._dense(x, f"trans_conv.conv_{i}.Wv", params).view(n, heads, h)
        inv = torch.rsqrt((q * q).sum()) * torch.rsqrt((k * k).sum())
        outs = []
        for j in range(heads):
            qj, kj, vj = q[:, j], k[:, j], v[:, j]
            kvs = kj.t() @ vj
            num = inv * (qj @ kvs) + n * vj
            den = inv * (qj @ kj.sum(dim=0)) + n
            outs.append(self._c(num / den[:, None]))
        return outs[0] if heads == 1 else self._c(torch.stack(outs, dim=1).mean(dim=1))

    def _spmm(self, x, csr, n):
        src, dst, w = csr
        out = torch.zeros(n, x.shape[1], dtype=x.dtype, device=x.device)
        return self._c(out.index_add(0, dst, x[src] * w[:, None]))

    def forward(self, x, csr, *, train: bool, gen=None, params=None):
        """[n, C] f32 logits of the features ``x`` on the graph ``csr``
        ((src, dst, weight) over n nodes); train mode draws dropout masks
        from ``gen`` and takes BatchNorm statistics from the batch."""
        cfg, params = self.cfg, params if params is not None else self.p
        n = x.shape[0]
        gen = gen if train else None
        with self.prec.matmuls():
            x = self._c(x)
            t = self._dense(x, "trans_conv.fc_in", params)
            t = self._layer_norm(t, "trans_conv.ln_in", params)
            t = self._dropout(torch.relu(t), cfg["trans_dropout"], gen)
            prev = t
            for i in range(cfg["trans_num_layers"]):
                t = self._attention(t, i, params)
                t = self._c((t + prev) / 2.0)
                t = self._layer_norm(t, f"trans_conv.ln_{i}", params)
                t = self._dropout(torch.relu(t), cfg["trans_dropout"], gen)
                prev = t
            g = self._dense(x, "graph_conv.fc_in", params)
            g = self._batch_norm(g, "graph_conv.bn_in", params, train)
            g = self._dropout(torch.relu(g), cfg["gnn_dropout"], gen)
            x0 = g
            for i in range(cfg["gnn_num_layers"]):
                g = self._spmm(g, csr, n)
                if cfg.get("gnn_use_init", False):
                    g = torch.cat([g, x0], dim=1)
                g = self._dense(g, f"graph_conv.conv_{i}.W", params)
                g = self._batch_norm(g, f"graph_conv.bn_{i}", params, train)
                g = self._dropout(torch.relu(g), cfg["gnn_dropout"], gen)
                g = self._c(g + x0)
            gw = cfg["graph_weight"]
            out = self._c(self._c(gw * g) + self._c((1.0 - gw) * t))
            return self._dense(out, "fc", params).float()

    @staticmethod
    def loss(logits, label, mask, denominator):
        """sum of the NLL over the nodes ``mask`` marks, over
        ``denominator``."""
        nll = -torch.log_softmax(logits, dim=-1).gather(1, label[:, None]).squeeze(1)
        return (nll * mask).sum() / denominator

    def grads(self, x, csr, label, mask, denominator, gen) -> tuple:
        """The loss of a train-mode forward and its gradient by leaf."""
        params = {k: (v.clone().requires_grad_(True) if not is_buffer(k) else v)
                  for k, v in self.p.items()}
        loss = self.loss(self.forward(x, csr, train=True, gen=gen, params=params),
                         label, mask, denominator)
        leaves = self.leaves()
        grads = torch.autograd.grad(loss, [params[k] for k in leaves])
        return loss.detach(), dict(zip(leaves, grads))

    def adam_step(self, grads: dict, lr: float, decay: dict) -> dict:
        """One Adam step with L2 decay ``decay[leaf]`` added to its gradient
        (torch.optim.Adam's rule); returns the gradients as the optimizer
        got them."""
        self.t += 1
        b1, b2 = BETAS
        got = {}
        for k, g in grads.items():
            g = g + decay.get(k, 0.0) * self.p[k] if decay.get(k, 0.0) else g
            got[k] = g
            m, v = self.state.get(k, (torch.zeros_like(g), torch.zeros_like(g)))
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            self.state[k] = (m, v)
            denom = (v.sqrt() / math.sqrt(1 - b2 ** self.t)) + ADAM_EPS
            self.p[k] = self.p[k] - (lr / (1 - b1 ** self.t)) * m / denom
        return got


def branch_decay(leaves, train: dict) -> dict:
    """The recipe's L2 decay of each leaf: the attention branch's on
    ``trans_conv.*``, the GNN branch's on everything else."""
    return {k: (train["trans_weight_decay"] if k.startswith("trans_conv.")
                else train["gnn_weight_decay"]) for k in leaves}
