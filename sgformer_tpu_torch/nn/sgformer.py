"""SGFormer: linear-attention branch + GNN branch + fusion head. The port of
``sgformer_tpu/nn/sgformer.py``.

``SGFormerConfig`` is the JAX package's config, field for field, so one
config describes a model in both packages. The port covers every ``gnn``
(``"graphconv"``, ``"gcn"``, the medium tier's backbone on the PyG edges,
and ``"none"``). With ``axis_name`` the model runs on one rank's node shard
of a :class:`sgformer_tpu_torch.parallel.ShardGraph`: the attention's node
sums and the BatchNorm statistics are all-reduced over that mesh axis
(:mod:`sgformer_tpu_torch.parallel`). Parameters and norm statistics are f32; with
``compute_dtype="bf16"`` the activations are bf16; the logits are f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from sgformer_tpu_torch.device import resolve_device
from sgformer_tpu_torch.nn.gcn import GCN
from sgformer_tpu_torch.nn.graphconv import GraphConv
from sgformer_tpu_torch.nn.layers import GraphModel, TorchLinear
from sgformer_tpu_torch.nn.transconv import TransConv


@dataclasses.dataclass(frozen=True)
class SGFormerConfig:
    hidden_channels: int
    out_channels: int
    # attention branch
    trans_num_layers: int = 2
    trans_num_heads: int = 1
    trans_dropout: float = 0.5
    trans_use_bn: bool = True
    trans_use_residual: bool = True
    trans_use_weight: bool = True
    trans_use_act: bool = False
    trans_residual_mode: str = "alpha"  # 'alpha' (medium/100M) | 'mean' (large)
    # attention ablation: 'simple' | 'softmax' | 'gat' | 'performer'
    attention_kernel: str = "simple"
    # the JAX package's choice between its XLA and Pallas attention; the
    # port has one path per device (the kernels on CUDA, the plain version
    # on the CPU), so any of 'auto' | 'xla' | 'pallas' runs the same code
    attention_impl: str = "auto"
    alpha: float = 0.5
    # gnn branch
    gnn: str = "graphconv"  # 'graphconv' | 'gcn' | 'none'
    gnn_num_layers: int = 2
    gnn_dropout: float = 0.5
    gnn_use_bn: bool = True
    gnn_use_residual: bool = True
    gnn_use_weight: bool = True
    gnn_use_init: bool = False
    gnn_use_act: bool = True
    # fusion
    graph_weight: float = 0.8
    aggregate: str = "add"  # 'add' | 'cat'
    # mesh axis of node sharding (None = one device; parallel.make_mesh)
    axis_name: Optional[str] = None
    # 'f32' or 'bf16' activations
    compute_dtype: str = "f32"
    # recompute each TransConvLayer and GraphConvLayer in the backward pass
    # (torch.utils.checkpoint) instead of keeping their activations
    remat: bool = False

    @classmethod
    def medium(cls, hidden, out, **kw):
        kw.setdefault("gnn", "gcn")
        kw.setdefault("trans_residual_mode", "alpha")
        kw.setdefault("trans_use_act", False)
        return cls(hidden, out, **kw)

    @classmethod
    def large(cls, hidden, out, **kw):
        kw.setdefault("gnn", "graphconv")
        kw.setdefault("trans_residual_mode", "mean")
        kw.setdefault("trans_use_act", True)
        kw.setdefault("trans_num_layers", 1)
        kw.setdefault("gnn_num_layers", 1)
        return cls(hidden, out, **kw)

    @classmethod
    def papers100m(cls, hidden, out, **kw):
        kw.setdefault("gnn", "graphconv")
        kw.setdefault("trans_residual_mode", "alpha")
        kw.setdefault("trans_use_act", True)
        kw.setdefault("trans_num_layers", 1)
        kw.setdefault("gnn_num_layers", 1)
        return cls(hidden, out, **kw)


_COMPUTE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


class SGFormer(GraphModel):
    """SGFormer for ``in_channels``-wide node features.

    Parameters are drawn from ``generator`` (a CPU ``torch.Generator``; a
    new one seeded 0 when None) and then placed on ``device``. Dropout masks
    in train mode are drawn from ``dropout_generator``, a ``torch.Generator``
    on ``device`` (or one set later by :meth:`set_dropout_generator`); a
    train-mode forward that would draw a mask without one raises. Submodule
    names follow the flax module's, so
    :func:`sgformer_tpu_torch.convert.load_flax_variables` maps a JAX
    checkpoint onto it by name.
    """

    def __init__(self, config: SGFormerConfig, in_channels: int, *,
                 generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        cfg = config
        dev = resolve_device(device)
        if cfg.gnn not in ("graphconv", "gcn", "none"):
            raise ValueError(f"Invalid gnn type: {cfg.gnn}")
        if cfg.aggregate not in ("add", "cat"):
            raise ValueError(f"Invalid aggregate type: {cfg.aggregate}")
        if cfg.compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}")
        if cfg.attention_impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.config = cfg
        self.compute_dtype = _COMPUTE_DTYPES[cfg.compute_dtype]
        hidden = cfg.hidden_channels
        self.trans_conv = TransConv(
            in_channels, hidden,
            num_layers=cfg.trans_num_layers,
            num_heads=cfg.trans_num_heads,
            alpha=cfg.alpha,
            dropout=cfg.trans_dropout,
            use_bn=cfg.trans_use_bn,
            use_residual=cfg.trans_use_residual,
            use_weight=cfg.trans_use_weight,
            use_act=cfg.trans_use_act,
            residual_mode=cfg.trans_residual_mode,
            kernel=cfg.attention_kernel,
            remat=cfg.remat,
            axis_name=cfg.axis_name,
            generator=generator,
        )
        if cfg.gnn == "graphconv":
            self.graph_conv = GraphConv(
                in_channels, hidden,
                num_layers=cfg.gnn_num_layers,
                dropout=cfg.gnn_dropout,
                use_bn=cfg.gnn_use_bn,
                use_residual=cfg.gnn_use_residual,
                use_weight=cfg.gnn_use_weight,
                use_init=cfg.gnn_use_init,
                use_act=cfg.gnn_use_act,
                remat=cfg.remat,
                axis_name=cfg.axis_name,
                generator=generator,
            )
        elif cfg.gnn == "gcn":
            self.gcn = GCN(in_channels, hidden, hidden, num_layers=cfg.gnn_num_layers,
                           dropout=cfg.gnn_dropout, use_bn=cfg.gnn_use_bn,
                           axis_name=cfg.axis_name, generator=generator, device=dev)
        fc_in = 2 * hidden if cfg.gnn != "none" and cfg.aggregate == "cat" else hidden
        self.fc = TorchLinear(fc_in, cfg.out_channels, generator=generator)
        self.set_dropout_generator(dropout_generator)
        self.to(dev)

    def forward(self, x: torch.Tensor, graph, node_mask=None) -> torch.Tensor:
        """[N, in_channels] features -> [N, out_channels] f32 logits."""
        cfg = self.config
        x = x.to(self.compute_dtype)
        x1 = self.trans_conv(x, node_mask=node_mask)
        if cfg.gnn == "none":
            out = x1
        else:
            branch = self.graph_conv if cfg.gnn == "graphconv" else self.gcn
            x2 = branch(x, graph, node_mask=node_mask)
            if cfg.aggregate == "add":
                out = cfg.graph_weight * x2 + (1.0 - cfg.graph_weight) * x1
            else:
                out = torch.cat([x1, x2], dim=1)
        return self.fc(out).float()

    def get_attentions(self, x: torch.Tensor) -> torch.Tensor:
        """Stacked per-layer [N, N] attention maps; materialises N^2, so
        small graphs only."""
        _, attns = self.trans_conv(x, output_attn=True)
        return attns
