"""Optimizer: Adam with per-branch weight decay. The port of
``sgformer_tpu/train/optim.py``.

The reference trains with
``Adam([{params1, weight_decay=trans_wd}, {params2, weight_decay=gnn_wd}], lr)``
where ``params1`` is the attention branch and ``params2`` the GNN branch and
the fusion head. ``torch.optim.Adam(weight_decay=w)`` is L2 regularisation
added to the gradient before the moment updates (not AdamW), which is what
the JAX package's masked ``add_decayed_weights`` in front of
``scale_by_adam`` computes.
"""

from __future__ import annotations

import torch
from torch import nn

BETAS = (0.9, 0.999)
EPS = 1e-8


def branch_params(model: nn.Module, branch: str) -> list:
    """The parameters of ``branch``: ``"trans"`` is every parameter under
    ``trans_conv``, ``"gnn"`` everything else (GNN branch and head)."""
    if branch not in ("trans", "gnn"):
        raise ValueError(f"unknown branch {branch!r}")
    return [p for name, p in model.named_parameters()
            if (name.split(".")[0] == "trans_conv") == (branch == "trans")]


def dual_weight_decay_adam(model: nn.Module, lr: float, trans_weight_decay: float,
                           gnn_weight_decay: float) -> torch.optim.Adam:
    """Adam(lr) with L2 decay ``trans_weight_decay`` on the attention branch
    and ``gnn_weight_decay`` on everything else."""
    groups = [
        {"params": branch_params(model, "trans"), "weight_decay": trans_weight_decay},
        {"params": branch_params(model, "gnn"), "weight_decay": gnn_weight_decay},
    ]
    return torch.optim.Adam([g for g in groups if g["params"]], lr=lr, betas=BETAS, eps=EPS)


def adam(params, lr: float, weight_decay: float = 0.0) -> torch.optim.Adam:
    """Plain torch Adam with L2 decay, for models without the two branches."""
    return torch.optim.Adam(params, lr=lr, betas=BETAS, eps=EPS, weight_decay=weight_decay)
