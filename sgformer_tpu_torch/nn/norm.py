"""Masked BatchNorm: the port of ``sgformer_tpu/nn/norm.py``.

torch ``BatchNorm1d`` semantics: eps 1e-5, momentum 0.1 (written here, as in
the JAX package, as the decay ``momentum=0.9`` of the running stats), biased
variance to normalise and the unbiased variance for the running estimate.
Batch statistics are taken over the rows that ``node_mask`` marks. Stats and
the affine map are f32; the output has the input's type. With ``axis_name``
(node-sharded training) the statistics are one all-reduce of (count, Σx,
Σx²) over that mesh axis (:mod:`sgformer_tpu_torch.parallel`), as the JAX
module's psum.
"""

from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5,
                 axis_name: str | None = None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.axis_name = axis_name
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, node_mask: torch.Tensor | None = None) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            if node_mask is None:
                cnt = torch.full((), float(x.shape[0]), device=x.device)
                s1 = xf.sum(dim=0)
                s2 = (xf * xf).sum(dim=0)
            else:
                m = node_mask.float()[:, None]
                cnt = m.sum()
                s1 = (xf * m).sum(dim=0)
                s2 = (xf * xf * m).sum(dim=0)
            if self.axis_name is not None:
                from sgformer_tpu_torch.parallel.comm import all_reduce_sum

                f = s1.shape[0]
                stats = all_reduce_sum(torch.cat([cnt[None], s1, s2]), self.axis_name)
                cnt, s1, s2 = stats[0], stats[1:f + 1], stats[f + 1:]
            if node_mask is not None:
                # an all-masked group keeps finite stats; with >= 1 real row
                # the clamp changes nothing
                cnt = cnt.clamp(min=1.0)
            mean = s1 / cnt
            var = (s2 / cnt - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
                self.running_mean.copy_(
                    self.momentum * self.running_mean + (1.0 - self.momentum) * mean
                )
                self.running_var.copy_(
                    self.momentum * self.running_var + (1.0 - self.momentum) * unbiased
                )
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.weight + self.bias).to(x.dtype)
