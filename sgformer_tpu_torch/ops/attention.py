"""SGFormer linear global attention: plain PyTorch.

The port of ``sgformer_tpu/ops/attention.py::linear_attention``, and the
oracle of the CUDA reduce and apply kernels
(:mod:`sgformer_tpu_torch.kernels.attention`). q and k are scaled by their
global Frobenius norms (one scalar each, not per row), so the whole function
is a sum over nodes followed by a rescale:

    out = (inv * q @ (k^T v) + n * v) / (inv * q . sum_n k + n),
    inv = 1 / (||q|| * ||k||)

Every sum is taken in f32 and the output is rounded once to q's type.
With ``axis_name`` (node-sharded training) the node sums are one all-reduce
of (n, ||q||², ||k||², kᵀv, Σk) over that mesh axis
(:mod:`sgformer_tpu_torch.parallel`), as the JAX function's psum.
"""

from __future__ import annotations

import torch


def linear_attention(
    qs: torch.Tensor,
    ks: torch.Tensor,
    vs: torch.Tensor,
    output_attn: bool = False,
    node_mask: torch.Tensor | None = None,
    axis_name: str | None = None,
):
    """qs, ks: [N, H, M]; vs: [N, H, D] (H may be 1 and broadcast).

    ``node_mask`` [N] marks real rows: masked rows add nothing to the norms
    and sums, and n becomes the count of real rows. ``output_attn`` also
    returns the [N, N] mean-head attention map (small graphs only; this
    shard's rows and keys under ``axis_name``). With ``axis_name`` the rows
    are this rank's shard and every node sum runs over the whole axis.
    Returns [N, H, D] in q's type (and the map).
    """
    compute_dtype = qs.dtype
    if node_mask is not None:
        m = node_mask.to(qs.dtype)[:, None, None]
        qs, ks, vs = qs * m, ks * m, vs * m
        n_total = node_mask.float().sum()
    else:
        n_total = torch.full((), float(qs.shape[0]), device=qs.device)
    qf, kf, vf = qs.float(), ks.float(), vs.float()

    q_sq = qf.square().sum()
    k_sq = kf.square().sum()
    kvs = torch.einsum("lhm,lhd->hmd", kf, vf)
    ks_sum = kf.sum(dim=0)  # [H, M]
    if axis_name is not None:
        from sgformer_tpu_torch.parallel.comm import all_reduce_sum

        parts = (n_total.reshape(1), q_sq.reshape(1), k_sq.reshape(1), kvs.reshape(-1),
                 ks_sum.reshape(-1))
        total = all_reduce_sum(torch.cat(parts), axis_name)
        n_total, q_sq, k_sq = total[0], total[1], total[2]
        kvs = total[3:3 + kvs.numel()].view(kvs.shape)
        ks_sum = total[3 + kvs.numel():].view(ks_sum.shape)

    if node_mask is None:
        inv_qk = 1.0 / (q_sq.sqrt() * k_sq.sqrt())
    else:
        # an all-masked group has zero norms: guard the inputs of sqrt and
        # divide, as the JAX path does, so the result stays finite
        one = torch.ones_like(q_sq)
        nonzero = (q_sq > 0.0) & (k_sq > 0.0)
        q_norm = torch.where(q_sq > 0.0, q_sq, one).sqrt()
        k_norm = torch.where(k_sq > 0.0, k_sq, one).sqrt()
        inv_qk = torch.where(nonzero, 1.0 / (q_norm * k_norm), torch.zeros_like(q_sq))

    num = torch.einsum("nhm,hmd->nhd", qf, kvs) * inv_qk + n_total * vf
    den = (torch.einsum("nhm,hm->nh", qf, ks_sum) * inv_qk + n_total)[..., None]
    if node_mask is not None:
        den = torch.where(den == 0.0, torch.ones_like(den), den)
    out = (num / den).to(compute_dtype)

    if output_attn:
        attn = (torch.einsum("nhm,lhm->nlh", qf, kf) * inv_qk).mean(dim=-1)
        attn = attn / den.squeeze(-1).mean(dim=-1, keepdim=True)
        return out, attn
    return out
