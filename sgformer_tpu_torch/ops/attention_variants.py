"""The ablation attentions that SGFormer was ablated against: the port of
``sgformer_tpu/ops/attention_variants.py``, plain PyTorch.

The JAX package computes each in XLA einsums outside any Pallas kernel, so
the port has no kernel of its own for them either: ``torch.einsum`` on the
device. The softmax and GAT variants materialise the [N, L, H] score tensor
(O(N^2), ablation-scale graphs only); the Performer variant is O(N*M).

The softmax runs over the source nodes (axis 1 of [N, L, H]), as the JAX
package's does. Every product is taken in f32 and the output is rounded once
to v's type.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _global_norm(t: torch.Tensor) -> torch.Tensor:
    """``t`` divided by its Frobenius norm over every element."""
    return t / t.float().square().sum().sqrt().to(t.dtype)


def _softmax_aggregate(scores: torch.Tensor, vs: torch.Tensor, output_attn: bool):
    weights = torch.softmax(scores, dim=1)
    out = torch.einsum("nlh,lhd->nhd", weights, vs.float()).to(vs.dtype)
    if output_attn:
        return out, weights.mean(dim=-1)
    return out


def softmax_attention(qs, ks, vs, output_attn: bool = False):
    """Full softmax attention over globally normalised q and k: scores
    q.k after dividing each tensor by its Frobenius norm, softmax over the
    source nodes, aggregate. qs, ks: [N, H, M]; vs: [N, H, D]. Returns
    [N, H, D] (and the [N, N] head-mean map with ``output_attn``)."""
    qs, ks = _global_norm(qs), _global_norm(ks)
    scores = torch.einsum("nhm,lhm->nlh", qs.float(), ks.float())
    return _softmax_aggregate(scores, vs, output_attn)


def gat_attention(qs, ks, vs, output_attn: bool = False):
    """Scaled dot-product attention: scores q.k / sqrt(M), no global
    normalisation, softmax over the source nodes."""
    scores = torch.einsum("nhm,lhm->nlh", qs.float(), ks.float()) / math.sqrt(qs.shape[-1])
    return _softmax_aggregate(scores, vs, output_attn)


def create_projection_matrix(m: int, d: int, generator: torch.Generator) -> torch.Tensor:
    """[m, d] orthogonal random features (Performer): rows of QR-
    orthogonalised gaussian [d, d] blocks, each row rescaled by the norm of
    a gaussian d-vector (chi-distributed). Drawn on ``generator``'s device,
    blocks first, then the row norms. It cannot match ``jax.random``'s
    draw; a caller that needs the JAX projection passes it in."""
    dev = generator.device
    blocks = []
    for i in range(-(-m // d)):
        g = torch.randn((d, d), generator=generator, device=dev)
        q, _ = torch.linalg.qr(g)
        blocks.append(q.T[: min(d, m - i * d)])
    final = torch.cat(blocks, dim=0)
    multiplier = torch.randn((m, d), generator=generator, device=dev).norm(dim=1)
    return multiplier[:, None] * final


def softmax_kernel_transformation(data, is_query: bool, projection,
                                  numerical_stabilizer: float = 1e-6):
    """Positive random features of the softmax kernel. data: [N, H, D];
    projection: [M, D]. Returns [N, H, M] f32. The stabilising shift is the
    row's largest feature for a query, the head's largest over every row and
    feature for a key."""
    d = data.shape[-1]
    data = data.float() / math.sqrt(math.sqrt(d))
    ratio = 1.0 / math.sqrt(projection.shape[0])
    data_dash = torch.einsum("nhd,md->nhm", data, projection.float())
    diag = data.square().sum(dim=-1, keepdim=True) / 2.0
    if is_query:
        stab = data_dash.amax(dim=-1, keepdim=True)
    else:
        stab = data_dash.amax(dim=(-1, -3), keepdim=True)
    return ratio * (torch.exp(data_dash - diag - stab) + numerical_stabilizer)


def performer_attention(
    qs,
    ks,
    vs,
    *,
    generator: Optional[torch.Generator] = None,
    num_features: Optional[int] = None,
    tau: float = 0.25,
    edge_index: Optional[torch.Tensor] = None,
    projection: Optional[torch.Tensor] = None,
    numerical_stabilizer: float = 1e-6,
):
    """NodeFormer's kernelised (Performer) softmax attention: an O(N*M)
    linear aggregation through positive random features.

    ``projection`` passes a fixed [M, D] feature matrix; without it one of
    ``num_features or 2*D`` rows is drawn from ``generator``. With
    ``edge_index`` [2, E] (source, destination) it also returns the [E, H]
    attention weight of each edge."""
    d = qs.shape[-1]
    if projection is None:
        if generator is None:
            raise ValueError("performer_attention needs a generator or a projection")
        projection = create_projection_matrix(num_features or 2 * d, d, generator)
    q_prime = softmax_kernel_transformation(qs / math.sqrt(tau), True, projection,
                                            numerical_stabilizer)  # [N, H, M]
    k_prime = softmax_kernel_transformation(ks / math.sqrt(tau), False, projection,
                                            numerical_stabilizer)  # [L, H, M]
    kvs = torch.einsum("lhm,lhd->hmd", k_prime, vs.float())
    num = torch.einsum("nhm,hmd->nhd", q_prime, kvs)
    den = torch.einsum("nhm,hm->nh", q_prime, k_prime.sum(dim=0))[..., None]
    out = (num / den).to(vs.dtype)
    if edge_index is not None:
        start, end = edge_index[0].long(), edge_index[1].long()
        e_num = torch.einsum("ehm,ehm->eh", q_prime[end], k_prime[start])
        return out, e_num / den[end, :, 0]
    return out
