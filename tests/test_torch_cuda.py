"""The port's CUDA kernels against their plain versions on the card, at
shapes the serving path does not reach: partial tiles, tail rows, rows of
more than 32 edges, isolated nodes, strided heads, widths off the 16-byte
path. Skipped without a CUDA card. This file imports no JAX, so it runs on a
machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-5 (summation order only, TF32 off); bf16 1e-2 relative
and absolute (the output rounding to bf16 may differ by one ulp, 2^-8)."""

import numpy as np
import pytest
import torch

from sgformer_tpu_torch import Predictor, SGFormer, SGFormerConfig, preprocess_graph
from sgformer_tpu_torch import kernels
from sgformer_tpu_torch.kernels import attention as attn
from sgformer_tpu_torch.kernels.spmm import csr_spmm
from sgformer_tpu_torch.ops.attention import linear_attention
from sgformer_tpu_torch.ops.spmm import spmm

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _graph(cuda, n=700, e=3000, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - 20, e)
    dst = rng.integers(0, n - 20, e)
    hub = np.stack([np.arange(70), np.full(70, 5)])  # node 5: in-degree > 64
    ei = np.concatenate([np.stack([src, dst]), hub], axis=1)
    # undirected=False keeps the last 20 nodes isolated but for their loop
    return preprocess_graph(ei, n, undirected=False, device=cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [520, 256, 128, 40, 37, 1])
def test_csr_spmm_kernel_matches_plain(cuda, dtype, width):
    g = _graph(cuda)
    x = torch.randn(g.num_nodes, width, device=cuda).to(dtype)
    before = kernels.spmm.launches
    got = csr_spmm(x, g.indptr, g.edge_src, g.edge_dst, g.gcn_weight)
    assert kernels.spmm.launches == before + 1
    want = spmm(x, g.edge_src, g.edge_dst, g.gcn_weight, g.num_nodes)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(got, csr_spmm(x, g.indptr, g.edge_src, g.edge_dst, g.gcn_weight))


def test_csr_spmm_unaligned_rows_take_the_scalar_path(cuda):
    g = _graph(cuda)
    flat = torch.randn(g.num_nodes * 64 + 1, device=cuda)
    x = flat[1:].view(g.num_nodes, 64)  # contiguous, 4 bytes off 16-byte alignment
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    got = csr_spmm(x, g.indptr, g.edge_src, g.edge_dst, g.gcn_weight)
    want = spmm(x, g.edge_src, g.edge_dst, g.gcn_weight, g.num_nodes)
    torch.testing.assert_close(got, want, **TOL[torch.float32])


def test_csr_spmm_rejects_what_the_kernel_cannot_take(cuda):
    g = _graph(cuda)
    with pytest.raises(TypeError):
        csr_spmm(torch.zeros(g.num_nodes, 8, device=cuda), g.indptr.long(),
                 g.edge_src, g.edge_dst, g.gcn_weight)
    with pytest.raises(ValueError):
        csr_spmm(torch.zeros(g.num_nodes, 8), g.indptr, g.edge_src, g.edge_dst,
                 g.gcn_weight)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,m,d", [(1, 256, 256), (2, 48, 80), (3, 16, 8)])
@pytest.mark.parametrize("masked", [False, True])
def test_linear_attention_kernels_match_plain(cuda, dtype, heads, m, d, masked):
    n = 1000  # not a multiple of the 64-row apply tile or the 32-row step
    q, k = (torch.randn(n, heads, m, device=cuda).to(dtype) for _ in range(2))
    v = torch.randn(n, heads, d, device=cuda).to(dtype)
    mask = (torch.arange(n, device=cuda) % 3 != 1).float() if masked else None
    r0, a0 = attn.reduce_launches, attn.apply_launches
    got = attn.fused_linear_attention(q, k, v, node_mask=mask)
    assert (attn.reduce_launches - r0, attn.apply_launches - a0) == (heads, heads)
    want = linear_attention(q, k, v, node_mask=mask)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])

    # the apply kernel alone, where q @ kvs carries the output (n = 1)
    qp, kp = (torch.rand(n, m, device=cuda).to(dtype) for _ in range(2))
    vp = torch.rand(n, d, device=cuda).to(dtype)
    kvs, ksum, scal = attn.reduce(qp, kp, vp)
    kvs_w, ksum_w, scal_w = attn.reduce_plain(qp, kp, vp, False)
    torch.testing.assert_close(kvs, kvs_w, rtol=1e-5, atol=1e-5 * kvs_w.abs().max().item())
    torch.testing.assert_close(ksum, ksum_w, rtol=1e-5, atol=1e-5 * ksum_w.abs().max().item())
    torch.testing.assert_close(scal, scal_w, rtol=1e-6, atol=0.0)
    one = torch.ones((), device=cuda)
    got_a = attn.apply(qp, vp, kvs_w, ksum_w, scal_w, one)
    want_a = attn.apply_plain(qp, vp, kvs_w, ksum_w, scal_w, one, False)
    torch.testing.assert_close(got_a.float(), want_a.float(), **TOL[dtype])


def test_all_masked_attention_is_finite_zero(cuda):
    q, k, v = (torch.randn(500, 1, 32, device=cuda) for _ in range(3))
    mask = torch.zeros(500, device=cuda)
    got = attn.fused_linear_attention(q, k, v, node_mask=mask)
    assert torch.isfinite(got).all() and not got.any()


@pytest.mark.parametrize("compute_dtype", ["f32", "bf16"])
def test_predictor_on_the_card_matches_the_cpu(cuda, compute_dtype):
    rng = np.random.default_rng(1)
    n = 900
    ei = rng.integers(0, n, (2, 5000))
    x = rng.standard_normal((n, 24)).astype(np.float32)
    cfg = SGFormerConfig.large(64, 5, gnn_num_layers=3, compute_dtype=compute_dtype)
    logits = {}
    for dev in ("cpu", "cuda"):
        model = SGFormer(cfg, 24, generator=torch.Generator().manual_seed(0), device=dev)
        graph = preprocess_graph(ei, n, device=dev)
        logits[dev] = Predictor(model, graph, x, device=dev).compile().logits()
    if compute_dtype == "f32":
        np.testing.assert_allclose(logits["cuda"], logits["cpu"], rtol=1e-4, atol=1e-4)
    else:
        assert (logits["cuda"].argmax(-1) == logits["cpu"].argmax(-1)).mean() >= 0.99
        np.testing.assert_allclose(logits["cuda"], logits["cpu"], rtol=0, atol=5e-2)
