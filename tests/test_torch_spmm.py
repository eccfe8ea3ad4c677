"""The port's SpMM (plain version, and the CSR kernel wrapper's CPU path)
against the JAX package: its XLA ``spmm`` and its Pallas slab SpMM
(``_ssel_kernel`` + ``_spmm_kernel``, run in interpret mode), the two TPU
kernels the port's one CSR kernel replaces."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgformer_tpu.graph import preprocess_graph as jax_preprocess_graph
from sgformer_tpu.ops.spmm import spmm as jax_spmm

from sgformer_tpu_torch.graph import preprocess_graph
from sgformer_tpu_torch.kernels.spmm import csr_spmm
from sgformer_tpu_torch.ops.spmm import spmm

torch.set_num_threads(1)


def _clustered_edges(seed, n=400, e=2400, k=5, homophily=0.85):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, k, n)
    src = rng.integers(0, n, e)
    same = rng.random(e) < homophily
    order = np.argsort(lab, kind="stable")
    starts = np.searchsorted(lab[order], np.arange(k))
    ends = np.searchsorted(lab[order], np.arange(k), side="right")
    ls, le = starts[lab[src]], ends[lab[src]]
    dst_same = order[ls + (rng.random(e) * (le - ls)).astype(np.int64)]
    dst = np.where(same, dst_same, rng.integers(0, n, e))
    return np.stack([src, dst]).astype(np.int64), n


@pytest.mark.parametrize("width", [1, 7, 32])
def test_spmm_matches_jax_f32(width):
    """f32: the two differ only in summation order (rtol 1e-5 / atol 1e-6)."""
    ei, n = _clustered_edges(0)
    g = jax_preprocess_graph(ei, n)
    x = np.random.default_rng(1).standard_normal((n, width)).astype(np.float32)
    want = np.asarray(jax_spmm(jnp.asarray(x), g.edge_src, g.edge_dst, g.gcn_weight, n))
    got = spmm(torch.from_numpy(x), torch.tensor(np.asarray(g.edge_src)),
               torch.tensor(np.asarray(g.edge_dst)),
               torch.tensor(np.asarray(g.gcn_weight)), n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_csr_spmm_cpu_path_is_the_plain_version(dtype):
    ei, n = _clustered_edges(2)
    g = preprocess_graph(ei, n, device="cpu")
    x = torch.randn(n, 16, generator=torch.Generator().manual_seed(0)).to(dtype)
    got = csr_spmm(x, g.indptr, g.edge_src, g.edge_dst, g.gcn_weight)
    want = spmm(x, g.edge_src, g.edge_dst, g.gcn_weight, n)
    assert got.dtype == dtype
    assert torch.equal(got, want)


def test_csr_spmm_rejects_bad_inputs():
    ei, n = _clustered_edges(3)
    g = preprocess_graph(ei, n, device="cpu")
    with pytest.raises(ValueError):
        csr_spmm(torch.zeros(n + 1, 4), g.indptr, g.edge_src, g.edge_dst, g.gcn_weight)
    with pytest.raises(TypeError):
        csr_spmm(torch.zeros(n, 4, dtype=torch.float64), g.indptr, g.edge_src,
                 g.edge_dst, g.gcn_weight)


def test_spmm_matches_jax_slab_kernels_interpret():
    """The port's CSR sum against the JAX slab SpMM in interpret mode
    (``spmm_mode='ssel'``: the ``_ssel_kernel`` intra-slab part plus the
    ``_spmm_kernel`` cross-slab part plus the self-loop term), compared in
    the original node order through ``node_perm``. f32 on both sides and
    only the summation order differs (rtol 1e-5 / atol 1e-6)."""
    ei, n = _clustered_edges(4)
    jg = jax_preprocess_graph(ei, n, with_chunks=True, spmm_mode="ssel",
                              slab_rows=128, chunk_dtype="f32",
                              chunk_interpret=True)
    assert jg.node_perm is not None and jg.chunks.fwd.sel_src is not None
    perm = np.asarray(jg.node_perm)
    x = np.random.default_rng(5).standard_normal((n, 24)).astype(np.float32)
    out_perm = np.asarray(jg.propagate(jnp.asarray(x[perm])))
    want = np.empty_like(out_perm)
    want[perm] = out_perm  # row i of out_perm is node perm[i]
    tg = preprocess_graph(ei, n, device="cpu")
    got = tg.propagate(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_bf16_sum_is_f32_then_rounded_once():
    """The port (kernel and plain) sums bf16 messages in f32 and rounds once;
    the JAX XLA path sums in bf16 (ops/spmm.py:44-52), so the port lands
    nearer the exact sum."""
    ei, n = _clustered_edges(6, n=300, e=4000)
    g = preprocess_graph(ei, n, device="cpu")
    jg = jax_preprocess_graph(ei, n)
    x = torch.randn(n, 32, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    src, dst = g.edge_src.long(), g.edge_dst.long()
    exact = torch.zeros(n, 32, dtype=torch.float64).index_add_(
        0, dst, x.double()[src] * g.gcn_weight.double()[:, None])
    got = csr_spmm(x, g.indptr, g.edge_src, g.edge_dst, g.gcn_weight)
    assert torch.equal(got, spmm(x.float(), g.edge_src, g.edge_dst, g.gcn_weight, n)
                       .to(torch.bfloat16))
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jax_out = np.asarray(jax_spmm(jx, jg.edge_src, jg.edge_dst, jg.gcn_weight, n)
                         .astype(jnp.float32))
    err_port = (got.double() - exact).abs().max().item()
    err_jax = np.abs(jax_out - exact.numpy()).max()
    assert err_port <= err_jax
