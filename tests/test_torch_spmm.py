"""The port's SpMM (plain version, and the CSR kernel wrapper's CPU path)
against the JAX package: its XLA ``spmm`` and its Pallas slab SpMM
(``_ssel_kernel`` + ``_spmm_kernel``, and the meta-mode ``_slab_kernel``,
run in interpret mode), the TPU kernels the port's one CSR kernel replaces;
forward, and the gradient
``A^T @ g`` that the port computes through the same wrapper on the
transposed CSR."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgformer_tpu.graph import preprocess_graph as jax_preprocess_graph
from sgformer_tpu.ops.spmm import spmm as jax_spmm

from sgformer_tpu_torch.data import synthetic_dataset
from sgformer_tpu_torch.graph import preprocess_graph
from sgformer_tpu_torch.kernels.spmm import HUB_EDGES, csr_spmm, hub_plan, walk_design
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
    # a rectangular A takes x of its num_cols rows and no other
    assert csr_spmm(torch.zeros(n + 1, 4), g.indptr, g.edge_src, g.edge_dst,
                    g.gcn_weight, num_cols=n + 1).shape == (n, 4)
    with pytest.raises(ValueError):
        csr_spmm(torch.zeros(n, 4), g.indptr, g.edge_src, g.edge_dst, g.gcn_weight,
                 num_cols=n + 1)
    with pytest.raises(ValueError):
        csr_spmm(torch.zeros(n, 4, 1), g.indptr, g.edge_src, g.edge_dst, g.gcn_weight)
    with pytest.raises(TypeError):
        csr_spmm(torch.zeros(n, 4, dtype=torch.float64), g.indptr, g.edge_src,
                 g.edge_dst, g.gcn_weight)


@pytest.mark.parametrize("d,aligned,want", [
    (8, True, "8 groups of 4 lanes"), (32, True, "8 groups of 4 lanes"),
    (40, True, "4 groups of 8 lanes"), (64, True, "4 groups of 8 lanes"),
    (128, True, "2 groups of 16 lanes"), (136, True, "1 group of 32 lanes, 8 columns"),
    (256, True, "1 group of 32 lanes, 8 columns"), (520, True, "1 group of 32 lanes, 8 columns"),
    (37, True, "1 group of 32 lanes, 1 column"), (40, False, "1 group of 32 lanes, 1 column"),
])
def test_walk_design_names_the_lane_groups(d, aligned, want):
    """The row walk's lanes for a head of d columns: the fewest of 4, 8, 16
    lanes whose 8 columns cover it on the 16-byte path, else the whole
    warp."""
    assert walk_design(d, aligned).startswith(want)


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


def test_spmm_matches_jax_meta_mode_slab_kernel_interpret():
    """The port's CSR sum against the JAX slab SpMM whose selectors the
    kernel builds itself (``spmm_mode='slab'``, the meta-mode
    ``_slab_kernel``, the fallback on power-law graphs), in interpret mode,
    on a power-law graph: forward and gradient in the original node order,
    f32 on both sides, only the summation order differs (rtol 1e-5 / atol
    1e-6)."""
    ds = synthetic_dataset(num_nodes=400, num_edges=2400, num_features=4, num_classes=4,
                           powerlaw=1.1, seed=0, device="cpu")
    ei, n = ds.graph["edge_index"], ds.num_nodes
    jg = jax_preprocess_graph(ei, n, with_chunks=True, spmm_mode="slab", slab_rows=128,
                              chunk_dtype="f32", chunk_interpret=True)
    assert jg.chunks.fwd.meta is not None and jg.node_perm is not None
    perm = np.asarray(jg.node_perm)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((n, 24)).astype(np.float32)
    w = rng.standard_normal((n, 24)).astype(np.float32)
    out_perm = np.asarray(jg.propagate(jnp.asarray(x[perm])))
    want = np.empty_like(out_perm)
    want[perm] = out_perm
    grad_perm = jax.grad(lambda a: jnp.sum(jg.propagate(a) * w[perm]))(jnp.asarray(x[perm]))
    want_grad = np.empty_like(x)
    want_grad[perm] = np.asarray(grad_perm)
    tg = preprocess_graph(ei, n, device="cpu")
    got = tg.propagate(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_port_grad(ei, n, x, w), want_grad, rtol=1e-5, atol=1e-6)


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


def _port_grad(ei, n, x, w, undirected=True):
    g = preprocess_graph(ei, n, undirected=undirected, device="cpu")
    tx = torch.from_numpy(x).requires_grad_()
    out = g.propagate(tx)
    assert type(out.grad_fn).__name__ == "CsrSpmmFunctionBackward"
    return torch.autograd.grad(out, tx, torch.from_numpy(w))[0].numpy()


@pytest.mark.parametrize("undirected", [True, False])
def test_spmm_gradient_matches_jax_xla(undirected):
    """jax.grad through the JAX ``Graph.propagate`` (XLA path): with
    ``undirected=False`` A is not symmetric and the port's backward reads
    the CSR of A^T (f32, rtol 1e-5 / atol 1e-6)."""
    ei, n = _clustered_edges(7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((n, 20)).astype(np.float32)
    w = rng.standard_normal((n, 20)).astype(np.float32)
    jg = jax_preprocess_graph(ei, n, undirected=undirected)
    want = jax.grad(lambda a: jnp.sum(jg.propagate(a) * w))(jnp.asarray(x))
    got = _port_grad(ei, n, x, w, undirected)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    if not undirected:  # the gradient is A^T g, which A g is not here
        sym = _port_grad(ei, n, x, w, True)
        assert np.abs(got - sym).max() > 1e-2


def test_spmm_gradient_matches_jax_slab_kernels_interpret():
    """jax.grad through the slab SpMM in interpret mode, whose VJP runs the
    forward kernels on the transpose plan (``_slab_core_bwd``), compared in
    the original node order (f32, rtol 1e-5 / atol 1e-6)."""
    ei, n = _clustered_edges(9)
    jg = jax_preprocess_graph(ei, n, with_chunks=True, spmm_mode="ssel",
                              slab_rows=128, chunk_dtype="f32",
                              chunk_interpret=True)
    perm = np.asarray(jg.node_perm)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((n, 24)).astype(np.float32)
    w = rng.standard_normal((n, 24)).astype(np.float32)
    grad_perm = jax.grad(lambda a: jnp.sum(jg.propagate(a) * w[perm]))(jnp.asarray(x[perm]))
    want = np.empty_like(x)
    want[perm] = np.asarray(grad_perm)
    np.testing.assert_allclose(_port_grad(ei, n, x, w), want, rtol=1e-5, atol=1e-6)


def test_transposed_csr_only_where_a_is_not_symmetric():
    """The fixed-weight gradient reads a transposed CSR of its own only
    where A is not symmetric (for the PyG edges it is built only then); the
    GCN edges' transposed order, with ``t_perm``, is on every graph, since
    runtime per-edge values need it even on a symmetric edge set."""
    ei, n = _clustered_edges(11, n=60, e=200)
    sym = preprocess_graph(ei, n, device="cpu", with_pyg_norm=True)
    assert sym.symmetric and sym.pyg_t_indptr is None and sym.t_perm is not None
    assert torch.equal(sym.t_weight, sym.gcn_weight[sym.t_perm.long()])
    assert torch.equal(sym.t_edge_dst, sym.edge_src[sym.t_perm.long()])
    g = preprocess_graph(ei, n, undirected=False, device="cpu", with_pyg_norm=True)
    assert not g.symmetric
    for kind, fwd, bwd in (
        ("gcn", (g.edge_src, g.edge_dst, g.gcn_weight), (g.t_edge_src, g.t_edge_dst, g.t_weight)),
        ("pyg", (g.pyg_src, g.pyg_dst, g.pyg_weight), (g.pyg_t_src, g.pyg_t_dst, g.pyg_t_weight)),
    ):
        dense = torch.zeros(n, n)
        dense[fwd[1].long(), fwd[0].long()] = fwd[2]  # A[dst, src]
        dense_t = torch.zeros(n, n)
        dense_t[bwd[1].long(), bwd[0].long()] = bwd[2]
        assert torch.equal(dense_t, dense.t()), kind
        assert not torch.equal(dense, dense.t()), kind
    assert torch.equal(g.t_indptr, torch.from_numpy(
        np.searchsorted(g.t_edge_dst.numpy(), np.arange(n + 1)).astype(np.int32)))
    x = torch.randn(n, 3, requires_grad=True)
    gx = torch.autograd.grad(g.propagate(x, kind="pyg").sum(), x)[0]
    ones = torch.ones(n, 3)
    want = spmm(ones, g.pyg_dst, g.pyg_src, g.pyg_weight, n)  # A^T @ 1
    torch.testing.assert_close(gx, want)


def test_spmm_saves_nothing_where_autograd_does_not_record():
    ei, n = _clustered_edges(12, n=60, e=200)
    g = preprocess_graph(ei, n, device="cpu")
    x = torch.randn(n, 4, requires_grad=True)
    with torch.inference_mode():
        assert g.propagate(x).grad_fn is None
    with torch.no_grad():
        assert g.propagate(x).grad_fn is None
    assert g.propagate(x.detach()).grad_fn is None


def _check_plan(plan, indptr, max_edges=HUB_EDGES):
    """Every edge of every row above ``max_edges`` once, in edge order, in
    runs of 1..max_edges edges; no other row."""
    plan = np.asarray(plan)
    indptr = np.asarray(indptr, dtype=np.int64)
    hubs = np.flatnonzero(np.diff(indptr) > max_edges)
    assert plan.dtype == np.int32 and plan.shape == (plan.shape[0], 3)
    assert np.array_equal(np.unique(plan[:, 0]), hubs)
    row, begin, end = plan.T.astype(np.int64)
    assert (np.diff(row) >= 0).all()
    assert ((end - begin >= 1) & (end - begin <= max_edges)).all()
    covered = np.concatenate([np.arange(b, e) for b, e in zip(begin, end)] or [np.zeros(0)])
    want = np.concatenate([np.arange(indptr[r], indptr[r + 1]) for r in hubs] or [np.zeros(0)])
    assert np.array_equal(covered, want)
    return len(hubs)


def _hub_edges(seed, n=600, fan=400):
    """Random edges plus node 3 with ``fan`` in-edges and node 5 with
    ``fan`` out-edges: a hub row in A and in A^T."""
    rng = np.random.default_rng(seed)
    others = rng.permutation(np.arange(6, n))[:fan]
    return np.concatenate([rng.integers(0, n, (2, 3 * n)),
                           np.stack([others, np.full(fan, 3)]),
                           np.stack([np.full(fan, 5), others])], axis=1), n


def test_hub_plan_covers_every_long_row_once():
    """``preprocess_graph`` builds the hub plan of each CSR it holds (A,
    A^T with ``undirected=False``, the PyG edges and their transpose), each
    covering every edge of every row above HUB_EDGES once, in edge order;
    ``Graph.to`` carries them; :func:`hub_plan` does the same for any
    segment length."""
    ei, n = _hub_edges(14)
    g = preprocess_graph(ei, n, undirected=False, with_pyg_norm=True, device="cpu")
    for plan, indptr in ((g.hub_segments, g.indptr), (g.t_hub_segments, g.t_indptr),
                         (g.pyg_hub_segments, g.pyg_indptr),
                         (g.pyg_t_hub_segments, g.pyg_t_indptr)):
        assert _check_plan(plan.numpy(), indptr.numpy()) == 1
    h = g.to("cpu")
    for name in ("hub_segments", "t_hub_segments", "pyg_hub_segments", "pyg_t_hub_segments"):
        assert torch.equal(getattr(h, name), getattr(g, name))
    sym = preprocess_graph(ei, n, device="cpu")
    assert _check_plan(sym.hub_segments.numpy(), sym.indptr.numpy()) == 2
    for max_edges, rows in ((1, 500), (7, 10), (64, 1)):
        assert _check_plan(hub_plan(g.indptr, max_edges).numpy(), g.indptr.numpy(),
                           max_edges) >= rows
    small = preprocess_graph(*_clustered_edges(15, n=60, e=200), device="cpu")
    assert small.hub_segments.shape == (0, 3) and small.t_hub_segments.shape == (0, 3)


def test_hub_plan_is_taken_only_with_its_segment_length():
    """The kernel's row walk leaves every row longer than the plan's segment
    length to the plan, so a plan comes with that length or is refused:
    ``_plan`` raises on a plan without it (a 256-edge plan would otherwise
    meet the 128-edge walk and leave the rows in between unwritten), and so
    do ``csr_spmm`` and ``csr_spmm_ev`` on the CPU path; with its length the
    plan and length go to the kernel together; without a plan one is built
    at the length asked for. The graph carries the length of its plans
    (``hub_edges``) through ``Graph.to``."""
    from sgformer_tpu_torch.kernels.spmm import _plan, csr_spmm_ev

    ei, n = _hub_edges(20, fan=200)
    g = preprocess_graph(ei, n, undirected=False, device="cpu")
    plan256 = hub_plan(g.indptr, 256)
    assert plan256.shape[0] == 0 and g.hub_segments.shape[0] == 2  # 200 edges: a hub at 128
    with pytest.raises(ValueError, match="segment length"):
        _plan(plan256, g.indptr)
    for bad in (0, -3, 2.5, True, "128"):
        with pytest.raises(ValueError, match="positive integer"):
            _plan(plan256, g.indptr, bad)
    got, length = _plan(plan256, g.indptr, 256)
    assert got is plan256 and length == 256
    got, length = _plan(None, g.indptr)
    assert torch.equal(got, g.hub_segments) and length == HUB_EDGES == g.hub_edges
    got, length = _plan(None, g.indptr, 8)
    assert torch.equal(got, hub_plan(g.indptr, 8)) and length == 8
    x = torch.randn(n, 4)
    csr = (g.indptr, g.edge_src, g.edge_dst)
    with pytest.raises(ValueError, match="segment length"):
        csr_spmm(x, *csr, g.gcn_weight, plan256)
    with pytest.raises(ValueError, match="segment length"):
        csr_spmm_ev(x[:, None], *csr, torch.ones(g.num_edges, 1), None, plan256)
    want = spmm(x, g.edge_src, g.edge_dst, g.gcn_weight, n)
    assert torch.equal(csr_spmm(x, *csr, g.gcn_weight, plan256, 256), want)
    assert torch.equal(csr_spmm(x, *csr, g.gcn_weight, g.hub_segments, g.hub_edges), want)
    moved = dataclasses.replace(g, hub_edges=256, hub_segments=plan256).to("cpu")
    assert moved.hub_edges == 256 and torch.equal(moved.hub_segments, plan256)
    assert torch.equal(moved.propagate(x), g.propagate(x))


def _segmented_spmm(x, indptr, src, weight, max_edges):
    """The kernel's two passes written plainly: rows of at most
    ``max_edges`` edges summed whole; each hub segment's f32 partial row
    summed alone; each hub row's partials added in segment order."""
    plan = hub_plan(indptr, max_edges).numpy()
    n = indptr.shape[0] - 1
    deg = np.diff(indptr.numpy())
    dst = torch.from_numpy(np.repeat(np.arange(n), deg))
    msgs = x.float()[src.long()] * weight[:, None]
    short = torch.from_numpy(deg[dst.numpy()] <= max_edges)
    out = torch.zeros(n, x.shape[1]).index_add_(0, dst[short], msgs[short])
    part = [msgs[b:e].sum(0) for _, b, e in plan]
    for s, (row, _, _) in enumerate(plan):
        if s == 0 or plan[s - 1, 0] != row:
            out[row] = part[s]
        else:
            out[row] = out[row] + part[s]
    return out.to(x.dtype)


def test_segmented_sum_matches_the_plain_version_and_jax():
    """The two-pass segmented sum on a power-law graph with a row of
    in-degree far above the segment length (8 here, HUB_EDGES on the card):
    the plain ``spmm`` and the JAX XLA ``spmm``, forward, and the gradient on
    the transposed CSR with its own plan (f32, rtol 1e-5 / atol 1e-6)."""
    ds = synthetic_dataset(num_nodes=400, num_edges=2400, num_features=4, num_classes=4,
                           powerlaw=1.1, seed=0, device="cpu")
    ei, n = ds.graph["edge_index"], ds.num_nodes
    g = preprocess_graph(ei, n, device="cpu")
    assert np.diff(g.indptr.numpy()).max() > 8 * 8 and np.diff(g.t_indptr.numpy()).max() > 8 * 8
    rng = np.random.default_rng(16)
    x = rng.standard_normal((n, 24)).astype(np.float32)
    w = rng.standard_normal((n, 24)).astype(np.float32)
    got = _segmented_spmm(torch.from_numpy(x), g.indptr, g.edge_src, g.gcn_weight, 8)
    want = spmm(torch.from_numpy(x), g.edge_src, g.edge_dst, g.gcn_weight, n)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    jg = jax_preprocess_graph(ei, n)
    jax_out = jax_spmm(jnp.asarray(x), jg.edge_src, jg.edge_dst, jg.gcn_weight, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), rtol=1e-5, atol=1e-6)
    got_grad = _segmented_spmm(torch.from_numpy(w), g.t_indptr, g.t_edge_src, g.t_weight, 8)
    want_grad = jax.grad(lambda a: jnp.sum(jg.propagate(a) * w))(jnp.asarray(x))
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_grad.numpy(), _port_grad(ei, n, x, w), rtol=1e-5, atol=1e-6)
