"""The port's int8 GCN aggregation (``preprocess_graph(slab_dtype="int8")``,
``ops.spmm.quantize_absmax``/``spmm_q8`` and the CPU path of
``kernels.spmm.csr_spmm_q8``) against the JAX package's int8 slab SpMM: the
int8 branch of the Pallas ``_ssel_kernel`` with ``_apply_side``'s
quantiser and epilogue, run in interpret mode on ``build_slabs(...,
stream_sel="bf16", sep_rs=rs, slab_dtype="int8")`` plans.

Tolerances, with their reasons:

- integer features with the absmax planted at 127 and rs = 1: the
  quantisation is the identity and both sides are exact integer arithmetic,
  so they are equal, even in a multi-slab plan whose cross-slab edges the
  JAX package sums unquantised;
- Gaussian features on a single-slab plan (every edge local): both sides
  quantise the same rows to the same int8 values; the JAX kernel rounds the
  integer partial sum to bf16 (2^-9 relative) before the epilogue: 4e-3 of
  max |out| with f32 input and output; with bf16 both also round the output
  to bf16, where one ulp at the top of the range is 2^-7 of it: 1e-2; the
  same 4e-3 for the forward and the gradient through a hub plan on a small
  power-law graph (the plan changes no value: the sums are integers);
- a multi-slab plan: the JAX package sums the cross-slab edges unquantised
  in bf16 where the port quantises every non-self edge, so the two differ by
  up to the quantisation step on those edges: 2e-2 of the scale, forward
  and gradient, JAX's own tolerance of its int8 path against the f32 oracle
  (``tests/test_slab_spmm.py``);
- the small SGFormer in bf16: the differences above through two GCN layers,
  BatchNorm and the head, and bf16 roundings at other places in the two
  frameworks (as ``tests/test_torch_serve.py`` states): logits 5e-2 absolute
  and argmax agreement >= 95 % on 300 nodes; gradients 5e-2 of each
  parameter gradient's largest magnitude.

The graph builder is a copy of ``tests/test_slab_spmm.py``'s (copied, not
imported)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgformer_tpu.data.loaders import synthetic_dataset as jax_synthetic_dataset
from sgformer_tpu.graph import gcn_norm_rs as jax_gcn_norm_rs
from sgformer_tpu.graph import preprocess_graph as jax_preprocess_graph
from sgformer_tpu.kernels.slab_spmm import slab_spmm
from sgformer_tpu.kernels.slabs import build_slabs
from sgformer_tpu.nn import SGFormer as JaxSGFormer
from sgformer_tpu.nn import SGFormerConfig as JaxConfig
from sgformer_tpu.ops.spmm import spmm as jax_spmm
from sgformer_tpu.serve import Predictor as JaxPredictor
from sgformer_tpu.train import TrainConfig as JaxTrainConfig
from sgformer_tpu.train import Trainer as JaxTrainer

from sgformer_tpu_torch import Predictor, SGFormer, SGFormerConfig, load_flax_variables
from sgformer_tpu_torch.convert import _plan
from sgformer_tpu_torch.graph import gcn_norm_rs, preprocess_graph
from sgformer_tpu_torch.kernels import spmm as spmm_kernel
from sgformer_tpu_torch.kernels.spmm import csr_spmm_q8, csr_spmm_q8_autograd
from sgformer_tpu_torch.ops.spmm import quantize_absmax, spmm, spmm_q8
from sgformer_tpu_torch.train import TrainConfig, Trainer

torch.set_num_threads(1)

# multi-slab geometry of tests/test_slab_spmm.py; and one slab covering all
# 600 nodes with min_pair=1, so that every edge is local
PARAMS = dict(window_rows=64, block_rows=64, chunk_edges=128, chunks_per_step=2,
              slab_rows=256)
ONE_SLAB = dict(PARAMS, slab_rows=1024, min_pair=1)


def _clustered_graph(rng, n=600, e=4000, k=6, homophily=0.85):
    """Planted-partition edge list + gcn weights, dst-sorted, with
    self-loops (the preprocess_graph output shape)."""
    lab = rng.integers(0, k, n)
    src = rng.integers(0, n, e)
    same = rng.random(e) < homophily
    partners = [np.nonzero(lab == c)[0] for c in range(k)]
    dst_same = np.array([rng.choice(partners[lab[s]]) for s in src])
    dst = np.where(same, dst_same, rng.integers(0, n, e))
    both = np.concatenate(
        [np.stack([src, dst]), np.stack([dst, src])], axis=1
    )
    loop = np.arange(n)
    ei = np.concatenate([both, np.stack([loop, loop])], axis=1)
    # dedupe
    key = ei[1] * n + ei[0]
    _, keep = np.unique(key, return_index=True)
    ei = ei[:, keep]
    order = np.argsort(ei[1], kind="stable")
    s, d = ei[0][order], ei[1][order]
    deg = np.bincount(d, minlength=n).astype(np.float64)
    w = (1 / np.sqrt(deg[d] * deg[s])).astype(np.float32)
    return s, d, w, lab


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    s, d, w, _ = _clustered_graph(rng)
    n = 600
    rs = jax_gcn_norm_rs(d, n)
    return s, d, w, rs, n


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_csr(s, d, w):
    """The port's CSR arguments of a dst-sorted edge list."""
    indptr = np.zeros(int(d.max()) + 2 if len(d) else 1, dtype=np.int64)
    np.cumsum(np.bincount(d, minlength=len(indptr) - 1), out=indptr[1:])
    return (_t(indptr.astype(np.int32)), _t(s.astype(np.int32)), _t(d.astype(np.int32)),
            _t(w.astype(np.float32)))


def _jax_int8(x, plan):
    return np.asarray(slab_spmm(jnp.asarray(x), plan, compute_dtype=jnp.bfloat16,
                                interpret=True))


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("width", [32, 77, 128])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_absmax_is_the_jax_quantiser(problem, width, dtype, impl):
    """The int8 rows and the absmax, bit for bit, against the JAX ops of
    ``_apply_side`` (``slab_spmm.py:380-394``) on the same inputs: the plain
    quantiser, and the kernel's wrapper, which on CPU tensors is the plain
    version and launches nothing."""
    _, _, _, rs, n = problem
    x = np.random.default_rng(width).standard_normal((n, width)).astype(np.float32)
    xj = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    xs = xj.astype(jnp.bfloat16) * jnp.asarray(rs)[:, None].astype(jnp.bfloat16)
    s_want = jnp.maximum(jnp.max(jnp.abs(xs.astype(jnp.float32))), jnp.float32(1e-30))
    q_want = jnp.clip(jnp.round(xs.astype(jnp.float32) * (127.0 / s_want)), -127.0,
                      127.0).astype(jnp.int8)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    before = spmm_kernel.quantize_launches
    quantise = quantize_absmax if impl == "plain" else spmm_kernel.quantize_absmax
    q, s = quantise(xt, torch.from_numpy(rs))
    assert spmm_kernel.quantize_launches == before
    assert q.dtype == torch.int8 and s.dim() == 0 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_want))
    assert s.item() == float(s_want)


def test_quantizer_rounds_ties_half_to_even():
    """Values that land on .5 after the scale (absmax 127, rs = 1, scale 1)
    round to the even neighbour, as ``jnp.round`` does."""
    vals = np.array([127.0, 0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5, 126.5, -126.5],
                    dtype=np.float32)
    q, s = quantize_absmax(torch.from_numpy(vals)[:, None], torch.ones(len(vals)))
    assert s.item() == 127.0
    want = np.asarray(jnp.round(jnp.asarray(vals))).astype(np.int8)
    np.testing.assert_array_equal(q[:, 0].numpy(), want)
    np.testing.assert_array_equal(want, [127, 0, 2, 2, 4, 0, -2, -2, 126, -126])


def test_spmm_q8_exact_on_integer_features_multi_slab():
    """Unit weights (rs = 1) and integer features with the absmax planted at
    127: the port equals the JAX int8 path exactly, in a multi-slab plan
    with cross-slab edges, as JAX's own test holds it to the f32 oracle."""
    rng = np.random.default_rng(3)
    n, e = 500, 2600
    s = rng.integers(0, n, e)
    d = rng.integers(0, n, e)
    order = np.argsort(d, kind="stable")
    s, d = s[order], d[order]
    w = np.ones(e, dtype=np.float32)
    plan = build_slabs(s, d, w, n, stream_sel="bf16", sep_rs=np.ones(n, np.float32),
                       slab_dtype="int8", **PARAMS)
    assert plan.fwd.remote is not None  # cross-slab edges exist
    x = rng.integers(-3, 4, (n, 32)).astype(np.float32)
    x[0, 0] = 127.0
    want = _jax_int8(x, plan)
    rs = torch.ones(n)
    got = spmm_q8(_t(x), _t(s), _t(d), _t(w), rs, n)
    np.testing.assert_array_equal(got.numpy(), want)
    csr = _port_csr(s, d, w)
    np.testing.assert_array_equal(csr_spmm_q8(_t(x), *csr, rs).numpy(), want)
    np.testing.assert_array_equal(want, np.asarray(jax_spmm(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(d), jnp.asarray(w), n)))


@pytest.mark.parametrize("width", [32, 77])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_q8_matches_jax_single_slab(problem, width, dtype):
    s, d, w, rs, n = problem
    plan = build_slabs(s, d, w, n, stream_sel="bf16", sep_rs=rs, slab_dtype="int8",
                       **ONE_SLAB)
    assert plan.fwd.remote is None and plan.slab_dtype == "int8"
    x = np.random.default_rng(11).standard_normal((n, width)).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    want = _jax_int8(np.asarray(xt.float()), plan) if dtype == torch.float32 else np.asarray(
        slab_spmm(jnp.asarray(x, dtype=jnp.bfloat16), plan, compute_dtype=jnp.bfloat16,
                  interpret=True).astype(jnp.float32))
    got = csr_spmm_q8(xt, *_port_csr(s, d, w), torch.from_numpy(rs))
    assert got.dtype == dtype and got.shape == (n, width)
    tol = 4e-3 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("width", [32, 77])
def test_spmm_q8_fwd_and_grad_match_jax_multi_slab(problem, width):
    s, d, w, rs, n = problem
    plan = build_slabs(s, d, w, n, stream_sel="bf16", sep_rs=rs, slab_dtype="int8",
                       **PARAMS)
    assert plan.fwd.remote is not None
    x = np.random.default_rng(12).standard_normal((n, width)).astype(np.float32)
    cot = np.random.default_rng(13).standard_normal((n, width)).astype(np.float32)
    want = _jax_int8(x, plan)
    want_g = np.asarray(jax.grad(lambda xx: jnp.vdot(slab_spmm(
        xx, plan, compute_dtype=jnp.bfloat16, interpret=True).astype(jnp.float32),
        jnp.asarray(cot)))(jnp.asarray(x)))

    csr = _port_csr(s, d, w)
    xt = torch.from_numpy(x).requires_grad_()
    out = csr_spmm_q8_autograd(xt, csr, csr, torch.from_numpy(rs))
    (got_g,) = torch.autograd.grad(out, xt, torch.from_numpy(cot))
    scale = np.abs(want).max()
    assert np.abs(out.detach().numpy() - want).max() <= 2e-2 * scale
    assert np.abs(got_g.numpy() - want_g).max() <= 2e-2 * np.abs(want_g).max()
    # and both within the same share of the f32 oracle
    oracle = spmm(torch.from_numpy(x), *csr[1:], n).numpy()
    assert np.abs(out.detach().numpy() - oracle).max() <= 2e-2 * np.abs(oracle).max()


def test_spmm_q8_gradient_quantises_g_on_the_transpose():
    """A directed graph (``undirected=False``): the gradient is the int8
    aggregation of g, quantised with its own absmax and pre-scaled by rs, on
    the transposed CSR, as the JAX transpose plan (``symmetric=False``)
    computes it."""
    rng = np.random.default_rng(21)
    n = 300
    ei = rng.integers(0, n, (2, 1800))
    g = preprocess_graph(ei, n, undirected=False, chunk_dtype="bf16", slab_dtype="int8",
                         device="cpu")
    assert not g.symmetric
    x = torch.from_numpy(rng.standard_normal((n, 24)).astype(np.float32)).requires_grad_()
    cot = torch.from_numpy(rng.standard_normal((n, 24)).astype(np.float32))
    before = spmm_kernel.q8_launches
    (got,) = torch.autograd.grad(g.propagate(x), x, cot)
    assert spmm_kernel.q8_launches == before  # CPU tensors take the plain version
    want = spmm_q8(cot, g.t_edge_src, g.t_edge_dst, g.t_weight, g.rs, n)
    assert torch.equal(got, want)

    src, dst, w = (t.numpy() for t in (g.edge_src, g.edge_dst, g.gcn_weight))
    plan = build_slabs(src, dst, w, n, stream_sel="bf16", sep_rs=g.rs.numpy(),
                       slab_dtype="int8", symmetric=False, **PARAMS)
    assert plan.bwd is not None
    want_j = np.asarray(jax.grad(lambda xx: jnp.vdot(slab_spmm(
        xx, plan, compute_dtype=jnp.bfloat16, interpret=True).astype(jnp.float32),
        jnp.asarray(cot.numpy())))(jnp.asarray(x.detach().numpy())))
    assert np.abs(got.numpy() - want_j).max() <= 2e-2 * np.abs(want_j).max()


def test_int8_graph_carries_rs_and_propagates_through_the_int8_path():
    ds = jax_synthetic_dataset(num_nodes=400, num_edges=2400, num_features=8, num_classes=3,
                               seed=2)
    n = ds.num_nodes
    g = preprocess_graph(ds.graph["edge_index"], n, chunk_dtype="bf16", slab_dtype="int8",
                         device="cpu")
    jg = jax_preprocess_graph(ds.graph["edge_index"], n)
    np.testing.assert_array_equal(g.rs.numpy(), jax_gcn_norm_rs(np.asarray(jg.edge_dst), n))
    np.testing.assert_array_equal(g.rs.numpy(), gcn_norm_rs(g.edge_dst, n).numpy())
    assert g.slab_dtype == "int8" and g.rs.dtype == torch.float32
    # the separable factor reproduces the non-self weights
    s_, d_ = g.edge_src.long(), g.edge_dst.long()
    torch.testing.assert_close(g.rs[s_] * g.rs[d_], g.gcn_weight, rtol=1e-6, atol=0)
    plain = preprocess_graph(ds.graph["edge_index"], n, device="cpu")
    assert plain.slab_dtype == "compute" and plain.rs is None
    x = torch.randn(n, 16, generator=torch.Generator().manual_seed(0))
    assert torch.equal(g.propagate(x), spmm_q8(x, g.edge_src, g.edge_dst, g.gcn_weight,
                                               g.rs, n))
    assert torch.equal(plain.propagate(x), spmm(x, g.edge_src, g.edge_dst, g.gcn_weight, n))


@pytest.mark.parametrize("kind", ["f32", "pyg"])
def test_int8_preprocess_errors_match_jax(kind):
    """int8 is bf16-path-only and needs separable weights: both packages
    refuse f32 + int8, and PyG-normalised + int8 where the PyG weights do
    not factor by the GCN ``rs`` (no self-loops added: PyG adds its own, so
    its degrees differ)."""
    rng = np.random.default_rng(0)
    n = 300
    ei = rng.integers(0, n, (2, 1500))
    jax_kw = dict(with_chunks=True, spmm_mode="ssel", chunk_interpret=True,
                  slab_geometry={"slab_dtype": "int8"})
    if kind == "f32":
        jax_kw["chunk_dtype"], port_kw = "f32", dict(chunk_dtype="f32")
    else:
        jax_kw.update(chunk_dtype="bf16", with_pyg_norm=True, self_loops=False)
        port_kw = dict(chunk_dtype="bf16", with_pyg_norm=True, self_loops=False)
    with pytest.raises(ValueError, match="sep_rs"):
        jax_preprocess_graph(ei, n, **jax_kw)
    with pytest.raises(ValueError, match="sep_rs|bf16"):
        preprocess_graph(ei, n, slab_dtype="int8", device="cpu", **port_kw)
    with pytest.raises(ValueError, match="slab_dtype"):
        preprocess_graph(ei, n, slab_dtype="auto", device="cpu")


def test_int8_pyg_edges_with_self_loops_factor_and_aggregate_in_int8():
    """With the self-loops added, the PyG weights equal the GCN ones and
    factor by ``rs``: the JAX package builds its int8 PyG plan, and the
    port's ``propagate(kind='pyg')`` runs the int8 aggregation on them."""
    rng = np.random.default_rng(1)
    n = 300
    ei = rng.integers(0, n, (2, 1500))
    jg = jax_preprocess_graph(ei, n, with_chunks=True, spmm_mode="ssel", chunk_dtype="bf16",
                              chunk_interpret=True, with_pyg_norm=True,
                              slab_geometry={"slab_dtype": "int8"})
    assert jg.pyg_chunks.slab_dtype == "int8"
    g = preprocess_graph(ei, n, chunk_dtype="bf16", slab_dtype="int8", with_pyg_norm=True,
                         device="cpu")
    x = torch.randn(n, 24, generator=torch.Generator().manual_seed(2))
    want = spmm_q8(x, g.pyg_src, g.pyg_dst, g.pyg_weight, g.rs, n)
    assert torch.equal(g.propagate(x, kind="pyg"), want)


def test_csr_spmm_q8_cpu_path_is_the_plain_version(problem):
    s, d, w, rs, n = problem
    x = torch.randn(n, 40, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    csr = _port_csr(s, d, w)
    got = csr_spmm_q8(x, *csr, torch.from_numpy(rs))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, spmm_q8(x, *csr[1:], torch.from_numpy(rs), n))
    with pytest.raises(ValueError):
        csr_spmm_q8(torch.zeros(n + 1, 4), *csr, torch.from_numpy(rs))
    with pytest.raises(TypeError):
        csr_spmm_q8(torch.zeros(n, 4, dtype=torch.float64), *csr, torch.from_numpy(rs))


# -- hub plans on the int8 path ------------------------------------------------

SEGMENT = 16  # short segments, so that the small graph has hub rows


@pytest.fixture(scope="module")
def powerlaw_problem():
    """A small power-law int8 graph with rows of more than SEGMENT
    in-edges, its hub plan of SEGMENT-edge segments, and the JAX int8 plan
    of one slab (every edge local) on the same edges."""
    ds = jax_synthetic_dataset(num_nodes=600, num_edges=3000, num_features=8, num_classes=3,
                               seed=5, powerlaw=1.1)
    g = preprocess_graph(ds.graph["edge_index"], 600, chunk_dtype="bf16", slab_dtype="int8",
                         device="cpu")
    plan = spmm_kernel.hub_plan(g.indptr, SEGMENT)
    assert torch.diff(g.indptr).max().item() > 4 * SEGMENT and plan.shape[0] > 8
    src, dst, w = (t.numpy() for t in (g.edge_src, g.edge_dst, g.gcn_weight))
    jplan = build_slabs(src, dst, w, 600, stream_sel="bf16", sep_rs=g.rs.numpy(),
                        slab_dtype="int8", **ONE_SLAB)
    assert jplan.fwd.remote is None
    return g, plan, jplan


def test_csr_spmm_q8_with_a_hub_plan_matches_jax(powerlaw_problem):
    """``csr_spmm_q8`` given the hub plan and its segment length: the plain
    ``spmm_q8`` bit for bit, and the JAX int8 slab SpMM within the bf16
    rounding of its integer partial (4e-3, as the single-slab test), forward
    and through ``CsrSpmmQ8Function``'s gradient on the transpose's plan."""
    g, plan, jplan = powerlaw_problem
    n = g.num_nodes
    csr = (g.indptr, g.edge_src, g.edge_dst, g.gcn_weight)
    x = np.random.default_rng(14).standard_normal((n, 48)).astype(np.float32)
    cot = np.random.default_rng(15).standard_normal((n, 48)).astype(np.float32)
    got = csr_spmm_q8(_t(x), *csr, g.rs, plan, SEGMENT)
    assert torch.equal(got, spmm_q8(_t(x), *csr[1:], g.rs, n))
    want = _jax_int8(x, jplan)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4e-3 * np.abs(want).max())

    xt = _t(x).requires_grad_()
    out = csr_spmm_q8_autograd(xt, csr, csr, g.rs, plan, plan, SEGMENT)
    (got_g,) = torch.autograd.grad(out, xt, _t(cot))
    assert torch.equal(got_g, spmm_q8(_t(cot), *csr[1:], g.rs, n))
    want_g = np.asarray(jax.grad(lambda xx: jnp.vdot(slab_spmm(
        xx, jplan, compute_dtype=jnp.bfloat16, interpret=True).astype(jnp.float32),
        jnp.asarray(cot)))(jnp.asarray(x)))
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0,
                               atol=4e-3 * np.abs(want_g).max())


def test_int8_hub_plan_is_taken_only_with_its_segment_length(powerlaw_problem):
    """As ``csr_spmm``: a plan without the segment length it was built
    with is refused by every int8 entry point, before anything runs."""
    g, plan, _ = powerlaw_problem
    n = g.num_nodes
    csr = (g.indptr, g.edge_src, g.edge_dst, g.gcn_weight)
    x = torch.randn(n, 16, generator=torch.Generator().manual_seed(3))
    q, s = quantize_absmax(x, g.rs)
    with pytest.raises(ValueError, match="segment length"):
        csr_spmm_q8(x, *csr, g.rs, plan)
    with pytest.raises(ValueError, match="segment length"):
        spmm_kernel.csr_spmm_q8_apply(q, s, x.bfloat16(), *csr, g.rs, torch.float32, plan)
    with pytest.raises(ValueError, match="segment length"):
        csr_spmm_q8_autograd(x.requires_grad_(), csr, csr, g.rs, plan, plan)
    with pytest.raises(ValueError, match="segment_edges"):
        csr_spmm_q8(x, *csr, g.rs, plan, 0)


@pytest.mark.parametrize("kind,undirected", [("gcn", True), ("gcn", False), ("pyg", True)])
def test_int8_propagate_hands_its_plans_on(monkeypatch, kind, undirected):
    """``Graph.propagate`` on an int8 graph passes the CSR's hub plans,
    their length and the walk orders to the int8 aggregation, as the bf16
    path does: A's plan and order for both on a symmetric graph, A's and
    A^T's otherwise, the PyG edges' own plan for ``kind='pyg'``."""
    rng = np.random.default_rng(9)
    n = 300
    ei = np.concatenate([rng.integers(0, n, (2, 1500)),
                         np.stack([np.arange(10, 210), np.full(200, 4)])], axis=1)
    g = preprocess_graph(ei, n, undirected=undirected, chunk_dtype="bf16", slab_dtype="int8",
                         with_pyg_norm=kind == "pyg", device="cpu")
    seen = []

    def record(x, csr, csr_t, rs, *plans):
        seen.append((csr, csr_t, rs, plans))
        return x

    monkeypatch.setattr(spmm_kernel, "csr_spmm_q8_autograd", record)
    g.propagate(torch.zeros(n, 4), kind=kind)
    ((csr, csr_t, rs, (segments, t_segments, length, schedule, t_schedule)),) = seen
    if kind == "pyg":
        want = (g.pyg_hub_segments, g.pyg_hub_segments)
        assert csr[1] is g.pyg_src
    else:
        want = (g.hub_segments, g.hub_segments if undirected else g.t_hub_segments)
        assert csr[1] is g.edge_src and (csr_t is csr) == undirected
    assert segments is want[0] and t_segments is want[1] and rs is g.rs
    assert length == g.hub_edges and segments.shape[0] > 0
    assert schedule is g.schedule and schedule is not None
    assert t_schedule is (g.schedule if undirected else g.t_schedule)
    assert t_schedule is not None


# -- the slice: a small SGFormer on an int8 graph ------------------------------

N_M, F_M, C_M = 300, 16, 4
CFG = dict(gnn_num_layers=2, trans_dropout=0.0, gnn_dropout=0.0, compute_dtype="bf16")


@pytest.fixture(scope="module")
def model_problem():
    ds = jax_synthetic_dataset(num_nodes=N_M, num_edges=2400, num_features=F_M,
                               num_classes=C_M, seed=3)
    jg = jax_preprocess_graph(ds.graph["edge_index"], N_M, with_chunks=True,
                              spmm_mode="ssel", slab_rows=128, chunk_dtype="bf16",
                              slab_geometry={"slab_dtype": "int8"}, chunk_interpret=True)
    assert jg.node_perm is not None and jg.chunks.slab_dtype == "int8"
    jmodel = JaxSGFormer(JaxConfig.large(32, C_M, **CFG))
    tc = JaxTrainConfig(lr=1e-2)
    jtrainer = JaxTrainer(jmodel, jg, ds.graph["node_feat"], ds.label, tc)
    state, _, _ = jtrainer.init_state(jax.random.PRNGKey(0))
    # random BatchNorm statistics, so that no identity hides a mapping error
    rng = np.random.default_rng(6)
    bs = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32),
                      state["batch_stats"])
    state = jax.tree.map(np.asarray, {"params": state["params"], "batch_stats": bs})
    graph = preprocess_graph(ds.graph["edge_index"], N_M, chunk_dtype="bf16",
                             slab_dtype="int8", device="cpu")
    return ds, jg, jmodel, jtrainer, state, graph


def test_sgformer_logits_on_int8_graph_match_jax(model_problem):
    ds, jg, jmodel, _, state, graph = model_problem
    want = JaxPredictor(jmodel, jg, ds.graph["node_feat"], state).logits()  # original order
    model = SGFormer(SGFormerConfig.large(32, C_M, **CFG), F_M, device="cpu")
    got = Predictor(model, graph, ds.graph["node_feat"], state=state, device="cpu"
                    ).compile().logits()
    assert got.shape == want.shape == (N_M, C_M)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.95
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)


def test_sgformer_gradients_on_int8_graph_match_jax(model_problem):
    ds, _, _, jtrainer, state, graph = model_problem
    split = ds.get_idx_split(rng=np.random.default_rng(0))
    train_idx = jtrainer._prepare_train_idx(split)  # mapped into the JAX node order
    (loss, _), grads = jax.value_and_grad(jtrainer._make_loss_fn(), has_aux=True)(
        state["params"], state["batch_stats"], jax.random.PRNGKey(1), train_idx,
        jtrainer.x, jtrainer.graph)

    model = SGFormer(SGFormerConfig.large(32, C_M, **CFG), F_M, device="cpu")
    trainer = Trainer(model, graph, ds.graph["node_feat"], ds.label, TrainConfig(),
                      device="cpu")
    load_flax_variables(model, state)
    got = trainer.loss(trainer.prepare_train_idx(split))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=2e-2)
    flat_g = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v, np.float32)
              for path, v in jax.tree_util.tree_flatten_with_path(grads)[0]}
    # a bias that feeds a train-mode BatchNorm has an exact gradient of 0:
    # held to the scale of the BatchNorm shift's gradient after it
    scale_of = {("graph_conv", "fc_in", "bias"): ("graph_conv", "bn_in", "bias")}
    scale_of.update({("graph_conv", f"conv_{i}", "W", "bias"): ("graph_conv", f"bn_{i}", "bias")
                     for i in range(CFG["gnn_num_layers"])})
    seen = 0
    for path, tensor, transpose in _plan(model):
        if path[0] != "params":
            continue
        want = flat_g[path[1:]]
        g = tensor.grad.float().numpy()
        g = g.T if transpose else g
        scale = np.abs(flat_g[scale_of.get(path[1:], path[1:])]).max()
        assert np.abs(g - want).max() <= 5e-2 * scale, "/".join(path)
        seen += 1
    assert seen == len(flat_g)


# -- the two discrepancies of the reference (ROADMAP.md section 3) ----------


def test_jax_rounds_the_integer_partial_to_bf16_the_port_keeps_it_exact(problem):
    """The JAX kernel writes its integer partial sum in the compute type
    (bf16, ``slab_spmm.py:223-227``) before the epilogue; the port keeps the
    exact integer sum. With rs = 1 and integer features up to 127 (absmax
    planted, so q = x), sums pass 256 and bf16 drops their low bits: JAX
    equals the bf16-rounded sum plus the self term, the port the exact one."""
    s, d, _, _, n = problem
    w = np.ones(len(s), dtype=np.float32)
    plan = build_slabs(s, d, w, n, stream_sel="bf16", sep_rs=np.ones(n, np.float32),
                       slab_dtype="int8", **ONE_SLAB)
    assert plan.fwd.remote is None
    rng = np.random.default_rng(4)
    x = rng.integers(-127, 128, (n, 16)).astype(np.float32)
    x[0, 0] = 127.0
    off = s != d
    exact = np.zeros((n, 16))
    np.add.at(exact, d[off], x[s[off]])
    assert np.abs(exact).max() > 512  # beyond bf16's exact integers
    self_term = x * np.bincount(d[~off], minlength=n)[:, None]
    want_jax = np.asarray(jnp.asarray(exact, dtype=jnp.bfloat16).astype(jnp.float32)) + self_term
    got_jax = _jax_int8(x, plan)
    np.testing.assert_array_equal(got_jax, want_jax)
    got = spmm_q8(_t(x), _t(s), _t(d), _t(w), torch.ones(n), n).numpy()
    np.testing.assert_array_equal(got, exact + self_term)
    assert not np.array_equal(got, got_jax)


def test_jax_sums_cross_slab_edges_unquantised_the_port_quantises_all(problem):
    """One outlier sets the absmax, so every other value quantises to 0. The
    JAX plan sums its cross-slab edges unquantised in bf16
    (``slab_spmm.py:401-417``), so its result depends on the plan: with one
    slab (every edge local) it matches the port within the two bf16
    roundings; with several slabs the remote edges bring back what the
    quantiser dropped. The port has no slabs and quantises every non-self
    edge."""
    s, d, w, rs, n = problem
    x = (0.01 * np.random.default_rng(5).standard_normal((n, 16))).astype(np.float32)
    x[0, 0] = 100.0
    one = build_slabs(s, d, w, n, stream_sel="bf16", sep_rs=rs, slab_dtype="int8", **ONE_SLAB)
    multi = build_slabs(s, d, w, n, stream_sel="bf16", sep_rs=rs, slab_dtype="int8", **PARAMS)
    assert one.fwd.remote is None and multi.fwd.remote is not None
    got = csr_spmm_q8(_t(x), *_port_csr(s, d, w), torch.from_numpy(rs)).numpy()
    want_one, want_multi = _jax_int8(x, one), _jax_int8(x, multi)
    rows = np.arange(n) != 0  # the outlier's own row and column aside
    np.testing.assert_allclose(got[rows, 1:], want_one[rows, 1:], rtol=0, atol=1e-4)
    moved = np.abs(want_multi[rows, 1:] - want_one[rows, 1:]).max()
    assert moved > 100 * np.abs(got[rows, 1:] - want_one[rows, 1:]).max()
    assert moved > 1e-3
