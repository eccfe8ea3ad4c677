"""The port's GAT path against the JAX package's, on the CPU: the edge
softmax, the per-edge-value aggregation (the CSR kernel wrapper's plain path
and its autograd Function) and its plain backward against
``chunked_spmm_edge_values`` running the Pallas ``_spmm_kernel`` in interpret
mode, the fused backward wrapper against the parent formulation (dx through
``csr_spmm_ev`` on the transposed order, dv through ``sddmm``), the
transposed edge order the gradient reads, ``GAT``/``GATJK`` forward and
every gradient with the flax weights copied in, and a few ``Trainer`` steps
against the JAX trainer. The plain aggregations and the edge softmax sum in
a fixed order without atomics; on the CPU they are bitwise the
``index_add`` forms they replaced.

Tolerances: in f32 only the summation order differs (rtol 1e-5 on one
aggregation; the zoo's own 1e-4 / 1e-5 forward and 1e-3 / 1e-5 gradient
tolerances of ``tests/test_baselines.py`` through the GAT stack; 1e-4 over
Adam steps, which amplify it). With bf16 messages the Pallas kernel also
rounds the per-edge values to bf16 (``kernels/spmm.py:51-53``) where the
port keeps them f32, so each output may differ by one bf16 rounding of
every term, 2^-8 of sum |v| |x|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_numpy as ref
from test_torch_modules import _randomize

from sgformer_tpu.graph import preprocess_graph as jax_preprocess_graph
from sgformer_tpu.kernels.spmm import chunked_spmm_edge_values
from sgformer_tpu.nn import GAT as JaxGAT
from sgformer_tpu.nn import GATJK as JaxGATJK
from sgformer_tpu.ops.sddmm import sddmm_softmax_weights as jax_sddmm_softmax_weights
from sgformer_tpu.ops.spmm import edge_softmax as jax_edge_softmax
from sgformer_tpu.ops.spmm import segment_mean as jax_segment_mean
from sgformer_tpu.train import TrainConfig as JaxTrainConfig
from sgformer_tpu.train import Trainer as JaxTrainer

from sgformer_tpu_torch import load_flax_variables, preprocess_graph
from sgformer_tpu_torch.convert import _plan
from sgformer_tpu_torch.kernels import spmm as spmm_kernel
from sgformer_tpu_torch.kernels.spmm import (csr_spmm, csr_spmm_ev, csr_spmm_ev_autograd,
                                             csr_spmm_ev_bwd, sddmm)
from sgformer_tpu_torch.nn import GAT, GATJK
from sgformer_tpu_torch.ops.sddmm import sddmm_softmax_weights
from sgformer_tpu_torch.ops.spmm import (edge_softmax, segment_mean, spmm, spmm_edge_values,
                                         spmm_edge_values_backward)
from sgformer_tpu_torch.train import TrainConfig, Trainer

torch.set_num_threads(1)

N, F, C, HIDDEN, HEADS = 400, 12, 4, 8, 2
CHUNKS = dict(with_chunks=True, chunk_perm=True, chunk_edges=128, window_rows=64,
              chunk_interpret=True)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(8)
    edge_index = ref.random_graph(rng, N, 2000)
    x = rng.standard_normal((N, F)).astype(np.float32)
    label = rng.integers(0, C, N)
    return edge_index, x, label


def _csr(g):
    return (g.indptr, g.edge_src, g.edge_dst)


def _csr_t(g):
    return (g.t_indptr, g.t_edge_src, g.t_edge_dst, g.t_perm)


@pytest.mark.parametrize("heads", [None, 2])
def test_edge_softmax_matches_jax(heads):
    """Forward and gradient, with a destination that has no incoming edge:
    its max is not finite and becomes 0, as in JAX (f32, rtol 1e-5)."""
    rng = np.random.default_rng(1)
    ei = ref.random_graph(rng, 50, 200)
    ei = ei[:, ei[1] != 7]  # node 7 receives nothing
    jg = jax_preprocess_graph(ei, 50, undirected=False, self_loops=False)
    g = preprocess_graph(ei, 50, undirected=False, self_loops=False, device="cpu")
    assert 7 not in g.edge_dst.tolist()
    shape = (g.num_edges,) if heads is None else (g.num_edges, heads)
    scores = (rng.standard_normal(shape) * 3).astype(np.float32)
    scores[:4] = scores[0]  # ties inside a segment
    cot = rng.standard_normal(shape).astype(np.float32)

    def jax_loss(s):
        return jnp.sum(jax_edge_softmax(s, jg.edge_dst, 50) * cot)

    want = np.asarray(jax_edge_softmax(jnp.asarray(scores), jg.edge_dst, 50))
    want_grad = np.asarray(jax.grad(jax_loss)(jnp.asarray(scores)))
    ts = torch.from_numpy(scores).requires_grad_()
    got = edge_softmax(ts, g.edge_dst, 50)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ts.grad.numpy(), want_grad, rtol=1e-5, atol=1e-6)
    sums = np.zeros((50,) + shape[1:])
    np.add.at(sums, g.edge_dst.numpy(), got.detach().numpy())
    has_edge = np.bincount(g.edge_dst.numpy(), minlength=50) > 0
    np.testing.assert_allclose(sums[has_edge], 1.0, rtol=1e-5)


def test_segment_mean_and_sddmm_softmax_match_jax():
    """The plain ops beside the kernels: ``segment_mean`` (an empty segment
    gives 0) and ``sddmm_softmax_weights`` over [N, H, D] (f32, rtol 1e-5)."""
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 30, 200)
    ids[ids == 3] = 4  # segment 3 stays empty
    data = rng.standard_normal((200, 5)).astype(np.float32)
    want = np.asarray(jax_segment_mean(jnp.asarray(data), jnp.asarray(ids), 30))
    got = segment_mean(torch.from_numpy(data), torch.from_numpy(ids), 30).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert not got[3].any()
    ei = ref.random_graph(rng, 40, 160)
    jg = jax_preprocess_graph(ei, 40)
    g = preprocess_graph(ei, 40, device="cpu")
    q, k = (rng.standard_normal((40, 2, 6)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_sddmm_softmax_weights(q, k, jg.edge_src, jg.edge_dst, 40,
                                                scale=0.5))
    got = sddmm_softmax_weights(torch.from_numpy(q), torch.from_numpy(k), g.edge_src,
                                g.edge_dst, 40, scale=0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def _ev_case(problem, chunk_dtype):
    edge_index, _, _ = problem
    jg = jax_preprocess_graph(edge_index, N, chunk_dtype=chunk_dtype, **CHUNKS)
    assert jg.chunks.fwd.edge_perm is not None
    g = preprocess_graph(edge_index, N, chunk_dtype=chunk_dtype, device="cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((N, HEADS, HIDDEN)).astype(np.float32)
    v = rng.random((g.num_edges, HEADS)).astype(np.float32)
    cot = rng.standard_normal((N, HEADS, HIDDEN)).astype(np.float32)
    dtype = jnp.float32 if chunk_dtype == "f32" else jnp.bfloat16

    def jax_heads(xx, vv):
        return jnp.stack([chunked_spmm_edge_values(
            xx[:, h], jg.chunks, vv[:, h], jg.edge_src, jg.edge_dst,
            compute_dtype=dtype, interpret=True) for h in range(HEADS)], axis=1)

    want = np.asarray(jax_heads(jnp.asarray(x), jnp.asarray(v)))
    want_dx, want_dv = jax.grad(lambda a, b: jnp.sum(jax_heads(a, b) * cot),
                                argnums=(0, 1))(jnp.asarray(x), jnp.asarray(v))
    tx = torch.from_numpy(x).requires_grad_()
    tv = torch.from_numpy(v).requires_grad_()
    out = g.propagate_edge_values(tx, tv)
    assert type(out.grad_fn).__name__ == "CsrSpmmEdgeValuesFunctionBackward"
    got_dx, got_dv = torch.autograd.grad(out, (tx, tv), torch.from_numpy(cot))
    return g, x, v, cot, (want, np.asarray(want_dx), np.asarray(want_dv)), \
        (out.detach().numpy(), got_dx.numpy(), got_dv.numpy())


def test_edge_value_spmm_matches_the_pallas_kernel_f32(problem):
    """Forward, dx and dv against jax.grad through chunked_spmm_edge_values
    (interpret mode, f32 messages): rtol 1e-5."""
    _, _, _, _, want, got = _ev_case(problem, "f32")
    for name, a, b in zip(("out", "dx", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)


def test_edge_value_spmm_matches_the_pallas_kernel_bf16(problem):
    """bf16 messages on both sides; the Pallas kernel also rounds v (and the
    port does not), so out and dx may differ by 2^-8 of sum |v| |msg| per
    entry. dv reads the unrounded x and g on both sides: f32 tolerance."""
    g, x, v, cot, want, got = _ev_case(problem, "bf16")
    to_bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    av = torch.from_numpy(np.abs(v))
    scale_out = spmm_edge_values(to_bf16(x).abs(), g.edge_src, g.edge_dst, av, N,
                                 torch.float32).numpy()
    scale_dx = spmm_edge_values(to_bf16(cot).abs(), g.edge_dst, g.edge_src, av, N,
                                torch.float32).numpy()
    for name, a, b, scale in (("out", got[0], want[0], scale_out),
                              ("dx", got[1], want[1], scale_dx)):
        assert np.all(np.abs(a - b) <= 2.0 ** -8 * scale + 1e-6), name
        assert not np.allclose(a, b, rtol=1e-6, atol=0), name  # the messages were rounded
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5, err_msg="dv")


def test_dx_reads_the_values_in_transposed_order():
    """A symmetric edge set with random, asymmetric values: the CSR of A^T
    has A's structure, but the value of (j -> i) is not that of (i -> j),
    so dx is A_v^T g with v[t_perm], not A_v g."""
    rng = np.random.default_rng(3)
    n = 120
    g = preprocess_graph(ref.random_graph(rng, n, 500), n, device="cpu")
    assert g.symmetric and torch.equal(g.t_indptr, g.indptr)
    pattern, pattern_t = torch.zeros(n, n), torch.zeros(n, n)
    pattern[g.edge_dst.long(), g.edge_src.long()] = 1.0  # A[dst, src]
    pattern_t[g.t_edge_dst.long(), g.t_edge_src.long()] = 1.0  # rows of A^T are sources
    assert torch.equal(pattern_t, pattern)
    assert not torch.equal(g.t_perm, torch.arange(g.num_edges, dtype=torch.int32))
    v = torch.rand(g.num_edges, 2, generator=torch.Generator().manual_seed(4))
    x = torch.randn(n, 2, 5, requires_grad=True)
    cot = torch.randn(n, 2, 5)
    dx = torch.autograd.grad(g.propagate_edge_values(x, v), x, cot)[0]
    dense = torch.zeros(2, n, n)
    src, dst = g.edge_src.long(), g.edge_dst.long()
    for h in range(2):
        dense[h][dst, src] = v[:, h]  # A_v[dst, src]
    want = torch.einsum("hij,ihd->jhd", dense, cot)  # A_v^T g per head
    torch.testing.assert_close(dx, want, rtol=1e-5, atol=1e-6)
    wrong = torch.einsum("hij,jhd->ihd", dense, cot)  # A_v g
    assert (dx - wrong).abs().max() > 1e-2


def test_one_head_with_the_gcn_weights_is_csr_spmm(problem):
    edge_index, _, _ = problem
    g = preprocess_graph(edge_index, N, device="cpu")
    x = torch.randn(N, 1, 16, generator=torch.Generator().manual_seed(5))
    got = csr_spmm_ev(x, g.indptr, g.edge_src, g.edge_dst, g.gcn_weight[:, None])
    want = csr_spmm(x[:, 0], g.indptr, g.edge_src, g.edge_dst, g.gcn_weight)
    assert torch.equal(got[:, 0], want)


def test_edge_value_spmm_types_and_no_grad(problem):
    edge_index, _, _ = problem
    g = preprocess_graph(edge_index, N, chunk_dtype="bf16", device="cpu")
    x = torch.randn(N, 2, 8, requires_grad=True)
    v = torch.rand(g.num_edges, 2)
    out = g.propagate_edge_values(x, v)
    assert out.dtype == torch.float32
    want = spmm_edge_values(x.detach().to(torch.bfloat16), g.edge_src, g.edge_dst, v, N,
                            torch.float32)
    assert torch.equal(out.detach(), want)
    with torch.no_grad():
        assert g.propagate_edge_values(x, v).grad_fn is None
    assert csr_spmm_ev_autograd(x.detach(), v, _csr(g), _csr_t(g),
                                torch.float32).grad_fn is None
    with pytest.raises(ValueError):
        csr_spmm_ev(x.detach(), g.indptr, g.edge_src, g.edge_dst, v[:, :1])
    with pytest.raises(ValueError, match="t_perm"):
        dataclasses.replace(g, t_perm=None).propagate_edge_values(x, v)
    with pytest.raises(ValueError, match="chunk_dtype"):
        preprocess_graph(edge_index, N, chunk_dtype="f16", device="cpu")


def _hub_edge_list(rng):
    """A directed edge list on 300 nodes without self-loops: node 5 has 160
    in-edges and node 7 160 out-edges (one row of >= 150 edges in the CSR
    and one in its transpose), nodes 280-299 have no edge at all."""
    n = 300
    ei = rng.integers(0, n - 20, (2, 1200))
    fan = rng.permutation(np.arange(20, n - 20))[:160]
    ei = np.concatenate([ei, np.stack([fan, np.full(160, 5)]),
                         np.stack([np.full(160, 7), fan])], axis=1)
    return ei[:, ei[0] != ei[1]], n


@pytest.mark.parametrize("chunk_dtype", ["f32", "bf16"])
def test_plain_edge_value_backward_matches_jax(chunk_dtype):
    """The plain backward, ``spmm_edge_values_backward``, against the JAX
    package's ``_spmm_ev_bwd`` (``jax.vjp`` of ``chunked_spmm_edge_values``,
    the Pallas kernel in interpret mode), head by head, on a graph with a
    160-edge row in each CSR and empty rows. dv reads the unrounded g and x
    on both sides: rtol 1e-5. dx: rtol 1e-5 with f32 messages; with bf16
    messages the Pallas kernel also rounds v to bf16 (the port keeps it
    f32), so each entry may differ by 2^-8 of sum |v| |msg|."""
    rng = np.random.default_rng(12)
    ei, n = _hub_edge_list(rng)
    jg = jax_preprocess_graph(ei, n, undirected=False, self_loops=False,
                              chunk_dtype=chunk_dtype, **CHUNKS)
    g = preprocess_graph(ei, n, undirected=False, self_loops=False, chunk_dtype=chunk_dtype,
                         device="cpu")
    deg, t_deg = np.diff(g.indptr.numpy()), np.diff(g.t_indptr.numpy())
    assert deg.max() >= 150 and t_deg.max() >= 150
    assert (deg[n - 20:] == 0).all() and (t_deg[n - 20:] == 0).all()
    x = rng.standard_normal((n, HEADS, HIDDEN)).astype(np.float32)
    v = rng.random((g.num_edges, HEADS)).astype(np.float32)
    cot = rng.standard_normal((n, HEADS, HIDDEN)).astype(np.float32)
    dtype = jnp.float32 if chunk_dtype == "f32" else jnp.bfloat16
    want_dx, want_dv = [], []
    for h in range(HEADS):
        _, vjp = jax.vjp(lambda a, b: chunked_spmm_edge_values(
            a, jg.chunks, b, jg.edge_src, jg.edge_dst, compute_dtype=dtype, interpret=True),
            jnp.asarray(x[:, h]), jnp.asarray(v[:, h]))
        dx_h, dv_h = vjp(jnp.asarray(cot[:, h]))
        want_dx.append(np.asarray(dx_h))
        want_dv.append(np.asarray(dv_h))
    want_dx, want_dv = np.stack(want_dx, axis=1), np.stack(want_dv, axis=1)
    msg = torch.float32 if chunk_dtype == "f32" else torch.bfloat16
    dx, dv = spmm_edge_values_backward(torch.from_numpy(cot), torch.from_numpy(x),
                                       torch.from_numpy(v), g.t_edge_src, g.t_edge_dst,
                                       g.t_perm, msg)
    assert dx.dtype == torch.float32 and dv.dtype == torch.float32
    np.testing.assert_allclose(dv.numpy(), want_dv, rtol=1e-5, atol=1e-5)
    if chunk_dtype == "f32":
        np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-5, atol=1e-5)
    else:
        scale = spmm_edge_values(torch.from_numpy(cot).to(torch.bfloat16).abs(),
                                 g.t_edge_src, g.t_edge_dst,
                                 torch.from_numpy(np.abs(v))[g.t_perm.long()], n,
                                 torch.float32).numpy()
        assert np.all(np.abs(dx.numpy() - want_dx) <= 2.0 ** -8 * scale + 1e-6)


def _parent_backward(g, cot, x, v, msg):
    """The gradient as the parent formulation computes it: dx is
    csr_spmm_ev of the rounded cotangent on the transposed CSR with
    ``v[t_perm]``, dv is sddmm on the dst-sorted CSR."""
    dx = csr_spmm_ev(cot.to(msg), g.t_indptr, g.t_edge_src, g.t_edge_dst,
                     v.index_select(0, g.t_perm.long()), x.dtype)
    return dx, sddmm(cot, x, g.indptr, g.edge_src, g.edge_dst)


@pytest.mark.parametrize("need_dx,need_dv", [(True, True), (True, False), (False, True),
                                             (False, False)])
@pytest.mark.parametrize("x_dtype,msg", [(torch.float32, torch.float32),
                                         (torch.float32, torch.bfloat16),
                                         (torch.bfloat16, torch.bfloat16)])
def test_csr_spmm_ev_bwd_on_the_cpu_is_the_parent_formulation(need_dx, need_dv, x_dtype, msg):
    """The fused wrapper on CPU tensors: dx bitwise the parent formulation's,
    dv within 1e-6 of it (the same dots, gathered in another edge order); a
    gradient not asked for is None; no launch is counted."""
    ei, n = _hub_edge_list(np.random.default_rng(13))
    g = preprocess_graph(ei, n, undirected=False, self_loops=False, device="cpu")
    gen = torch.Generator().manual_seed(14)
    x = torch.randn(n, HEADS, HIDDEN, generator=gen).to(x_dtype)
    cot = torch.randn(n, HEADS, HIDDEN, generator=gen).to(x_dtype)
    v = torch.rand(g.num_edges, HEADS, generator=gen)
    before = spmm_kernel.ev_bwd_launches
    dx, dv = csr_spmm_ev_bwd(cot, x, v, *_csr_t(g), msg, g.t_hub_segments, g.hub_edges,
                             need_dx, need_dv)
    assert spmm_kernel.ev_bwd_launches == before
    want_dx, want_dv = _parent_backward(g, cot, x, v, msg)
    if need_dx:
        assert dx.dtype == x_dtype and torch.equal(dx, want_dx)
    else:
        assert dx is None
    if need_dv:
        assert dv.dtype == torch.float32
        torch.testing.assert_close(dv, want_dv, rtol=1e-6, atol=1e-6)
    else:
        assert dv is None


@pytest.mark.parametrize("chunk_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("wrt", ["both", "x", "values"])
def test_edge_value_gradients_on_the_cpu_are_unchanged(chunk_dtype, wrt):
    """``propagate_edge_values``'s gradients through the autograd Function
    (one csr_spmm_ev_bwd call, its flags from what needs a gradient): dx
    bitwise the parent formulation's, dv within 1e-6 of it."""
    ei, n = _hub_edge_list(np.random.default_rng(15))
    g = preprocess_graph(ei, n, undirected=False, self_loops=False, chunk_dtype=chunk_dtype,
                         device="cpu")
    msg = torch.float32 if chunk_dtype == "f32" else torch.bfloat16
    gen = torch.Generator().manual_seed(16)
    x = torch.randn(n, HEADS, HIDDEN, generator=gen).requires_grad_(wrt != "values")
    v = torch.rand(g.num_edges, HEADS, generator=gen).requires_grad_(wrt != "x")
    cot = torch.randn(n, HEADS, HIDDEN, generator=gen)
    inputs = [t for t in (x, v) if t.requires_grad]
    grads = dict(zip([id(t) for t in inputs], torch.autograd.grad(
        g.propagate_edge_values(x, v), inputs, cot)))
    want_dx, want_dv = _parent_backward(g, cot, x.detach(), v.detach(), msg)
    if x.requires_grad:
        assert torch.equal(grads[id(x)], want_dx)
    if v.requires_grad:
        torch.testing.assert_close(grads[id(v)], want_dv, rtol=1e-6, atol=1e-6)


def test_edge_value_backward_refuses_a_plan_without_its_length():
    """csr_spmm_ev_bwd and sddmm take a hub plan only with its segment
    length, on CPU tensors too (checked before the device is)."""
    ei, n = _hub_edge_list(np.random.default_rng(17))
    g = preprocess_graph(ei, n, undirected=False, self_loops=False, device="cpu")
    x = torch.randn(n, HEADS, HIDDEN)
    v = torch.rand(g.num_edges, HEADS)
    with pytest.raises(ValueError, match="segment length"):
        csr_spmm_ev_bwd(x, x, v, *_csr_t(g), torch.float32, g.t_hub_segments)
    with pytest.raises(ValueError, match="segment length"):
        sddmm(x, x, *_csr(g), g.hub_segments)
    with pytest.raises(TypeError):
        csr_spmm_ev_bwd(x, x.to(torch.bfloat16), v, *_csr_t(g), torch.float32)
    dx, dv = csr_spmm_ev_bwd(x, x, v, *_csr_t(g), torch.float32, g.t_hub_segments,
                             g.hub_edges)
    assert dx.shape == x.shape and dv.shape == v.shape


def _flat(tree):
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _models(kind):
    if kind == "gat":
        return (JaxGAT(HIDDEN, C, heads=HEADS, dropout=0.0),
                lambda: GAT(F, HIDDEN, C, heads=HEADS, dropout=0.0, device="cpu"))
    return (JaxGATJK(HIDDEN, C, heads=HEADS, dropout=0.0),
            lambda: GATJK(F, HIDDEN, C, heads=HEADS, dropout=0.0, device="cpu"))


@pytest.mark.parametrize("kind", ["gat", "gatjk"])
def test_gat_forward_and_gradients_match_jax(problem, kind):
    """Train mode (BatchNorm on batch statistics, dropout 0), JAX on the
    chunked graph (the Pallas kernel in interpret mode, f32 messages); the
    loss, every parameter's gradient and the BatchNorm statistics, at
    ``tests/test_baselines.py``'s tolerances."""
    edge_index, x, _ = problem
    jg = jax_preprocess_graph(edge_index, N, chunk_dtype="f32", **CHUNKS)
    jmodel, make = _models(kind)
    variables = _randomize(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jg), 9)
    cot = np.random.default_rng(6).standard_normal((N, C)).astype(np.float32)

    def loss(p):
        out, mut = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                jnp.asarray(x), jg, train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mut["batch_stats"])

    (_, (want, new_bs)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    model = load_flax_variables(make(), jax.tree.map(np.asarray, variables)).train()
    g = preprocess_graph(edge_index, N, chunk_dtype="f32", device="cpu")
    out = model(torch.from_numpy(x), g)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    flat_g, flat_bs = _flat(grads), _flat(new_bs)
    # a conv bias that feeds a train-mode BatchNorm has an exact gradient of
    # 0 (the batch mean takes any shift out): both sides give rounding
    # noise, held to 1e-5 of the gradient of the BatchNorm shift after it
    scale_of = {("conv_0", "bias"): ("bn_0", "bias")}
    seen = 0
    for path, tensor, transpose in _plan(model):
        if path[0] == "params":
            got = tensor.grad.numpy()
            key = path[1:]
            atol = (1e-5 * np.abs(flat_g[scale_of[key]]).max() if key in scale_of
                    else 1e-5)
            np.testing.assert_allclose(got.T if transpose else got, flat_g[key],
                                       rtol=1e-3, atol=atol, err_msg="/".join(path))
        else:
            np.testing.assert_allclose(tensor.numpy(), flat_bs[path[1:]], rtol=1e-5,
                                       atol=1e-6, err_msg="/".join(path))
        seen += 1
    assert seen == len(flat_g) + len(flat_bs)


def test_gat_trainer_steps_match_jax(problem):
    """Five Adam steps of GAT with dropout 0 and the CLI's baseline
    optimiser settings, the JAX trainer on the chunked graph: the losses at
    rtol 1e-4, and the loss falls."""
    edge_index, x, label = problem
    jg = jax_preprocess_graph(edge_index, N, chunk_dtype="f32", **CHUNKS)
    tc = dict(lr=0.01, trans_weight_decay=5e-3, gnn_weight_decay=5e-3)
    split = {"train": np.arange(0, N, 2)}
    jtrainer = JaxTrainer(JaxGAT(HIDDEN, C, heads=HEADS, dropout=0.0), jg, x,
                          label.reshape(-1, 1), JaxTrainConfig(**tc))
    state, tx, opt_state = jtrainer.init_state(jax.random.PRNGKey(0))
    step, _ = jtrainer._build_steps(tx)
    train_idx = jtrainer._prepare_train_idx(split)
    jstate = jax.tree.map(jnp.array, state)
    want = []
    for i in range(5):
        jstate, opt_state, loss = step(jstate, opt_state, jax.random.PRNGKey(i), train_idx)
        want.append(float(loss))
    model = GAT(F, HIDDEN, C, heads=HEADS, dropout=0.0, device="cpu")
    trainer = Trainer(model, preprocess_graph(edge_index, N, device="cpu"), x,
                      label.reshape(-1, 1), TrainConfig(**tc), device="cpu")
    trainer.init_state(0)
    load_flax_variables(model, jax.tree.map(np.asarray, state))
    got = trainer.multi_step(trainer.prepare_train_idx(split), 5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def _index_add(msgs, dst, n):
    """The sequential ``index_add`` sum the fixed-order sums replaced."""
    return torch.zeros(n, *msgs.shape[1:], dtype=msgs.dtype).index_add(0, dst.long(), msgs)


@pytest.mark.parametrize("op,order", [
    *((op, order) for op in ("spmm_f32", "spmm_bf16", "edge_values", "edge_values_bwd")
      for order in ("csr", "shuffled")),
    ("edge_softmax", "csr"), ("edge_softmax_heads", "csr")])
def test_fixed_order_sums_are_bitwise_the_index_add_forms(op, order):
    """On the CPU each plain aggregation (``spmm``, ``spmm_edge_values`` and
    the dx of its backward) and ``edge_softmax`` with its gradient give the
    bits of the sequential ``index_add`` forms they replaced, on a graph
    with a 600-edge row, a 160-edge row and empty rows: in CSR order, and
    the aggregations also on shuffled edges (the edge softmax takes CSR
    order only)."""
    rng = np.random.default_rng(13)
    ei, n = _hub_edge_list(rng)
    ei = np.concatenate([ei, np.stack([rng.integers(0, n - 20, 600), np.full(600, 9)])],
                        axis=1)
    g = preprocess_graph(ei[:, ei[0] != ei[1]], n, undirected=False, self_loops=False,
                         device="cpu")
    assert np.diff(g.indptr.numpy()).max() >= 600
    src, dst = g.edge_src.long(), g.edge_dst.long()
    e = g.num_edges

    def check(got, msgs, d, dtype=torch.float32):
        assert got.dtype == dtype and torch.equal(got, _index_add(msgs, d, n).to(dtype))

    if order == "shuffled":
        perm = torch.from_numpy(rng.permutation(e))
        src, dst = src[perm], dst[perm]
    if op.startswith("spmm"):
        dtype = torch.float32 if op == "spmm_f32" else torch.bfloat16
        x = torch.from_numpy(rng.standard_normal((n, 7)).astype(np.float32)).to(dtype)
        w = torch.from_numpy(rng.random(e).astype(np.float32))
        check(spmm(x, src, dst, w, n), x.float().index_select(0, src) * w[:, None], dst, dtype)
        if order == "csr":  # and its gradient: each edge's message gathers its row's
            xg = x.float().requires_grad_()
            cot = torch.randn(n, 7, generator=torch.Generator().manual_seed(0))
            (gx,) = torch.autograd.grad(spmm(xg, src, dst, w, n), xg, cot)
            assert torch.equal(gx, _index_add(cot[dst] * w[:, None], src, n))
        return
    heads = 2 if op != "edge_softmax" else None
    if op.startswith("edge_values"):
        x = torch.from_numpy(rng.standard_normal((n, heads, 5)).astype(np.float32))
        v = torch.from_numpy(rng.random((e, heads)).astype(np.float32))
        if op == "edge_values":
            check(spmm_edge_values(x, src, dst, v, n), x.index_select(0, src) * v[..., None], dst)
            return
        # dx reads the transposed order (its rows: the sources)
        t = [g.t_edge_src.long(), g.t_edge_dst.long(), g.t_perm.long()]
        if order == "shuffled":
            t = [a[perm] for a in t]
        cot = torch.from_numpy(rng.standard_normal((n, heads, 5)).astype(np.float32))
        dx, _ = spmm_edge_values_backward(cot, x, v, *t, torch.bfloat16, need_dv=False)
        check(dx, cot.to(torch.bfloat16).float().index_select(0, t[0])
              * v.index_select(0, t[2])[..., None], t[1])
        return
    shape = (e,) if heads is None else (e, heads)
    scores = torch.from_numpy((rng.standard_normal(shape) * 3).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def old_softmax(s):
        shape_n = (n,) + tuple(s.shape[1:])
        idx = dst.view(-1, *([1] * (s.dim() - 1))).expand_as(s)
        mx = torch.full(shape_n, float("-inf")).scatter_reduce(0, idx, s.detach(), "amax",
                                                               include_self=True)
        mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
        ex = torch.exp(s - mx[dst])
        return ex / _index_add(ex, dst, n)[dst].clamp(min=1e-16)

    outs = []
    for fn in (lambda s: edge_softmax(s, dst, n), old_softmax):
        s = scores.clone().requires_grad_()
        out = fn(s)
        (grad,) = torch.autograd.grad(out, s, cot)
        outs.append((out.detach(), grad))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
