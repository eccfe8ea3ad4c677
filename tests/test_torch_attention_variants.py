"""The port's ablation attentions (``ops/attention_variants.py``) and
DIFFormer's attention against the JAX package's on the CPU, on the same
seeded numpy inputs; then SGFormer with each ablation kernel against the JAX
SGFormer, its flax variables carried across by ``load_flax_variables``.

Tolerances: forward rtol 1e-5 / atol 1e-6, gradients (through a seeded
cotangent) rtol 1e-4 / atol 1e-6 times the largest gradient; f32 throughout,
only the summation order differs. Performer's projection cannot be drawn
alike by ``jax.random`` and a ``torch.Generator``, so the JAX projection is
passed in; the port's own draw is checked statistically, as
``tests/test_attention_variants.py`` checks the JAX one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_numpy as ref
from test_torch_modules import _randomize

from sgformer_tpu.graph import preprocess_graph as jax_preprocess_graph
from sgformer_tpu.nn import SGFormer as JaxSGFormer
from sgformer_tpu.nn import SGFormerConfig as JaxConfig
from sgformer_tpu.nn.difformer import difformer_attention as jax_difformer_attention
from sgformer_tpu.ops import attention_variants as jv

from sgformer_tpu_torch import load_flax_variables, preprocess_graph
from sgformer_tpu_torch.nn import SGFormer, SGFormerConfig
from sgformer_tpu_torch.nn.difformer import difformer_attention
from sgformer_tpu_torch.ops import attention_variants as tv

torch.set_num_threads(1)

N, H, M, D = 40, 2, 8, 6


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(2)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((N, H, M), (N, H, M), (N, H, D)))


def _close(got, want, rtol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 if rtol <= 1e-5 else 1e-6 * np.abs(want).max(),
                               err_msg=what)


def check_grads(model, grads, rtol=1e-4):
    """Every parameter's gradient against the flax tree ``grads`` (the
    ``params`` collection): rtol 1e-4 and an absolute 1e-4 of the largest
    gradient of the model, since a parameter whose gradient vanishes (the
    query weights behind a saturated softmax, a bias before a train-mode
    BatchNorm) holds only rounding noise in either package."""
    from test_torch_gat import _flat

    from sgformer_tpu_torch.convert import _plan

    flat = _flat(grads)
    scale = max(np.abs(np.asarray(v)).max() for v in flat.values())
    checked = 0
    for path, tensor, transpose in _plan(model):
        if path[0] != "params":
            continue
        got = tensor.grad.numpy()
        np.testing.assert_allclose(got.T if transpose else got, np.asarray(flat[path[1:]]),
                                   rtol=rtol, atol=rtol * scale, err_msg="/".join(path))
        checked += 1
    assert checked == len(flat)


def _check(jax_fn, torch_fn, inputs, n_out=1, seed=3):
    """jax_fn and torch_fn on the same inputs: every output at 1e-5, the
    gradient of each input (a seeded cotangent on every output) at 1e-4."""
    rng = np.random.default_rng(seed)
    want, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in inputs])
    want = want if n_out > 1 else (want,)
    cots = [rng.standard_normal(np.shape(w)).astype(np.float32) for w in want]
    grads_want = vjp(tuple(jnp.asarray(c) for c in cots) if n_out > 1 else jnp.asarray(cots[0]))
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    got = torch_fn(*ts)
    got = got if n_out > 1 else (got,)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == tuple(np.shape(w))
        _close(g.detach().numpy(), w, 1e-5, f"output {i}")
    sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, cots)).backward()
    for i, (t, w) in enumerate(zip(ts, grads_want)):
        _close(t.grad.numpy(), w, 1e-4, f"gradient {i}")


@pytest.mark.parametrize("name", ["softmax_attention", "gat_attention"])
@pytest.mark.parametrize("output_attn", [False, True])
def test_dense_attentions_match_jax(qkv, name, output_attn):
    _check(lambda *a: getattr(jv, name)(*a, output_attn=output_attn),
           lambda *a: getattr(tv, name)(*a, output_attn=output_attn), qkv,
           n_out=2 if output_attn else 1)


@pytest.mark.parametrize("is_query", [True, False])
def test_softmax_kernel_transformation_matches_jax(qkv, is_query):
    proj = np.asarray(jv.create_projection_matrix(12, M, jax.random.PRNGKey(4)))
    _check(lambda d, p: jv.softmax_kernel_transformation(d, is_query, p),
           lambda d, p: tv.softmax_kernel_transformation(d, is_query, p), (qkv[0], proj))


@pytest.mark.parametrize("tau,stabilizer", [(0.25, 1e-6), (1.0, 1e-4)])
def test_performer_with_the_jax_projection_matches_jax(qkv, tau, stabilizer):
    proj = np.asarray(jv.create_projection_matrix(2 * M, M, jax.random.PRNGKey(1)))
    kw = dict(tau=tau, numerical_stabilizer=stabilizer)
    _check(lambda q, k, v: jv.performer_attention(q, k, v, projection=jnp.asarray(proj), **kw),
           lambda q, k, v: tv.performer_attention(q, k, v, projection=torch.from_numpy(proj),
                                                  **kw), qkv)


def test_performer_edge_weights_match_jax(qkv):
    proj = np.asarray(jv.create_projection_matrix(2 * M, M, jax.random.PRNGKey(1)))
    edges = ref.random_graph(np.random.default_rng(0), N, 80)
    _check(lambda q, k, v: jv.performer_attention(q, k, v, projection=jnp.asarray(proj),
                                                  edge_index=jnp.asarray(edges)),
           lambda q, k, v: tv.performer_attention(q, k, v, projection=torch.from_numpy(proj),
                                                  edge_index=torch.from_numpy(edges)),
           qkv, n_out=2)
    _, w = tv.performer_attention(*map(torch.from_numpy, qkv), projection=torch.from_numpy(proj),
                                  edge_index=torch.from_numpy(edges))
    assert w.shape == (80, H) and (w > 0).all() and torch.isfinite(w).all()


def test_performer_needs_a_generator_or_a_projection(qkv):
    with pytest.raises(ValueError, match="generator"):
        tv.performer_attention(*map(torch.from_numpy, qkv))
    out = tv.performer_attention(*map(torch.from_numpy, qkv),
                                 generator=torch.Generator().manual_seed(0), num_features=24)
    assert out.shape == (N, H, D) and torch.isfinite(out).all()


@pytest.mark.parametrize("m,d", [(16, 8), (30, 32), (266, 64)])
def test_projection_rows_are_orthogonal_within_a_block(m, d):
    gen = torch.Generator().manual_seed(5)
    proj = tv.create_projection_matrix(m, d, gen).double()
    assert proj.shape == (m, d)
    rows = proj / proj.norm(dim=1, keepdim=True)
    for start in range(0, m, d):
        block = rows[start:start + d]
        np.testing.assert_allclose((block @ block.T).numpy(), np.eye(len(block)), atol=1e-5)
    # the row norms are chi-distributed with d degrees of freedom: mean near sqrt(d)
    assert abs(proj.norm(dim=1).mean().item() - np.sqrt(d)) < 0.25 * np.sqrt(d)
    again = tv.create_projection_matrix(m, d, torch.Generator().manual_seed(5))
    assert torch.equal(again, proj.float())


def test_random_features_estimate_the_softmax_kernel():
    """phi(q).phi(k) is exp(q.k / sqrt(d)) times a constant per query row
    (the stabilising shifts): the per-row log-ratio is near-constant, and
    the induced attention weights track the softmax."""
    rng = np.random.default_rng(2)
    n, d, m = 8, 8, 16384
    q = rng.standard_normal((n, 1, d)).astype(np.float32)
    k = rng.standard_normal((n, 1, d)).astype(np.float32)
    proj = tv.create_projection_matrix(m, d, torch.Generator().manual_seed(0))
    qp = tv.softmax_kernel_transformation(torch.from_numpy(q), True, proj)[:, 0].double()
    kp = tv.softmax_kernel_transformation(torch.from_numpy(k), False, proj)[:, 0].double()
    est = (qp @ kp.T).numpy()
    true = np.exp(q[:, 0] @ k[:, 0].T / np.sqrt(d))
    log_ratio = np.log(est) - np.log(true)
    assert np.all(log_ratio.std(axis=1) < 0.3), log_ratio.std(axis=1)
    w_est = est / est.sum(1, keepdims=True)
    w_true = true / true.sum(1, keepdims=True)
    assert np.abs(w_est - w_true).mean() < 0.05


@pytest.mark.parametrize("kernel", ["simple", "sigmoid"])
@pytest.mark.parametrize("output_attn", [False, True])
def test_difformer_attention_matches_jax(kernel, output_attn):
    rng = np.random.default_rng(7)
    qkv = tuple(rng.standard_normal((N, H, D)).astype(np.float32) for _ in range(3))
    _check(lambda *a: jax_difformer_attention(*a, kernel, output_attn),
           lambda *a: difformer_attention(*a, kernel, output_attn), qkv,
           n_out=2 if output_attn else 1)


def test_difformer_attention_refuses_an_unknown_kernel(qkv):
    with pytest.raises(ValueError, match="DIFFormer kernel"):
        difformer_attention(*map(torch.from_numpy, qkv), "performer")


# -- SGFormer with each ablation kernel -------------------------------------------

NG, FG, CG, HID = 60, 12, 3, 16


@pytest.fixture(scope="module")
def graph_problem():
    rng = np.random.default_rng(6)
    edge_index = ref.random_graph(rng, NG, 250)
    x = rng.standard_normal((NG, FG)).astype(np.float32)
    label = rng.integers(0, CG, NG)
    jg = jax_preprocess_graph(edge_index, NG, with_pyg_norm=True)
    g = preprocess_graph(edge_index, NG, with_pyg_norm=True, device="cpu")
    return jg, g, x, label


def _ablation_pair(kernel, gnn, seed):
    kw = dict(attention_kernel=kernel, gnn=gnn, trans_num_layers=2, trans_num_heads=2,
              gnn_num_layers=2, trans_dropout=0.0, gnn_dropout=0.0)
    jmodel = JaxSGFormer(JaxConfig(HID, CG, **kw))
    model = SGFormer(SGFormerConfig(HID, CG, **kw), FG, device="cpu")
    if kernel == "performer":
        # the JAX layers draw from PRNGKey(performer_seed = 0)
        proj = torch.from_numpy(np.asarray(jv.create_projection_matrix(
            2 * HID, HID, jax.random.PRNGKey(0))))
        for i in range(2):
            getattr(model.trans_conv, f"conv_{i}").projection.copy_(proj)
    return jmodel, model


@pytest.mark.parametrize("gnn", ["gcn", "graphconv"])
@pytest.mark.parametrize("kernel", ["softmax", "gat", "performer"])
def test_ablation_sgformer_logits_and_first_loss_match_jax(graph_problem, kernel, gnn):
    jg, g, x, label = graph_problem
    jmodel, model = _ablation_pair(kernel, gnn, 0)
    variables = _randomize(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jg, train=False),
                           3)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), jg, train=False))
    load_flax_variables(model, jax.tree.map(np.asarray, variables)).eval()
    got = model(torch.from_numpy(x), g).detach().numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    train_idx = np.arange(0, NG, 2)

    def jloss(p):
        out, _ = jmodel.apply({**variables, "params": p}, jnp.asarray(x), jg, train=True,
                              rngs={"dropout": jax.random.PRNGKey(1)},
                              mutable=["batch_stats"])
        logp = jax.nn.log_softmax(out, axis=-1)
        return -logp[train_idx, label[train_idx]].mean()

    want_loss, grads = jax.value_and_grad(jloss)(variables["params"])
    model.train()
    out = model(torch.from_numpy(x), g)
    loss = -torch.log_softmax(out, dim=-1)[train_idx, label[train_idx]].mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    check_grads(model, grads)


@pytest.mark.parametrize("kernel", ["softmax", "gat"])
def test_ablation_attention_maps_match_jax(graph_problem, kernel):
    jg, g, x, _ = graph_problem
    jmodel, model = _ablation_pair(kernel, "graphconv", 0)
    variables = _randomize(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jg, train=False),
                           5)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), method="get_attentions"))
    load_flax_variables(model, jax.tree.map(np.asarray, variables)).eval()
    got = model.get_attentions(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, NG, NG)
    _close(got, want, 1e-5)


def test_performer_has_no_attention_map_and_a_fixed_projection(graph_problem):
    _, g, x, _ = graph_problem
    cfg = SGFormerConfig(HID, CG, attention_kernel="performer", gnn="graphconv")
    model = SGFormer(cfg, FG, device="cpu").eval()
    with pytest.raises(ValueError, match="performer"):
        model.get_attentions(torch.from_numpy(x))
    proj = model.trans_conv.conv_0.projection
    assert proj.shape == (2 * HID, HID)
    # the same projection in every model and run, and none in the state dict
    other = SGFormer(cfg, FG, generator=torch.Generator().manual_seed(9), device="cpu")
    assert torch.equal(other.trans_conv.conv_0.projection, proj)
    model.reset_parameters(torch.Generator().manual_seed(3))
    assert torch.equal(model.trans_conv.conv_0.projection, proj)
    assert not any("projection" in k for k in model.state_dict())
