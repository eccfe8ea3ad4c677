"""The rest of the port's large-tier zoo, ``GCN`` and ``SGFormer(gnn="gcn")``
against the JAX package on the CPU, with the flax variables (randomised)
copied in by ``load_flax_variables``: the forward and every parameter's
gradient in eval mode, label propagation, and the parameter bridge for every
ported model; ``H2GCN`` with its two edge sets from ``build_h2_graphs``
(bitwise the JAX function's edges).

f32 throughout and only the summation order differs; the zoo's tolerances of
``tests/test_baselines.py`` apply (forward 1e-4 relative / 1e-5 absolute,
gradients 1e-3 / 1e-5), since several hops of propagation amplify it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_numpy as ref
from test_torch_gat import _flat
from test_torch_modules import _randomize

from sgformer_tpu.graph import build_h2_graphs as jax_build_h2_graphs
from sgformer_tpu.graph import preprocess_graph as jax_preprocess_graph
from sgformer_tpu.nn import GCN as JaxGCN
from sgformer_tpu.nn import SGFormer as JaxSGFormer
from sgformer_tpu.nn import SGFormerConfig as JaxConfig
from sgformer_tpu.nn import baselines as jz

from sgformer_tpu_torch import load_flax_variables, preprocess_graph
from sgformer_tpu_torch.convert import _plan
from sgformer_tpu_torch.graph import build_h2_graphs
from sgformer_tpu_torch.nn import (
    APPNP,
    GAT,
    GATJK,
    GCN,
    GCNJK,
    GPRGNN,
    H2GCN,
    LINK,
    MLP,
    SGC,
    SGC2,
    SIGN,
    GraphModel,
    MixHop,
    MultiLP,
    SGCMem,
    SGFormer,
    SGFormerConfig,
)

torch.set_num_threads(1)

N, F, C, H = 400, 12, 4, 16
CPU = dict(device="cpu")

# name -> (flax module, the port's module)
MODELS = {
    "mlp": (lambda: jz.MLP(H, C), lambda **kw: MLP(F, H, C, **CPU, **kw)),
    "link": (lambda: jz.LINK(N, C), lambda **kw: LINK(N, C, **CPU, **kw)),
    "sgc": (lambda: jz.SGC(C, hops=2), lambda **kw: SGC(F, C, hops=2, **CPU, **kw)),
    "sgcmem": (lambda: jz.SGCMem(C, hops=3), lambda **kw: SGCMem(F, C, hops=3, **CPU, **kw)),
    "sgc2": (lambda: jz.SGC2(H, C, hops=2), lambda **kw: SGC2(F, H, C, hops=2, **CPU, **kw)),
    "sign": (lambda: jz.SIGN(H, C, hops=2, num_layers=3),
             lambda **kw: SIGN(F, H, C, hops=2, num_layers=3, **CPU, **kw)),
    "mixhop": (lambda: jz.MixHop(H, C, hops=2), lambda **kw: MixHop(F, H, C, hops=2, **CPU, **kw)),
    "gcnjk": (lambda: jz.GCNJK(H, C, num_layers=3),
              lambda **kw: GCNJK(F, H, C, num_layers=3, **CPU, **kw)),
    "gcnjk-max": (lambda: jz.GCNJK(H, C, jk_type="max"),
                  lambda **kw: GCNJK(F, H, C, jk_type="max", **CPU, **kw)),
    "gatjk-max": (lambda: jz.GATJK(8, C, heads=2, jk_type="max"),
                  lambda **kw: GATJK(F, 8, C, heads=2, jk_type="max", **CPU, **kw)),
    "appnp": (lambda: jz.APPNP(H, C, K=4), lambda **kw: APPNP(F, H, C, K=4, **CPU, **kw)),
    "gprgnn": (lambda: jz.GPRGNN(H, C, K=4), lambda **kw: GPRGNN(F, H, C, K=4, **CPU, **kw)),
    "gcn": (lambda: JaxGCN(H, C, num_layers=3),
            lambda **kw: GCN(F, H, C, num_layers=3, **CPU, **kw)),
    "sgformer-gcn": (lambda: JaxSGFormer(JaxConfig.medium(H, C, gnn_num_layers=2)),
                     lambda **kw: SGFormer(SGFormerConfig.medium(H, C, gnn_num_layers=2), F,
                                      **CPU, **kw)),
}


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(8)
    edge_index = ref.random_graph(rng, N, 2000)
    x = rng.standard_normal((N, F)).astype(np.float32)
    label = rng.integers(0, C, N)
    jg = jax_preprocess_graph(edge_index, N, with_pyg_norm=True)
    g = preprocess_graph(edge_index, N, with_pyg_norm=True, device="cpu")
    return jg, g, x, label


@pytest.mark.parametrize("name", sorted(MODELS))
def test_zoo_forward_and_gradients_match_jax(problem, name):
    jg, g, x, _ = problem
    make_jax, make_port = MODELS[name]
    jmodel = make_jax()
    variables = _randomize(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jg,
                                       train=False), 3)
    cot = np.random.default_rng(4).standard_normal((N, C)).astype(np.float32)

    def loss(p):
        out = jmodel.apply({**variables, "params": p}, jnp.asarray(x), jg, train=False)
        return jnp.sum(out * cot), out

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    model = load_flax_variables(make_port(), jax.tree.map(np.asarray, variables)).eval()
    out = model(torch.from_numpy(x), g)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    flat_g = _flat(grads)
    checked = 0
    for path, tensor, transpose in _plan(model):
        if path[0] != "params":
            continue
        got = tensor.grad.numpy()
        np.testing.assert_allclose(got.T if transpose else got, flat_g[path[1:]],
                                   rtol=1e-3, atol=1e-5, err_msg="/".join(path))
        checked += 1
    assert checked == len(flat_g)


@pytest.mark.parametrize("mult_bin", [False, True])
def test_multilp_matches_jax(problem, mult_bin):
    jg, g, _, label = problem
    train_idx = np.arange(0, N, 2)
    if mult_bin:
        label = np.random.default_rng(5).integers(0, 2, (N, 3))
        args = dict(out_channels=3, alpha=0.5, hops=1, num_iters=10, mult_bin=True)
    else:
        label = label.reshape(-1, 1)
        args = dict(out_channels=C, alpha=0.5, hops=2, num_iters=20)
    want = np.asarray(jz.MultiLP(**args).predict(jg, label, train_idx))
    got = MultiLP(**args).predict(g, label, train_idx).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


ALL_PORTED = dict(MODELS, **{
    "gat": (lambda: jz.GAT(8, C, heads=2), lambda **kw: GAT(F, 8, C, heads=2, **CPU, **kw)),
    "gatjk": (lambda: jz.GATJK(8, C, heads=2), lambda **kw: GATJK(F, 8, C, heads=2, **CPU, **kw)),
    "sgformer-large": (lambda: JaxSGFormer(JaxConfig.large(H, C, gnn_num_layers=2)),
                       lambda **kw: SGFormer(SGFormerConfig.large(H, C, gnn_num_layers=2), F,
                                        **CPU, **kw)),
})


@pytest.mark.parametrize("name", sorted(ALL_PORTED))
def test_convert_fills_every_ported_model_exactly(problem, name):
    """Every flax variable lands in the port's model, none is left over and
    no tensor of the model is left unfilled; an extra or a missing key
    raises."""
    jg, g, x, _ = problem
    make_jax, make_port = ALL_PORTED[name]
    variables = jax.tree.map(np.asarray, _randomize(
        make_jax().init(jax.random.PRNGKey(1), jnp.asarray(x), jg, train=False), 7))
    model = load_flax_variables(make_port(), variables)
    flat = _flat(variables)
    assert len(list(_plan(model))) == len(flat)
    for path, tensor, transpose in _plan(model):
        value = flat[path]
        np.testing.assert_array_equal(tensor.detach().numpy(), value.T if transpose else value)
    extra = {**variables, "params": {**variables["params"], "stray": np.zeros(3, np.float32)}}
    with pytest.raises(KeyError, match="stray"):
        load_flax_variables(make_port(), extra)
    first = sorted(variables["params"])[0]
    missing = {**variables, "params": {k: v for k, v in variables["params"].items()
                                       if k != first}}
    with pytest.raises(KeyError):
        load_flax_variables(make_port(), missing)


@pytest.mark.parametrize("name", sorted(ALL_PORTED))
def test_reset_parameters_redraws_what_a_new_model_draws(name):
    """The shared ``GraphModel`` helper: a model reset from a generator
    seeded s equals a new model built from one seeded s, and dropout draws
    only from the generator it was given."""
    model = ALL_PORTED[name][1]()
    assert isinstance(model, GraphModel)
    for p in model.parameters():
        p.data.add_(1.0)
    model.reset_parameters(torch.Generator().manual_seed(11))
    fresh = ALL_PORTED[name][1](generator=torch.Generator().manual_seed(11))
    got, want = model.state_dict(), fresh.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    gen = torch.Generator().manual_seed(2)
    model.set_dropout_generator(gen)
    assert all(m.generator is gen for m in model.modules() if hasattr(m, "rate"))


# -- H2GCN -------------------------------------------------------------------


@pytest.fixture(scope="module")
def h2_problem():
    rng = np.random.default_rng(12)
    # self-loops, duplicates and one direction only: build_h2_graphs drops,
    # merges and symmetrises them
    edge_index = np.concatenate([ref.random_graph(rng, N, 1200),
                                 np.array([[5, 6, 6], [5, 7, 7]])], axis=1)
    x = rng.standard_normal((N, F)).astype(np.float32)
    jg = jax_preprocess_graph(edge_index, N)
    g = preprocess_graph(edge_index, N, device="cpu")
    return edge_index, x, jg, g, jax_build_h2_graphs(edge_index, N), \
        build_h2_graphs(edge_index, N, device="cpu")


def test_build_h2_graphs_matches_jax(h2_problem):
    _, _, _, _, jh2, h2 = h2_problem
    for jgr, gr in zip(jh2, h2):
        for name in ("edge_src", "edge_dst", "indptr"):
            np.testing.assert_array_equal(getattr(gr, name).numpy(),
                                          np.asarray(getattr(jgr, name)), err_msg=name)
        np.testing.assert_allclose(gr.gcn_weight.numpy(), np.asarray(jgr.gcn_weight),
                                   rtol=1e-6, atol=0)
        assert gr.num_edges == jgr.num_edges and not gr.symmetric
        assert gr.t_indptr is not None and gr.t_hub_segments is not None
        src, dst = gr.edge_src.numpy(), gr.edge_dst.numpy()
        assert not (src == dst).any()  # no self-loop in either set
    a1 = set(zip(*(t.numpy().tolist() for t in (h2[0].edge_src, h2[0].edge_dst))))
    a2 = set(zip(*(t.numpy().tolist() for t in (h2[1].edge_src, h2[1].edge_dst))))
    assert a1 and a2 and not a1 & a2  # the 2-hop set holds no 1-hop pair


@pytest.mark.parametrize("num_layers", [1, 2])
def test_h2gcn_forward_and_gradients_match_jax(h2_problem, num_layers):
    _, x, jg, g, jh2, h2 = h2_problem
    jmodel = jz.H2GCN(H, C, num_layers=num_layers)
    variables = _randomize(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jg, train=False,
                                       h2_graphs=jh2), 5)
    cot = np.random.default_rng(6).standard_normal((N, C)).astype(np.float32)

    def loss(p, xx):
        out = jmodel.apply({"params": p}, xx, jg, train=False, h2_graphs=jh2)
        return jnp.sum(out * cot), out

    (_, want), (grads, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    model = load_flax_variables(H2GCN(F, H, C, num_layers=num_layers, **CPU),
                                jax.tree.map(np.asarray, variables)).eval()
    xt = torch.from_numpy(x).requires_grad_(True)
    out = model(xt, g, h2_graphs=h2)
    (out * torch.from_numpy(cot)).sum().backward()

    def close(got, want, what):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                                   err_msg=what)

    close(out.detach().numpy(), want, "forward")
    close(xt.grad.numpy(), gx, "x")
    for name in ("w_embed", "w_classify"):
        close(getattr(model, name).grad.numpy(), grads[name], name)
    with pytest.raises(ValueError, match="h2_graphs"):
        model(xt, g)


def test_h2gcn_parameters_bridge_and_reset(h2_problem):
    _, x, jg, _, jh2, _ = h2_problem
    variables = jax.tree.map(np.asarray, _randomize(
        jz.H2GCN(H, C).init(jax.random.PRNGKey(1), jnp.asarray(x), jg, train=False,
                            h2_graphs=jh2), 7))
    model = load_flax_variables(H2GCN(F, H, C, **CPU), variables)
    assert len(list(_plan(model))) == len(_flat(variables)) == 2
    for path, tensor, transpose in _plan(model):
        assert not transpose
        np.testing.assert_array_equal(tensor.detach().numpy(), _flat(variables)[path])
    model.reset_parameters(torch.Generator().manual_seed(11))
    fresh = H2GCN(F, H, C, generator=torch.Generator().manual_seed(11), **CPU)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), fresh.parameters()))
    # flax's xavier_uniform bound on the [in, out] weights
    bound = np.sqrt(6.0 / (F + H))
    assert 0.5 * bound < fresh.w_embed.abs().max().item() <= bound
