"""The rest of the port's large-tier zoo, ``GCN`` and ``SGFormer(gnn="gcn")``
against the JAX package on the CPU, with the flax variables (randomised)
copied in by ``load_flax_variables``: the forward and every parameter's
gradient in eval mode, label propagation, and the parameter bridge for every
ported model.

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

from sgformer_tpu.graph import preprocess_graph as jax_preprocess_graph
from sgformer_tpu.nn import GCN as JaxGCN
from sgformer_tpu.nn import SGFormer as JaxSGFormer
from sgformer_tpu.nn import SGFormerConfig as JaxConfig
from sgformer_tpu.nn import baselines as jz

from sgformer_tpu_torch import load_flax_variables, preprocess_graph
from sgformer_tpu_torch.convert import _plan
from sgformer_tpu_torch.nn import (
    APPNP,
    GAT,
    GATJK,
    GCN,
    GCNJK,
    GPRGNN,
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
