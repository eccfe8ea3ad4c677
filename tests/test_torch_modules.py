"""The port's modules against the flax modules of the JAX package, with the
flax variables copied in by ``load_flax_variables``, in f32. Parameters and
norm statistics are drawn at random so that no identity init hides a
mapping error. Tolerance 1e-5 (2e-5 through several layers): only the
summation order of products and norms differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgformer_tpu.graph import preprocess_graph as jax_preprocess_graph
from sgformer_tpu.nn.graphconv import GraphConv as JaxGraphConv
from sgformer_tpu.nn.layers import TorchLinear as JaxTorchLinear
from sgformer_tpu.nn.norm import MaskedBatchNorm as JaxMaskedBatchNorm
from sgformer_tpu.nn.transconv import TransConv as JaxTransConv

from sgformer_tpu_torch.convert import load_flax_variables
from sgformer_tpu_torch.graph import preprocess_graph
from sgformer_tpu_torch.nn import (
    Dropout,
    GraphConv,
    MaskedBatchNorm,
    SGFormer,
    SGFormerConfig,
    TorchLinear,
    TransConv,
)

torch.set_num_threads(1)

GEN = torch.Generator().manual_seed(0)


def _randomize(variables, seed):
    """Same tree, random leaves: params ~ U(-1, 1) (scales near 1),
    running variances positive."""
    rng = np.random.default_rng(seed)
    flat, tree = jax.tree_util.tree_flatten_with_path(variables)
    leaves = []
    for path, leaf in flat:
        names = [getattr(p, "key", "") for p in path]
        shape = np.shape(leaf)
        if names[-1] == "var":
            leaves.append(rng.uniform(0.5, 2.0, shape).astype(np.float32))
        elif names[-1] == "scale":
            leaves.append(rng.uniform(0.5, 1.5, shape).astype(np.float32))
        else:
            leaves.append(rng.uniform(-1.0, 1.0, shape).astype(np.float32))
    return jax.tree_util.tree_unflatten(tree, leaves)


def _x(n, f, seed=0):
    return np.random.default_rng(seed).standard_normal((n, f)).astype(np.float32)


def test_torch_linear_matches_flax():
    x = _x(50, 12)
    mod = JaxTorchLinear(7)
    variables = _randomize(mod.init(jax.random.PRNGKey(0), x), 1)
    want = np.asarray(mod.apply(variables, x))
    lin = load_flax_variables(TorchLinear(12, 7, generator=GEN), variables)
    np.testing.assert_allclose(lin(torch.from_numpy(x)).detach().numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_torch_linear_init_bounds_and_bf16_apply():
    lin = TorchLinear(64, 8, generator=torch.Generator().manual_seed(3))
    assert lin.weight.shape == (8, 64) and lin.weight.dtype == torch.float32
    assert lin.weight.abs().max() <= 1 / 8 and lin.bias.abs().max() <= 1 / 8
    x = torch.randn(5, 64, generator=GEN).to(torch.bfloat16)
    y = lin(x)
    assert y.dtype == torch.bfloat16
    want = (x @ lin.weight.t().to(torch.bfloat16)) + lin.bias.to(torch.bfloat16)
    assert torch.equal(y, want)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_masked_batchnorm_matches_flax(train, masked):
    x = _x(80, 6, seed=2) * 3.0 + 1.0
    mask = (np.arange(80) % 3 != 0).astype(np.float32) if masked else None
    mod = JaxMaskedBatchNorm()
    variables = _randomize(mod.init(jax.random.PRNGKey(0), x, train=False), 4)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    bn = load_flax_variables(MaskedBatchNorm(6), variables)
    bn.train(train)
    got = bn(torch.from_numpy(x), tmask).detach().numpy()
    if train:
        want, upd = mod.apply(variables, x, train=True, node_mask=jmask,
                              mutable=["batch_stats"])
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(upd["batch_stats"]["mean"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(upd["batch_stats"]["var"]), rtol=1e-5, atol=1e-6)
    else:
        want = mod.apply(variables, x, train=False, node_mask=jmask)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("residual_mode", ["alpha", "mean"])
@pytest.mark.parametrize("num_heads", [1, 2])
def test_transconv_matches_flax(residual_mode, num_heads):
    x = _x(120, 10, seed=5)
    kw = dict(num_layers=2, num_heads=num_heads, alpha=0.3, dropout=0.0,
              use_act=residual_mode == "mean", residual_mode=residual_mode)
    mod = JaxTransConv(16, **kw)
    variables = _randomize(mod.init(jax.random.PRNGKey(0), x), 6)
    want = np.asarray(mod.apply(variables, x))
    tc = load_flax_variables(TransConv(10, 16, generator=GEN, **kw), variables).eval()
    with torch.no_grad():
        got = tc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kw", [
    dict(num_layers=3),
    dict(num_layers=2, use_init=True),
    dict(num_layers=2, use_bn=False, use_residual=False),
])
def test_graphconv_matches_flax(kw):
    rng = np.random.default_rng(7)
    n = 150
    ei = rng.integers(0, n, (2, 600))
    x = _x(n, 9, seed=8)
    jg = jax_preprocess_graph(ei, n)
    mod = JaxGraphConv(16, dropout=0.0, **kw)
    variables = _randomize(mod.init(jax.random.PRNGKey(0), x, jg), 9)
    want = np.asarray(mod.apply(variables, x, jg, train=False))
    gc = load_flax_variables(GraphConv(9, 16, dropout=0.0, generator=GEN, **kw),
                             variables).eval()
    with torch.no_grad():
        got = gc(torch.from_numpy(x), preprocess_graph(ei, n, device="cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_load_flax_variables_rejects_unknown_and_missing_keys():
    x = _x(10, 4)
    variables = JaxTorchLinear(3).init(jax.random.PRNGKey(0), x)
    params = {k: np.asarray(v) for k, v in variables["params"].items()}
    with pytest.raises(KeyError, match="unknown"):
        load_flax_variables(TorchLinear(4, 3, generator=GEN),
                            {"params": {**params, "extra": np.zeros(3)}})
    with pytest.raises(KeyError, match="lack"):
        load_flax_variables(TorchLinear(4, 3, generator=GEN),
                            {"params": {"kernel": params["kernel"]}})
    with pytest.raises(ValueError, match="shape"):
        load_flax_variables(TorchLinear(4, 5, generator=GEN), {"params": params})


def test_dropout_identity_in_eval_and_seeded_in_train():
    x = torch.ones(2000)
    d = Dropout(0.25, generator=torch.Generator().manual_seed(1)).eval()
    assert torch.equal(d(x), x)
    d.train()
    y = d(x)
    assert set(torch.unique(y).tolist()) <= {0.0, torch.tensor(1.0 / 0.75).item()}
    assert abs((y != 0).float().mean().item() - 0.75) < 0.05
    y2 = Dropout(0.25, generator=torch.Generator().manual_seed(1)).train()(x)
    assert torch.equal(y, y2)


@pytest.mark.parametrize("kw", [
    dict(gnn="gcn"),
    dict(axis_name="nodes"),
    dict(attention_kernel="softmax"),
])
def test_unported_options_raise(kw):
    cfg = SGFormerConfig.large(8, 3, **kw)
    with pytest.raises(NotImplementedError):
        SGFormer(cfg, 4, device="cpu")


def test_config_has_every_field_of_the_jax_config():
    import dataclasses

    from sgformer_tpu.nn.sgformer import SGFormerConfig as JaxConfig

    names = [f.name for f in dataclasses.fields(SGFormerConfig)]
    assert names == [f.name for f in dataclasses.fields(JaxConfig)]
    for tier in ("medium", "large", "papers100m"):
        assert (dataclasses.asdict(getattr(SGFormerConfig, tier)(32, 4))
                == dataclasses.asdict(getattr(JaxConfig, tier)(32, 4)))
