"""The port's data-parallel x node-sharded mini-batch training
(``sgformer_tpu_torch.parallel.dp_batch``, ``DPBatchTrainer``) on the CPU, in
one gloo group of 4 ranks (dp = 2 x sp = 2) spawned once for the module
(``torch_dp_batch_ranks`` is the rank side, and imports no JAX), against the
JAX package's ``make_dp_sp_train_step`` and ``DPBatchTrainer`` on a
(2, 2) mesh of the virtual CPU devices, and against the port's one-device
model. All in f32.

- the 2-D grid: world rank r at (r // 2, r % 2), the row and column groups,
  an all-reduce over ``"sp"``, ``"dp"`` and ``("dp", "sp")``, ``comm.calls``
  keyed by axis, ``make_global_mesh(dp=3)`` refused, a second
  ``make_global_mesh`` returning the first's grid, ``"sp"`` not bound again
  to the whole group, a 1-D ``ShardedTrainer`` step's collectives
  unchanged;
- the dp step on ``test_dp_batch``'s graph, batches [0, 80) and [80, 160),
  dropout 0, from the same flax parameters (their biases drawn away from 0,
  so that the weight decay and not rounding noise steers Adam on the biases
  that feed a train-mode BatchNorm, whose exact gradient is 0): loss 1e-5,
  each gradient within 1e-5 of its scale (such a bias to its BatchNorm
  shift's), the BatchNorm statistics and the Adam-updated parameters 1e-5;
  the same step against the mean loss of both batches through the port's
  one-device model (loss 1e-5, ‖Δg‖/‖g‖ ≤ 1e-4); every rank's state after
  the step equal;
- ``fit`` against the JAX trainer from the same variables (lr 1e-3, two
  epochs with a remainder step, an eval each): final parameters 1e-4, the
  logged accuracies equal; the tail with an empty group (n = 241, B = 120)
  and the dataset smaller than B dp (n = 230) with the JAX tests' assertions
  and the final state against JAX's (1e-4); convergence with dropout;
- refusals: the PyG edges (``gnn="gcn"``) and GAT on the dp path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dp_batch_ranks as ranks
from test_dp_batch import _problem
from sgformer_tpu.data.loaders import synthetic_dataset as jax_synthetic_dataset
from sgformer_tpu.graph import add_self_loops, remove_self_loops, to_undirected
from sgformer_tpu.graph import preprocess_graph as jax_preprocess_graph
from sgformer_tpu.nn import SGFormer as JaxSGFormer
from sgformer_tpu.nn import SGFormerConfig as JaxConfig
from sgformer_tpu.parallel import make_mesh as jax_make_mesh
from sgformer_tpu.parallel.dp_batch import build_dp_sp_batch as jax_build_dp_sp_batch
from sgformer_tpu.parallel.dp_batch import make_dp_sp_train_step as jax_make_step
from sgformer_tpu.parallel.dp_trainer import DPBatchTrainer as JaxDPBatchTrainer
from sgformer_tpu.train import BatchTrainConfig as JaxBatchConfig
from sgformer_tpu.train.batch_trainer import build_subgraph_batch as jax_build_subgraph_batch
from sgformer_tpu.train.optim import dual_weight_decay_adam as jax_adam

from sgformer_tpu_torch import load_flax_variables
from sgformer_tpu_torch.nn import GAT
from sgformer_tpu_torch.parallel.launch import run_group
from sgformer_tpu_torch.train import BatchTrainConfig, build_subgraph_batch

torch.set_num_threads(1)

CFG = dict(hidden_channels=16, out_channels=4, gnn="graphconv", trans_dropout=0.0,
           gnn_dropout=0.0)
STEP_TRAIN = dict(lr=0.01, trans_weight_decay=1e-3, gnn_weight_decay=1e-3)
BATCHES = [np.arange(0, 80), np.arange(80, 160)]
# the fits each package runs, by name: (its graph, its train config)
FITS = {
    "fit": dict(lr=1e-3, epochs=2, eval_step=1, batch_size=50, display_step=-1),
    "tail": dict(lr=0.02, epochs=6, eval_step=5, batch_size=120, display_step=-1),
    "small": dict(lr=0.02, epochs=4, eval_step=3, batch_size=120, display_step=-1),
    "converge": dict(lr=0.02, epochs=10, eval_step=5, batch_size=60, display_step=-1),
}
WORLD = ranks.DP * ranks.SP


def _graph(num_nodes, num_edges, seed):
    ds = jax_synthetic_dataset(num_nodes=num_nodes, num_edges=num_edges, num_features=12,
                               num_classes=4, seed=seed)
    e = add_self_loops(remove_self_loops(to_undirected(ds.graph["edge_index"])), num_nodes)
    return dict(n=num_nodes, edges=np.asarray(e), x=np.asarray(ds.graph["node_feat"]),
                label=np.asarray(ds.label), split=ds.get_idx_split(rng=np.random.default_rng(0)))


def _variables(x, edges, n):
    """Flax variables of the unsharded model: its init on the first batch's
    subgraph, every bias and BatchNorm statistic then drawn at random."""
    rng = np.random.default_rng(2)
    model = JaxSGFormer(JaxConfig(**CFG))
    g0 = jax_build_subgraph_batch(edges, BATCHES[0], n, bucket=512)
    v = model.init(jax.random.PRNGKey(0), jnp.asarray(x[BATCHES[0]]), g0, train=False)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(-0.1, 0.1, np.shape(a)).astype(np.float32)
                         if path[-1].key == "bias" else np.asarray(a)), v["params"])
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32),
                         v["batch_stats"])
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def case():
    ds, e, n = _problem()
    step = dict(n=n, edges=np.asarray(e), x=np.asarray(ds.graph["node_feat"]),
                label=np.asarray(ds.label), split=ds.get_idx_split(rng=np.random.default_rng(0)),
                cfg=CFG, batches=BATCHES)
    step["variables"] = _variables(step["x"], step["edges"], n)
    out = {"step": step, "fits": FITS, "fit": dict(step)}
    out["tail"] = dict(_graph(241, 2000, 3), cfg=CFG, variables=step["variables"])
    out["small"] = dict(_graph(230, 1800, 7), cfg=CFG, variables=step["variables"])
    out["converge"] = dict(step, cfg=dict(CFG, hidden_channels=32, trans_dropout=0.1,
                                          gnn_dropout=0.1))
    del out["converge"]["variables"]
    return out


@pytest.fixture(scope="module")
def group(case, tmp_path_factory):
    """What each of the 4 ranks computed, in world-rank order."""
    d = tmp_path_factory.mktemp("dp_ranks")
    torch.save(case, str(d / "case.pt"))
    run_group(ranks.run_ranks, WORLD, str(d / "case.pt"), str(d), device="cpu")
    return [torch.load(str(d / f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]


# -- the JAX side -------------------------------------------------------------------


def _jax_mesh():
    return jax_make_mesh((ranks.DP, ranks.SP), ("dp", "sp"), devices=jax.devices()[:WORLD])


def _as_port(tree: dict) -> dict:
    """A flax tree of parameters and statistics as the port's state dict."""
    model = ranks.port_model(CFG, 12, None)
    load_flax_variables(model, jax.tree.map(np.asarray, tree))
    return {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def jax_step(case):
    """The JAX dp step on the step case: its loss, its gradients (a
    grad-only ``shard_map`` of the same loss), its statistics and Adam
    parameters after the step, as the port's names."""
    s = case["step"]
    mesh = _jax_mesh()
    model = JaxSGFormer(JaxConfig(**CFG, axis_name="sp"))
    graph, idx, nmask = jax_build_dp_sp_batch(s["edges"], BATCHES, s["n"], sp=ranks.SP,
                                              edge_cap=512)
    label_all = s["label"].reshape(-1).astype(np.int32)
    x, label, nm = jnp.asarray(s["x"][idx]), jnp.asarray(label_all[idx]), jnp.asarray(nmask)
    params = jax.tree.map(jnp.asarray, s["variables"]["params"])
    bs = jax.tree.map(jnp.asarray, s["variables"]["batch_stats"])

    def grad_core(p, bs, x, g, label, nmask):
        g = g.local()
        x, label, nmask = x.reshape(x.shape[-2:]), label.reshape(-1), nmask.reshape(-1)

        def lf(p):
            out, _ = model.apply({"params": p, "batch_stats": bs}, x, g, train=True,
                                 node_mask=nmask, rngs={"dropout": jax.random.PRNGKey(0)},
                                 mutable=["batch_stats"])
            per = -jnp.take_along_axis(jax.nn.log_softmax(out), label[:, None], axis=1)[:, 0]
            s_, c = jax.lax.psum((jnp.sum(per * nmask), jnp.sum(nmask)), ("dp", "sp"))
            return s_ / c

        return jax.lax.pmean(jax.grad(lf)(p), ("dp", "sp"))

    spec = P("dp", "sp")
    grads = jax.jit(jax.shard_map(grad_core, mesh=mesh,
                                  in_specs=(P(), P(), P("dp", "sp", None), spec, spec, spec),
                                  out_specs=P(), check_vma=False))(params, bs, x, graph, label,
                                                                   nm)
    tx = jax_adam(params, **STEP_TRAIN)
    step = jax_make_step(model, tx, mesh, donate=False)
    params1, bs1, _, loss = step(params, bs, tx.init(params), jax.random.PRNGKey(1), x, graph,
                                 label, nm, nm)
    zero_stats = jax.tree.map(np.zeros_like, s["variables"]["batch_stats"])
    return dict(loss=float(loss), grads=_as_port({"params": grads, "batch_stats": zero_stats}),
                state=_as_port({"params": params1, "batch_stats": bs1}))


def _pinned(model, variables):
    """``model`` whose ``init`` returns ``variables`` (the JAX trainer's init
    under ``shard_map`` then starts where the port does)."""
    object.__setattr__(model, "init", lambda *a, **k: variables)
    return model


@pytest.fixture(scope="module")
def jax_fits(case):
    out = {}
    for name in ("fit", "tail", "small"):
        c = case[name]
        model = _pinned(JaxSGFormer(JaxConfig(**CFG, axis_name="sp")),
                        jax.tree.map(jnp.asarray, c["variables"]))
        trainer = JaxDPBatchTrainer(model, c["edges"], c["x"], c["label"],
                                    JaxBatchConfig(**FITS[name], ladder_base=512),
                                    mesh=_jax_mesh())
        logger = trainer.fit([c["split"]])
        out[name] = dict(results=logger.results[0], state=_as_port(trainer.final_state))
    return out


def _scale_of(name: str) -> str:
    """The gradient a bias feeding a train-mode BatchNorm is held to the
    scale of: its BatchNorm's shift."""
    if name == "graph_conv.fc_in.bias":
        return "graph_conv.bn_in.bias"
    if name.startswith("graph_conv.conv_") and name.endswith(".W.bias"):
        return f"graph_conv.bn_{name.split('.')[1].split('_')[1]}.bias"
    return name


# -- the grid and its collectives ---------------------------------------------------


def test_global_mesh_lays_world_rank_r_at_r_div_sp(group):
    for r, res in enumerate(group):
        assert res["world_rank"] == r
        assert res["coords"] == divmod(r, ranks.SP) and res["shape"] == {"dp": 2, "sp": 2}
        d, s = divmod(r, ranks.SP)
        assert res["groups"]["sp"] == [d * ranks.SP + i for i in range(ranks.SP)]
        assert res["groups"]["dp"] == [i * ranks.SP + s for i in range(ranks.DP)]


@pytest.mark.parametrize("axis", ["sp", "dp", ("dp", "sp")], ids=str)
def test_all_reduce_sums_over_the_axis_group(group, axis):
    for r, res in enumerate(group):
        members = res["groups"][axis] if isinstance(axis, str) else range(WORLD)
        assert res["sums"][axis] == sum(m + 1 for m in members)


def test_calls_are_counted_by_axis(group):
    want = {("all_reduce", axis, "gloo", "cpu"): 1 for axis in ("sp", "dp", ("dp", "sp"))}
    for res in group:
        assert res["sum_calls"] == want
        # a step: the loss and the gradients over both axes, the statistics
        # over dp, the attention and BatchNorm sums over sp
        calls = res["step"]["calls"]
        assert {k[1] for k in calls} == {"sp", "dp", ("dp", "sp")}
        assert calls[("all_reduce", ("dp", "sp"), "gloo", "cpu")] == 3
        assert calls[("all_reduce", "dp", "gloo", "cpu")] == 1


def test_global_mesh_refuses_a_dp_that_does_not_divide_the_world(group):
    for res in group:
        assert "not divisible by dp=3" in res["dp3"]


def test_an_axis_is_not_bound_again_to_another_group(group):
    """``make_global_mesh`` of the same layout returns the grid it made;
    ``make_mesh("sp")`` (the whole group) raises once the grid's ``"sp"`` is
    bound to a row, and the row stays bound."""
    for r, res in enumerate(group):
        assert res["same_grid"]
        assert "'sp' is bound to the ranks" in res["rebind"]
        assert res["sp_group"] == res["groups"]["sp"]


def test_one_axis_sharded_step_issues_the_calls_it_did(group):
    """A 1-D group's step (SGFormer.large, one TransConv layer, two GraphConv
    layers, the all-gather): one all-reduce forward and one backward for the
    attention layer, each of the three BatchNorms and the loss, one for the
    gradients (11), and one all-gather and its reduce-scatter per GraphConv
    layer, all over the whole group (its axis named "nodes", since "sp" is
    the grid's)."""
    want = {("all_reduce", "nodes", "gloo", "cpu"): 11,
            ("all_gather_into_tensor", "nodes", "gloo", "cpu"): 2,
            ("reduce_scatter_tensor", "nodes", "gloo", "cpu"): 2}
    for res in group:
        assert res["one_axis_calls"] == want


# -- the dp step ------------------------------------------------------------------


def test_dp_sp_step_matches_jax(group, jax_step):
    got = group[0]["step"]
    np.testing.assert_allclose(got["loss"], jax_step["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["step_loss"], jax_step["loss"], rtol=1e-5)
    want = jax_step["grads"]
    assert set(got["grads"]) == {k for k in want if not k.endswith(("running_mean",
                                                                    "running_var"))}
    for name, g in got["grads"].items():
        scale = np.abs(want[_scale_of(name)]).max()
        np.testing.assert_allclose(g, want[name], rtol=1e-5, atol=1e-5 * scale, err_msg=name)
    for name, v in got["state"].items():
        np.testing.assert_allclose(v, jax_step["state"][name], rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_dp_sp_step_matches_the_one_device_mean(case, group):
    """The loss and gradients of the mean over both batches' train nodes,
    each batch through the port's one-device model on its subgraph."""
    s = case["step"]
    model = ranks.port_model(CFG, 12, None)
    load_flax_variables(model, s["variables"])
    model.train()
    total = 0.0
    for bidx in BATCHES:
        out = model(torch.from_numpy(s["x"][bidx]), build_subgraph_batch(s["edges"], bidx, s["n"]))
        lab = torch.from_numpy(s["label"].reshape(-1)[bidx]).long()
        total = total + torch.nn.functional.cross_entropy(out, lab, reduction="sum")
    loss = total / sum(len(b) for b in BATCHES)
    loss.backward()
    got = group[0]["step"]
    np.testing.assert_allclose(got["loss"], loss.item(), rtol=1e-5)
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    diff = np.sqrt(sum(np.sum((got["grads"][k] - g) ** 2) for k, g in grads.items()))
    norm = np.sqrt(sum(np.sum(g ** 2) for g in grads.values()))
    assert diff <= 1e-4 * norm, (diff, norm)


def test_every_rank_holds_the_same_state_after_a_step(group):
    for res in group[1:]:
        for name, v in res["step"]["state"].items():
            np.testing.assert_array_equal(v, group[0]["step"]["state"][name], err_msg=name)


# -- fit ----------------------------------------------------------------------------


def _check_fit(got: dict, want: dict):
    assert got["results"] == want["results"]
    for name, v in got["state"].items():
        np.testing.assert_allclose(v, want["state"][name], rtol=1e-4, atol=1e-4, err_msg=name)


def test_fit_matches_jax(group, jax_fits):
    """Two epochs of two full steps and a remainder step (240 nodes, B 50:
    groups of 20), an eval after each."""
    got = group[0]["fit"]
    assert got["steps"] == 3 and len(got["losses"]) == 6
    _check_fit(got, jax_fits["fit"])
    for res in group[1:]:
        assert res["fit"]["results"] == got["results"]


def test_tail_with_an_empty_group(group, jax_fits):
    """n = 241, B = 120, dp = 2: one full step, then a remainder step whose
    groups hold 1 and 0 real nodes (``test_dp_batch``'s assertions)."""
    got = group[0]["tail"]
    assert got["steps"] == 2
    for res in group:
        assert all(np.isfinite(v).all() for v in res["tail"]["state"].values())
        assert np.isfinite(res["tail"]["losses"]).all()
    assert max(r[2] for r in got["results"]) > 0.3 and got["results"][-1][1] > 0.0
    _check_fit(got, jax_fits["tail"])


def test_dataset_smaller_than_the_global_batch(group, jax_fits):
    """n = 230 < B dp = 240: one step a epoch, two short groups of 115."""
    got = group[0]["small"]
    assert got["steps"] == 1
    for res in group:
        assert all(np.isfinite(v).all() for v in res["small"]["state"].values())
    assert all(0.0 <= r[2] <= 1.0 for r in got["results"])
    _check_fit(got, jax_fits["small"])


def test_training_converges(group):
    """``test_dp_batch``'s end-to-end fit (hidden 32, dropout 0.1, lr 0.02,
    10 epochs, B 60): the test accuracy above 0.3, the loss falling."""
    got = group[0]["converge"]
    assert got["results"] and max(r[2] for r in got["results"]) > 0.3
    losses = got["losses"]
    assert np.isfinite(losses).all() and np.mean(losses[-2:]) < losses[0] * 0.8, losses


# -- refusals -----------------------------------------------------------------------


def test_pyg_edges_are_refused_on_the_dp_path(case, group):
    for res in group:
        assert "pyg" in res["gcn"].lower()
    s = case["step"]
    cfg = dict(CFG, gnn="gcn")
    v = JaxSGFormer(JaxConfig(**cfg)).init(
        jax.random.PRNGKey(0), jnp.asarray(s["x"]),
        jax_preprocess_graph(s["edges"], s["n"], with_pyg_norm=True), train=False)
    graph, idx, nmask = jax_build_dp_sp_batch(s["edges"], BATCHES, s["n"], sp=ranks.SP,
                                              edge_cap=512)
    nm = jnp.asarray(nmask)
    params = v["params"]
    tx = jax_adam(params, **STEP_TRAIN)
    step = jax_make_step(JaxSGFormer(JaxConfig(**cfg, axis_name="sp")), tx, _jax_mesh(),
                         donate=False)
    with pytest.raises(AssertionError, match="pyg"):
        step.lower(params, v["batch_stats"], tx.init(params),
                   jax.random.PRNGKey(1), jnp.asarray(s["x"][idx]), graph,
                   jnp.asarray(s["label"].reshape(-1)[idx].astype(np.int32)), nm, nm)


def test_gat_is_refused_on_the_dp_path():
    with pytest.raises(ValueError, match="axis_name"):
        GAT(12, 16, 4, axis_name="sp", device="cpu")
