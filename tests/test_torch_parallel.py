"""The port's node-sharded training (``sgformer_tpu_torch.parallel``) on the
CPU, in gloo groups of 2 and 3 ranks spawned from the test (one group for
each size, every check of the group in one spawn: ``torch_parallel_ranks``),
against the JAX package's ``make_sharded_steps`` and ``ShardedTrainer`` on
the virtual CPU mesh of as many devices, and against the port's one-device
``Trainer``. N = 50 (not divisible by 3: the last shard has padding rows).

- a sharded step (graphconv and gcn, with the halo and without): the eval
  logits, the loss, every gradient and the BatchNorm statistics after the
  train-mode forward, against the JAX step on the same flax parameters (the
  JAX optimiser a pass-through that returns the gradients), f32: loss 1e-5,
  gradients 1e-5 of their scale (a bias feeding a train-mode BatchNorm, whose
  exact gradient is 0, to its BatchNorm shift's), logits 1e-5; against the
  port's one-device Trainer: loss 1e-5, ‖Δg‖/‖g‖ ≤ 1e-4 over all
  parameters, logits 1e-5 of the largest; eval logits bitwise repeatable;
- the baselines the sharded CLI builds (SGC, SGC2, SIGN, MixHop, GCNJK,
  APPNP, GPRGNN), with the halo and without, against the one-device
  ``Trainer`` at the same tolerances;
- the attention's all-reduce placement: ``fused_linear_attention(axis_name=)``
  (the kernel path: the reduce and apply, then the backward kernels, their
  plain versions on CPU tensors) and the plain ``linear_attention(axis_name=)``
  forward and backward against the one-device call, 1e-5;
- ``ShardedTrainer.fit``: five Adam steps at lr 1e-3, dropout 0, against the
  JAX ``ShardedTrainer`` from the same parameters; ``multi_step(k)`` is k
  ``train_step``s; a reordered graph gives the unreordered logits in the
  caller's order, and trains;
- the host partition: each shard's edges against JAX's ``_shard_edges``, the
  halo plans (send rows, H, the local and remote edge sets) bitwise JAX's
  ``_build_halo``;
- ``csr_spmm`` on a rectangular A, forward and gradient, on CPU tensors;
- GAT under ``axis_name`` refused in both packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import reference_numpy as ref
import torch_parallel_ranks as ranks
from sgformer_tpu.data.loaders import synthetic_dataset as jax_synthetic_dataset
from sgformer_tpu.graph import preprocess_graph as jax_preprocess_graph
from sgformer_tpu.nn import GAT as JaxGAT
from sgformer_tpu.nn import SGFormer as JaxSGFormer
from sgformer_tpu.nn import SGFormerConfig as JaxConfig
from sgformer_tpu.parallel import make_mesh as jax_make_mesh
from sgformer_tpu.parallel import partition_graph as jax_partition_graph
from sgformer_tpu.parallel.partition import _build_halo, _shard_edges
from sgformer_tpu.parallel.partition import idx_to_mask as jax_idx_to_mask
from sgformer_tpu.parallel.partition import node_mask_for as jax_node_mask_for
from sgformer_tpu.parallel.partition import pad_to_shards as jax_pad_to_shards
from sgformer_tpu.parallel.sharded import ShardedTrainer as JaxShardedTrainer
from sgformer_tpu.parallel.sharded import make_sharded_steps as jax_make_sharded_steps
from sgformer_tpu.train.trainer import TrainConfig as JaxTrainConfig

from sgformer_tpu_torch import load_flax_variables
from sgformer_tpu_torch.graph import preprocess_graph
from sgformer_tpu_torch.kernels.attention import fused_linear_attention
from sgformer_tpu_torch.kernels.spmm import csr_spmm, csr_spmm_autograd, hub_plan
from sgformer_tpu_torch.nn import GAT
from sgformer_tpu_torch.ops.attention import linear_attention
from sgformer_tpu_torch.ops.spmm import spmm
from sgformer_tpu_torch.parallel.launch import run_group
from sgformer_tpu_torch.parallel.partition import build_halo, shard_edges
from sgformer_tpu_torch.train import TrainConfig, Trainer

torch.set_num_threads(1)

N, F, C, HIDDEN = 50, 12, 4, 16
CFG = dict(trans_num_layers=1, gnn_num_layers=2, trans_dropout=0.0, gnn_dropout=0.0)
SIZES = (2, 3)


def _case():
    rng = np.random.default_rng(11)
    edge_index = ref.random_graph(rng, N, 300)
    x = rng.standard_normal((N, F)).astype(np.float32)
    label = rng.integers(0, C, N).reshape(-1, 1)
    perm = rng.permutation(N)
    splits = {"train": perm[:25], "valid": perm[25:38], "test": perm[38:]}
    jg = jax_preprocess_graph(edge_index, N, with_pyg_norm=True)
    variables = {}
    for gnn in ("graphconv", "gcn"):
        model = JaxSGFormer(JaxConfig.large(HIDDEN, C, gnn=gnn, **CFG))
        v = model.init(jax.random.PRNGKey(0), jnp.asarray(x), jg, train=False)
        # random BatchNorm statistics, so that no identity hides a mapping error
        stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32),
                             v["batch_stats"])
        variables[gnn] = {"params": jax.tree.map(np.asarray, v["params"]),
                          "batch_stats": stats}
    h, m = 2, 8
    attn = {key: rng.standard_normal((N, h, m)).astype(np.float32) for key in "qkvg"}
    learn = jax_synthetic_dataset(num_nodes=200, num_edges=1600, num_features=16, num_classes=4,
                                  seed=3)
    return dict(n=N, x=x, label=label, edge_index=edge_index, train_idx=np.arange(0, N, 2),
                splits=splits, variables=variables, hidden=HIDDEN, classes=C, cfg=CFG,
                attn=attn, learn=dict(n=learn.num_nodes, edge_index=np.asarray(
                    learn.graph["edge_index"]), x=np.asarray(learn.graph["node_feat"]),
                    label=np.asarray(learn.label), classes=4,
                    split=learn.get_idx_split(rng=np.random.default_rng(0))))


@pytest.fixture(scope="module")
def case():
    return _case()


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: f"S{s}")
def group(request, case, tmp_path_factory):
    """(S, what the ranks computed): one spawned gloo group of S ranks."""
    size = request.param
    d = tmp_path_factory.mktemp(f"ranks{size}")
    case_path, out_path = str(d / "case.pt"), str(d / "out.pt")
    torch.save(case, case_path)
    run_group(ranks.run_ranks, size, case_path, out_path, device="cpu")
    return size, torch.load(out_path, weights_only=False)


# -- the JAX side -------------------------------------------------------------------


def _pass_through():
    """An optax transform that leaves the parameters and keeps the
    gradients as its state: the JAX sharded step then returns them."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _jax_step(case, size, gnn, halo):
    n = case["n"]
    jg = jax_preprocess_graph(case["edge_index"], n, with_pyg_norm=True)
    mesh = jax_make_mesh((size,), ("sp",), devices=jax.devices()[:size])
    sg = jax_partition_graph(jg, size, "sp", with_halo=halo)
    model = JaxSGFormer(JaxConfig.large(HIDDEN, C, gnn=gnn, axis_name="sp", **CFG))
    tx = _pass_through()
    train_step, eval_step = jax_make_sharded_steps(model, tx, mesh, "sp", donate=False)
    v = case["variables"][gnn]
    x = jnp.asarray(jax_pad_to_shards(case["x"], sg.total_nodes))
    nm = jnp.asarray(jax_node_mask_for(n, sg.total_nodes))
    tm = jnp.asarray(jax_idx_to_mask(case["train_idx"], sg.total_nodes))
    lab = jnp.asarray(jax_pad_to_shards(case["label"].reshape(-1).astype(np.int32),
                                        sg.total_nodes))
    logits = np.asarray(eval_step(v["params"], v["batch_stats"], x, sg, nm))[:n]
    _, bs, grads, loss = train_step(v["params"], v["batch_stats"], tx.init(v["params"]),
                                    jax.random.PRNGKey(1), tm, x, sg, lab, nm)
    return logits, float(loss), jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, bs)


def _as_port(case, gnn, tree):
    """A flax tree of gradients and statistics in the port's names and
    layout (through ``load_flax_variables``)."""
    model = ranks.port_model(case, gnn)
    load_flax_variables(model, {"params": tree[0], "batch_stats": tree[1]})
    return ({k: p.detach().numpy() for k, p in model.named_parameters()},
            {k: b.numpy() for k, b in model.named_buffers()})


def _scale_of(name: str) -> str:
    """The gradient a bias feeding a train-mode BatchNorm is held to the
    scale of: its BatchNorm's shift."""
    if name == "graph_conv.fc_in.bias":
        return "graph_conv.bn_in.bias"
    if name.startswith("graph_conv.conv_") and name.endswith(".W.bias"):
        return f"graph_conv.bn_{name.split('.')[1].split('_')[1]}.bias"
    if name.startswith("gcn.conv_") and name.endswith(".bias") and "conv_1" not in name:
        return f"gcn.bn_{name.split('.')[1].split('_')[1]}.bias"
    return name


def _one_device(case, gnn):
    graph = preprocess_graph(case["edge_index"], case["n"], with_pyg_norm=True, device="cpu")
    tr = Trainer(ranks.port_model(case, gnn), graph, case["x"], case["label"],
                 TrainConfig(lr=1e-3), device="cpu")
    tr.init_state(0)
    load_flax_variables(tr.model, case["variables"][gnn])
    logits = tr.eval_step()
    loss = tr.loss(tr.prepare_train_idx({"train": case["train_idx"]}))
    loss.backward()
    return (logits.numpy(), float(loss),
            {k: p.grad.numpy() for k, p in tr.model.named_parameters()})


# -- the sharded step ---------------------------------------------------------------


@pytest.mark.parametrize("gnn,halo", ranks.STEP_CASES, ids=lambda v: str(v))
def test_sharded_step_matches_jax(case, group, gnn, halo):
    size, res = group
    got = res[("step", gnn, halo)]
    logits, loss, grads, stats = _jax_step(case, size, gnn, halo)
    np.testing.assert_allclose(got["logits"], logits, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    want_g, want_b = _as_port(case, gnn, (grads, stats))
    assert set(got["grads"]) == set(want_g)
    for name, g in got["grads"].items():
        scale = np.abs(want_g[_scale_of(name)]).max()
        np.testing.assert_allclose(g, want_g[name], rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=name)
    for name, b in got["buffers"].items():
        np.testing.assert_allclose(b, want_b[name], rtol=1e-5, atol=1e-6, err_msg=name)
    assert got["repeat"]


@pytest.mark.parametrize("gnn,halo", ranks.STEP_CASES, ids=lambda v: str(v))
def test_sharded_step_matches_one_device_trainer(case, group, gnn, halo):
    _, res = group
    got = res[("step", gnn, halo)]
    logits, loss, grads = _one_device(case, gnn)
    np.testing.assert_allclose(got["logits"], logits, rtol=0, atol=1e-5 * np.abs(logits).max())
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    diff = np.sqrt(sum(np.sum((got["grads"][k] - g) ** 2) for k, g in grads.items()))
    norm = np.sqrt(sum(np.sum(g ** 2) for g in grads.values()))
    assert diff <= 1e-4 * norm, (diff, norm)


@pytest.mark.parametrize("method,halo", ranks.BASELINE_CASES, ids=lambda v: str(v))
def test_sharded_baseline_step_matches_one_device_trainer(case, group, method, halo):
    """The baselines the sharded CLI builds: their propagations through the
    shard graph (the PyG edges for gcnjk, which the halo leaves to the
    all-gather) and their BatchNorm over the axis, at the tolerances of the
    SGFormer step above."""
    _, res = group
    got = res[("baseline", method, halo)]
    want = ranks.baseline_step(case, method)
    logits = want["logits"]
    np.testing.assert_allclose(got["logits"], logits, rtol=0, atol=1e-5 * np.abs(logits).max())
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert set(got["grads"]) == set(want["grads"])
    diff = np.sqrt(sum(np.sum((got["grads"][k] - g) ** 2) for k, g in want["grads"].items()))
    norm = np.sqrt(sum(np.sum(g ** 2) for g in want["grads"].values()))
    assert diff <= 1e-4 * norm, (diff, norm)


@pytest.mark.parametrize("path", ["kernel", "plain"])
def test_attention_all_reduce_matches_one_device(case, group, path):
    _, res = group
    ts = [torch.from_numpy(case["attn"][k]).requires_grad_(k != "g") for k in "qkvg"]
    q, k, v, g = ts
    fn = fused_linear_attention if path == "kernel" else linear_attention
    out = fn(q, k, v)
    out.backward(g)
    for got, want in zip(res["attention"][path], (out, q.grad, k.grad, v.grad)):
        want = want.detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_fit_matches_jax_sharded_trainer(case, group):
    size, res = group
    jg = jax_preprocess_graph(case["edge_index"], case["n"], with_pyg_norm=True)
    model = JaxSGFormer(JaxConfig.large(HIDDEN, C, gnn="graphconv", axis_name="sp", **CFG))
    tc = JaxTrainConfig(lr=1e-3, epochs=5, eval_step=1, display_step=-1,
                        trans_weight_decay=1e-3, gnn_weight_decay=5e-4)
    trainer = JaxShardedTrainer(model, jg, case["x"], case["label"], tc,
                                mesh=jax_make_mesh((size,), ("sp",),
                                                   devices=jax.devices()[:size]))
    init = trainer.init_state
    v = case["variables"]["graphconv"]

    def init_state(rng):
        _, tx, _ = init(rng)
        params = jax.tree.map(jnp.asarray, v["params"])
        return {"params": params, "batch_stats": v["batch_stats"]}, tx, tx.init(params)

    trainer.init_state = init_state
    want = np.array(trainer.fit([case["splits"]]).results[0])
    got = np.array(res["fit"])
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=1e-5)


def test_multi_step_is_k_train_steps(group):
    _, res = group
    r = res["multi_step"]
    np.testing.assert_array_equal(r["blocked"], r["single"])
    assert r["same_state"] and r["single"][-1] < r["single"][0]


def test_reordered_graph_gives_the_callers_order_and_trains(group):
    _, res = group
    plain = res[("step", "graphconv", False)]["logits"]
    for halo in (False, True):
        got = res[("reorder", halo)]["logits"]
        np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5 * np.abs(plain).max())
    assert res["reorder_learns"] > 0.5


# -- the host partition ---------------------------------------------------------


@pytest.mark.parametrize("size", SIZES)
def test_shard_edges_and_halo_plans_are_jaxs(size):
    ds = jax_synthetic_dataset(num_nodes=301, num_edges=2400, num_features=4, num_classes=3,
                               seed=2)
    jg = jax_preprocess_graph(ds.graph["edge_index"], 301, with_pyg_norm=True)
    g = preprocess_graph(ds.graph["edge_index"], 301, with_pyg_norm=True, device="cpu")
    block = -(-301 // size)
    for kind in ("gcn", "pyg"):
        if kind == "gcn":
            arrays = (g.edge_src, g.edge_dst, g.gcn_weight, g.indptr)
            jarrays = (jg.edge_src, jg.edge_dst, jg.gcn_weight, jg.indptr)
        else:
            arrays = (g.pyg_src, g.pyg_dst, g.pyg_weight, g.pyg_indptr)
            p_indptr = np.zeros(302, np.int64)
            np.cumsum(np.bincount(np.asarray(jg.pyg_dst), minlength=301), out=p_indptr[1:])
            jarrays = (jg.pyg_src, jg.pyg_dst, jg.pyg_weight, p_indptr)
        got = shard_edges(*(a.numpy() for a in arrays), size, block, 301)
        want = _shard_edges(*(np.asarray(a) for a in jarrays), size, block, 301)
        for s, (src, dst, w) in enumerate(got):
            for a, b in zip((src, dst, w), want):
                np.testing.assert_array_equal(a, b[s, :len(src)])
            assert not np.any(want[2][s, len(src):])
        if kind == "gcn":
            shards = got
    send, H, local, remote = build_halo(shards, block, size)
    j_send, j_local, j_remote, j_h = _build_halo(*want, block, size)
    assert H == j_h
    for i in range(size):
        for j in range(size):
            if i != j:
                np.testing.assert_array_equal(send[i][j], j_send[i, j, :len(send[i][j])])
                assert not np.any(j_send[i, j, len(send[i][j]):])
        for sets, jsets in ((local, j_local), (remote, j_remote)):
            for a, b in zip(sets[i], jsets):
                np.testing.assert_array_equal(a, b[i, :len(a)])
            assert not np.any(jsets[2][i, len(sets[i][0]):])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_csr_spmm_takes_a_rectangular_a(dtype):
    rng = np.random.default_rng(4)
    rows, cols, f = 7, 19, 5
    dst = np.sort(rng.integers(0, rows, 60))
    dst[:20] = 3  # a hub row
    dst = np.sort(dst)
    src = rng.integers(0, cols, 60)
    w = rng.standard_normal(60).astype(np.float32)
    t = lambda a, dt=torch.int32: torch.from_numpy(np.ascontiguousarray(a)).to(dt)
    indptr = torch.zeros(rows + 1, dtype=torch.int64)
    torch.cumsum(torch.bincount(t(dst, torch.int64), minlength=rows), 0, out=indptr[1:])
    indptr = indptr.int()
    order = np.argsort(src, kind="stable")
    t_indptr = torch.zeros(cols + 1, dtype=torch.int64)
    torch.cumsum(torch.bincount(t(src, torch.int64), minlength=cols), 0, out=t_indptr[1:])
    csr = (indptr, t(src), t(dst), t(w, torch.float32))
    csr_t = (t_indptr.int(), t(dst[order]), t(src[order]), t(w[order], torch.float32))
    x = torch.from_numpy(rng.standard_normal((cols, f)).astype(np.float32)).to(dtype)
    out = csr_spmm(x, *csr, hub_plan(indptr, 4), 4, cols)
    assert out.shape == (rows, f) and out.dtype == dtype
    want = np.zeros((rows, f))
    np.add.at(want, dst, w[:, None] * x.double().numpy()[src])
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(out.double().numpy(), want, rtol=tol, atol=tol * np.abs(want).max())
    xg = x.clone().requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((rows, f)).astype(np.float32)).to(dtype)
    csr_spmm_autograd(xg, csr, csr_t).backward(g)
    assert xg.grad.shape == (cols, f)
    want_dx = np.zeros((cols, f))
    np.add.at(want_dx, src, w[:, None] * g.double().numpy()[dst])
    np.testing.assert_allclose(xg.grad.double().numpy(), want_dx, rtol=tol,
                               atol=tol * np.abs(want_dx).max())
    # a square call keeps its bits
    sq = torch.from_numpy(rng.standard_normal((rows, f)).astype(np.float32)).to(dtype)
    keep = src < rows
    csr_sq = (indptr.new_tensor(np.concatenate([[0], np.cumsum(np.bincount(dst[keep],
                                                                          minlength=rows))])),
              t(src[keep]), t(dst[keep]), t(w[keep], torch.float32))
    assert torch.equal(csr_spmm(sq, *csr_sq), spmm(sq, csr_sq[1], csr_sq[2], csr_sq[3], rows))


def test_gat_refuses_axis_name_in_both_packages():
    with pytest.raises(ValueError, match="node-sharded"):
        GAT(4, 8, 3, axis_name="sp", device="cpu")
    # the JAX GAT under a mesh axis fails on the shard graph, which has no
    # per-edge-value aggregation
    ds = jax_synthetic_dataset(num_nodes=40, num_edges=200, num_features=4, num_classes=3,
                               seed=1)
    jg = jax_preprocess_graph(ds.graph["edge_index"], 40)
    mesh = jax_make_mesh((2,), ("sp",), devices=jax.devices()[:2])
    sg = jax_partition_graph(jg, 2, "sp")
    model = JaxGAT(8, 3, axis_name="sp")
    x = jnp.asarray(jax_pad_to_shards(np.asarray(ds.graph["node_feat"]), sg.total_nodes))
    fn = jax.shard_map(lambda xx, gg: model.init(jax.random.PRNGKey(0), xx, gg.local(),
                                                 train=False),
                       mesh=mesh, in_specs=(P("sp", None), P("sp")), out_specs=P(),
                       check_vma=False)
    with pytest.raises(AttributeError, match="ShardGraph"):
        jax.jit(fn)(x, sg)
    assert os.path.basename(ranks.__file__) == "torch_parallel_ranks.py"

