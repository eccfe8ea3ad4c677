"""The port's training against the JAX package's, on the CPU: the whole
train step (loss, every parameter's gradient, BatchNorm statistics, Adam
with two weight decays), the optimizer alone, ``fit``'s schedule, the run
logger and the metrics; and, on the port alone, ``remat``, explicit dropout
generators, ``time_test`` and checkpoint resume.

The slice-level test builds a small JAX SGFormer (large tier, f32, dropout 0,
``attention_impl="pallas"`` in interpret mode) on an ``ssel`` slab graph
(interpret mode, ``chunk_dtype="f32"``), so the JAX step runs the Pallas
attention kernels forward and backward and the slab SpMM on A and A^T; the
port gets the same variables through ``load_flax_variables``. Only summation
order differs, hence 1e-5 (1e-4 relative over 5 Adam steps, which amplify
it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sgformer_tpu.data import metrics as jax_metrics
from sgformer_tpu.data.loaders import synthetic_dataset as jax_synthetic_dataset
from sgformer_tpu.graph import preprocess_graph as jax_preprocess_graph
from sgformer_tpu.nn import SGFormer as JaxSGFormer
from sgformer_tpu.nn import SGFormerConfig as JaxConfig
from sgformer_tpu.train import RunLogger as JaxRunLogger
from sgformer_tpu.train import TrainConfig as JaxTrainConfig
from sgformer_tpu.train import Trainer as JaxTrainer
from sgformer_tpu.train.optim import dual_weight_decay_adam as jax_dual_adam
from sgformer_tpu.train.trainer import bce_loss as jax_bce_loss
from sgformer_tpu.train.trainer import cross_entropy_loss as jax_ce_loss

from sgformer_tpu_torch import SGFormer, SGFormerConfig, load_flax_variables, preprocess_graph
from sgformer_tpu_torch.convert import _plan
from sgformer_tpu_torch.data import metrics
from sgformer_tpu_torch.nn import Dropout
from sgformer_tpu_torch.train import (
    RunLogger,
    TrainConfig,
    Trainer,
    bce_loss,
    cross_entropy_loss,
    dual_weight_decay_adam,
    load_checkpoint,
    save_checkpoint,
    time_test,
)

torch.set_num_threads(1)

N, F, C, HIDDEN = 256, 12, 4, 16
CFG = dict(gnn_num_layers=2, trans_dropout=0.0, gnn_dropout=0.0)


@pytest.fixture(scope="module")
def problem():
    ds = jax_synthetic_dataset(num_nodes=N, num_edges=1200, num_features=F,
                               num_classes=C, seed=5)
    split = ds.get_idx_split(rng=np.random.default_rng(0))
    return ds, split


def _port_trainer(ds, tc, device="cpu", **cfg_kw):
    cfg = SGFormerConfig.large(HIDDEN, C, **{**CFG, **cfg_kw})
    model = SGFormer(cfg, F, device=device)
    graph = preprocess_graph(ds.graph["edge_index"], N, device=device)
    return Trainer(model, graph, ds.graph["node_feat"], ds.label, tc, device=device)


@pytest.fixture(scope="module")
def jax_side(problem):
    ds, split = problem
    jg = jax_preprocess_graph(ds.graph["edge_index"], N, with_chunks=True,
                              spmm_mode="ssel", slab_rows=128, chunk_dtype="f32",
                              chunk_interpret=True)
    assert jg.node_perm is not None
    model = JaxSGFormer(JaxConfig.large(HIDDEN, C, attention_impl="pallas", **CFG))
    tc = JaxTrainConfig(lr=1e-2, trans_weight_decay=2e-3, gnn_weight_decay=5e-4)
    trainer = JaxTrainer(model, jg, ds.graph["node_feat"], ds.label, tc)
    state, tx, opt_state = trainer.init_state(jax.random.PRNGKey(0))
    # random BatchNorm statistics, so that no identity hides a mapping error
    rng = np.random.default_rng(6)
    bs = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32),
                      state["batch_stats"])
    state = {"params": state["params"], "batch_stats": bs}
    return trainer, state, tx, opt_state


def _port_with(ds, state, tc):
    trainer = _port_trainer(ds, tc)
    trainer.init_state(0)
    load_flax_variables(trainer.model, jax.tree.map(np.asarray, state))
    return trainer


def test_train_step_loss_grads_and_batch_stats_match_jax(problem, jax_side):
    ds, split = problem
    jtrainer, state, _, _ = jax_side
    train_idx = jtrainer._prepare_train_idx(split)
    (loss, new_bs), grads = jax.value_and_grad(jtrainer._make_loss_fn(), has_aux=True)(
        state["params"], state["batch_stats"], jax.random.PRNGKey(1), train_idx,
        jtrainer.x, jtrainer.graph)

    trainer = _port_with(ds, state, TrainConfig())
    got = trainer.loss(trainer.prepare_train_idx(split))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    flat_g = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_flatten_with_path(grads)[0]}
    flat_bs = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
               for path, v in jax.tree_util.tree_flatten_with_path(new_bs)[0]}
    # a bias that feeds a train-mode BatchNorm has an exact gradient of 0 (the
    # batch mean takes any shift out): both sides give rounding noise, held
    # to the scale of the gradient of the BatchNorm shift after it
    scale_of = {("graph_conv", "fc_in", "bias"): ("graph_conv", "bn_in", "bias")}
    scale_of.update({("graph_conv", f"conv_{i}", "W", "bias"): ("graph_conv", f"bn_{i}", "bias")
                     for i in range(CFG["gnn_num_layers"])})
    seen = 0
    for path, tensor, transpose in _plan(trainer.model):
        if path[0] == "params":
            want = flat_g[path[1:]]
            g = tensor.grad.numpy()
            scale = np.abs(flat_g[scale_of.get(path[1:], path[1:])]).max()
            np.testing.assert_allclose(g.T if transpose else g, want, rtol=1e-5,
                                       atol=1e-5 * scale, err_msg="/".join(path))
        else:
            np.testing.assert_allclose(tensor.numpy(), flat_bs[path[1:]], rtol=1e-5,
                                       atol=1e-6, err_msg="/".join(path))
        seen += 1
    assert seen == len(flat_g) + len(flat_bs)


def test_adam_steps_with_two_weight_decays_match_jax(problem, jax_side):
    ds, split = problem
    jtrainer, state, tx, opt_state = jax_side
    step, _ = jtrainer._build_steps(tx)
    train_idx = jtrainer._prepare_train_idx(split)
    jstate = jax.tree.map(jnp.array, state)
    want = []
    for i in range(5):
        jstate, opt_state, loss = step(jstate, opt_state, jax.random.PRNGKey(i), train_idx)
        want.append(float(loss))
    jc = jtrainer.config
    tc = TrainConfig(lr=jc.lr, trans_weight_decay=jc.trans_weight_decay,
                     gnn_weight_decay=jc.gnn_weight_decay)
    trainer = _port_with(ds, state, tc)
    got = trainer.multi_step(trainer.prepare_train_idx(split), 5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_dual_weight_decay_adam_matches_optax_on_fixed_gradients():
    cfg = SGFormerConfig.large(8, 3, gnn_num_layers=2)
    model = SGFormer(cfg, 5, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    tree = {}
    for name, p in model.named_parameters():
        node = tree
        *parents, leaf = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(p.detach().numpy())
    tx = jax_dual_adam(tree, 1e-2, 3e-3, 7e-4)
    opt_state = tx.init(tree)
    opt = dual_weight_decay_adam(model, 1e-2, 3e-3, 7e-4)
    rng = np.random.default_rng(0)
    for _ in range(6):
        grads = {n: rng.standard_normal(p.shape).astype(np.float32)
                 for n, p in model.named_parameters()}
        gtree = jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(grads[".".join(k.key for k in path)]), tree)
        updates, opt_state = tx.update(gtree, opt_state, tree)
        tree = optax.apply_updates(tree, updates)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
    flat = {".".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert sorted(flat) == sorted(names)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), flat[n], rtol=1e-6, atol=1e-6,
                                   err_msg=n)
    groups = {tuple(sorted(id(p) for p in g["params"])): g["weight_decay"]
              for g in opt.param_groups}
    trans = tuple(sorted(id(p) for n, p in model.named_parameters()
                         if n.startswith("trans_conv.")))
    assert groups[trans] == 3e-3 and sorted(groups.values()) == [7e-4, 3e-3]


@pytest.mark.parametrize("loss", ["nll", "bce"])
def test_losses_match_jax(loss):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((50, 6)).astype(np.float32) * 3
    labels = rng.integers(0, 6, 50)
    idx = np.array([0, 3, 3, 7, 20, 49])  # a repeated index counts once, as in JAX
    if loss == "nll":
        want = jax_ce_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(idx))
        got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                 torch.from_numpy(idx))
    else:
        onehot = np.eye(6, dtype=np.float32)[labels]
        want = jax_bce_loss(jnp.asarray(logits), jnp.asarray(onehot), jnp.asarray(idx))
        got = bce_loss(torch.from_numpy(logits), torch.from_numpy(onehot),
                       torch.from_numpy(idx))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_fit_schedule_and_patience_match_jax(problem):
    """eval_step > 1 runs the epochs between evaluations as one block; with
    a metric that never improves, patience stops both trainers after the
    same evaluation. A constant metric makes the schedule the only thing
    compared."""
    ds, split = problem
    const = lambda y_true, y_pred: 0.5  # noqa: E731
    for kw in (dict(epochs=11, eval_step=3), dict(epochs=30, eval_step=2, patience=3)):
        jt = JaxTrainer(JaxSGFormer(JaxConfig.large(HIDDEN, C, **CFG)),
                        jax_preprocess_graph(ds.graph["edge_index"], N),
                        ds.graph["node_feat"], ds.label,
                        JaxTrainConfig(lr=1e-2, **kw), eval_func=const)
        want = jt.fit([split]).results[0]
        pt = _port_trainer(ds, TrainConfig(lr=1e-2, **kw))
        pt.eval_func = const
        got = pt.fit([split]).results[0]
        assert len(got) == len(want)
        assert [r[:3] for r in got] == [r[:3] for r in want]
        assert all(np.isfinite(r[3]) for r in got)
    assert pt.final_state is not None and "fc.weight" in pt.final_state


def test_fit_learns_and_the_logger_selects(problem):
    ds, split = problem
    pt = _port_trainer(ds, TrainConfig(lr=1e-2, epochs=30, eval_step=5, runs=2),
                       trans_dropout=0.3, gnn_dropout=0.3)
    logger = pt.fit([split])
    assert all(len(r) == 6 for r in logger.results)
    assert logger.run_summary(0)["final_test"] > 0.5
    assert logger.results[0][-1][3] < logger.results[0][0][3]


@pytest.mark.parametrize("mode", ["max_acc", "min_loss"])
def test_run_logger_matches_jax(mode):
    rng = np.random.default_rng(2)
    port, ref = RunLogger(3, mode=mode), JaxRunLogger(3, mode=mode)
    for run in range(3):
        for _ in range(5):
            row = tuple(rng.random(4))
            port.add_result(run, row)
            ref.add_result(run, row)
    assert port.statistics() == ref.statistics()
    assert [port.run_summary(r) for r in range(3)] == [ref.run_summary(r) for r in range(3)]
    with pytest.raises(ValueError):
        port.add_result(3, (0, 0, 0, 0))


def test_metrics_match_jax_sklearn():
    rng = np.random.default_rng(3)
    for _ in range(5):
        # rounded scores: many ties
        logits = np.round(rng.standard_normal((300, 5)), 1)
        y = rng.integers(0, 5, (300, 1))
        assert metrics.eval_acc(y, logits) == jax_metrics.eval_acc(y, logits)
        np.testing.assert_allclose(metrics.eval_f1(y, logits),
                                   jax_metrics.eval_f1(y, logits), rtol=1e-12)
        assert metrics.count_correct(y, logits) == jax_metrics.count_correct(y, logits)
        y2 = rng.integers(0, 2, (300, 1))
        np.testing.assert_allclose(metrics.eval_rocauc(y2, logits[:, :2]),
                                   jax_metrics.eval_rocauc(y2, logits[:, :2]), rtol=1e-12)
        multi = rng.integers(0, 2, (300, 4)).astype(np.float64)
        multi[rng.random((300, 4)) < 0.1] = np.nan  # unlabeled entries are skipped
        scores = np.round(rng.standard_normal((300, 4)), 1)
        np.testing.assert_allclose(metrics.eval_rocauc(multi, scores),
                                   jax_metrics.eval_rocauc(multi, scores), rtol=1e-12)
        nan_y = y.astype(np.float64)
        nan_y[::7] = np.nan
        assert metrics.eval_acc(nan_y, logits) == jax_metrics.eval_acc(nan_y, logits)
    with pytest.raises(RuntimeError):
        metrics.eval_rocauc(np.zeros((10, 1)), rng.standard_normal((10, 2)))


def test_remat_gives_the_same_gradients(problem):
    ds, split = problem
    grads = {}
    for remat in (False, True):
        trainer = _port_trainer(ds, TrainConfig(), remat=remat, gnn_num_layers=3)
        trainer.init_state(4)
        trainer.loss(trainer.prepare_train_idx(split)).backward()
        grads[remat] = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
    assert trainer.model.graph_conv.remat and trainer.model.trans_conv.remat
    for name, g in grads[False].items():
        torch.testing.assert_close(grads[True][name], g, rtol=1e-6, atol=1e-7)


def test_dropout_draws_only_from_the_explicit_generator(problem):
    ds, split = problem
    model = SGFormer(SGFormerConfig.large(HIDDEN, C), F, device="cpu").train()
    graph = preprocess_graph(ds.graph["edge_index"], N, device="cpu")
    x = torch.from_numpy(ds.graph["node_feat"])
    with pytest.raises(RuntimeError, match="Generator"):
        model(x, graph)
    losses = []
    for _ in range(2):
        trainer = _port_trainer(ds, TrainConfig(seed=9), trans_dropout=0.5, gnn_dropout=0.5)
        trainer.init_state(0)
        before = torch.get_rng_state()
        losses.append(trainer.multi_step(trainer.prepare_train_idx(split), 3))
        assert torch.equal(torch.get_rng_state(), before)
    assert torch.equal(losses[0], losses[1])
    assert all(isinstance(m.generator, torch.Generator)
               for m in trainer.model.modules() if isinstance(m, Dropout))


def test_init_state_draws_the_parameters_a_new_model_would_get(problem):
    ds, split = problem
    trainer = _port_trainer(ds, TrainConfig())
    with pytest.raises(RuntimeError, match="init_state"):
        trainer.train_step(trainer.prepare_train_idx(split))
    trainer.init_state(0)
    trainer.multi_step(trainer.prepare_train_idx(split), 2)  # moves weights and BN stats
    trainer.init_state(7)
    fresh = SGFormer(trainer.model.config, F, generator=torch.Generator().manual_seed(7),
                     device="cpu")
    got, want = trainer.model.state_dict(), fresh.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert not any(s["step"] for s in trainer.optimizer.state.values())


def test_time_test_on_the_cpu(problem):
    ds, split = problem
    res = time_test(_port_trainer(ds, TrainConfig(lr=1e-2)), split, epochs=4, warmup=2)
    assert len(res.losses) == 6 and np.isfinite(res.losses).all()
    assert res.per_epoch_ms > 0 and res.forward_ms > 0 and res.edges_per_sec > 0
    assert res.peak_memory_mb is None and res.device == "cpu"


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_checkpoint_resume_continues_exactly(problem, tmp_path, dropout):
    """With dropout 0 the model and optimizer state suffice; with dropout
    the checkpoint also carries the dropout generator's state."""
    ds, split = problem
    tc = TrainConfig(lr=1e-2, trans_weight_decay=1e-3, gnn_weight_decay=1e-3)
    kw = dict(trans_dropout=dropout, gnn_dropout=dropout)
    whole = _port_trainer(ds, tc, **kw)
    whole.init_state(3)
    idx = whole.prepare_train_idx(split)
    want = whole.multi_step(idx, 6)

    first = _port_trainer(ds, tc, **kw)
    first.init_state(3)
    head = first.multi_step(idx, 3)
    path = str(tmp_path / "ckpt" / "step3.pt")
    gen = first.generator if dropout else None
    save_checkpoint(path, first.model, first.optimizer, 3, generator=gen)

    resumed = _port_trainer(ds, tc, **kw)
    resumed.init_state(11)  # other weights, fresh moments: all overwritten
    resumed.generator.manual_seed(12)
    gen = resumed.generator if dropout else None
    assert load_checkpoint(path, resumed.model, resumed.optimizer, gen) == 3
    tail = resumed.multi_step(idx, 3)
    assert torch.equal(torch.cat([head, tail]), want)


def test_train_config_has_every_field_of_the_jax_config():
    assert ([f.name for f in dataclasses.fields(TrainConfig)]
            == [f.name for f in dataclasses.fields(JaxTrainConfig)])
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JaxTrainConfig())
