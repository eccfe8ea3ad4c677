"""The port's random-partition mini-batch trainer against the JAX package's,
on the CPU: ``subgraph``, ``build_subgraph_batch`` (bitwise, on a power-law
graph with hub rows, full and tail batches, PyG edges too), ``fit`` with
full-graph and streaming eval and with the BCE loss, the one-batch step
against the full-graph step, an empty batch's Adam step, repeatability, and
the refusal of an eval it cannot run.

The JAX trainer runs as its own tests run it here (XLA; its tail and eval
batches padded to ``batch_size`` with a ``node_mask``); the port trains them
at their real size. Both start from the same flax variables
(``load_flax_variables``) and draw the same permutations from one numpy seed;
dropout is 0. Only summation order differs: per-batch losses within 1e-5
relative, final parameters within 1e-4, the logger's results within 1e-6.
The learning rate is 1e-3, the bench's: each Adam step moves every weight
by about lr, and the two packages' updates differ in the last bit of f32,
which moves the loss by ~1e-6 relative a step at lr 1e-2 (1.1e-5 after the
8 steps here), more than the loss bound leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgformer_tpu.data.loaders import synthetic_dataset as jax_synthetic_dataset
from sgformer_tpu.graph import add_self_loops as jax_add_self_loops
from sgformer_tpu.graph import preprocess_graph as jax_preprocess_graph
from sgformer_tpu.graph import remove_self_loops as jax_remove_self_loops
from sgformer_tpu.graph import subgraph as jax_subgraph
from sgformer_tpu.graph import to_undirected as jax_to_undirected
from sgformer_tpu.nn import SGFormer as JaxSGFormer
from sgformer_tpu.nn import SGFormerConfig as JaxConfig
from sgformer_tpu.train.batch_trainer import BatchTrainConfig as JaxBatchConfig
from sgformer_tpu.train.batch_trainer import BatchTrainer as JaxBatchTrainer
from sgformer_tpu.train.batch_trainer import build_subgraph_batch as jax_build

from sgformer_tpu_torch import SGFormer, SGFormerConfig, load_flax_variables, preprocess_graph
from sgformer_tpu_torch.graph import subgraph
from sgformer_tpu_torch.train import (BatchTrainConfig, BatchTrainer, TrainConfig, Trainer,
                                      build_subgraph_batch)

torch.set_num_threads(1)

N, F, C, HIDDEN, B = 1000, 12, 4, 32, 300
CFG = dict(gnn_num_layers=2, gnn_use_init=True, trans_dropout=0.0, gnn_dropout=0.0)
TRAIN = dict(lr=1e-3, trans_weight_decay=2e-3, gnn_weight_decay=5e-4, epochs=2, eval_step=1,
             batch_size=B, display_step=-1, seed=3)


def _edges(ei, n):
    """The CLI's batch-tier edge list: symmetrised, self-loops replaced."""
    return jax_add_self_loops(jax_remove_self_loops(jax_to_undirected(ei)), n)


@pytest.fixture(scope="module")
def problem():
    ds = jax_synthetic_dataset(num_nodes=N, num_edges=6000, num_features=F, num_classes=C,
                               seed=4)
    split = ds.get_idx_split(rng=np.random.default_rng(0))
    return ds, _edges(ds.graph["edge_index"], N), split


@pytest.fixture(scope="module")
def powerlaw():
    """A small power-law graph whose hub rows hold more in-edges than the
    hub segment length (128), in A and in A^T of a batch."""
    ds = jax_synthetic_dataset(num_nodes=2000, num_edges=30000, num_features=4,
                               num_classes=3, powerlaw=1.1, seed=0)
    e = _edges(ds.graph["edge_index"], 2000)
    assert np.bincount(e[1]).max() > 3 * 128
    return e


def _variables(ds, edges, classes=C, cfg=CFG):
    model = JaxSGFormer(JaxConfig.large(HIDDEN, classes, **cfg))
    g = jax_preprocess_graph(edges, N, undirected=False, self_loops=False)
    variables = jax.jit(lambda r, x, g: model.init({"params": r}, x, g, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(ds.graph["node_feat"]), g)
    # random BatchNorm statistics, so that no identity hides a mapping error
    rng = np.random.default_rng(6)
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32),
                         variables["batch_stats"])
    return model, {"params": variables["params"], "batch_stats": stats}


def _port_state(variables, classes=C, cfg=CFG):
    model = SGFormer(SGFormerConfig.large(HIDDEN, classes, **cfg), F, device="cpu")
    load_flax_variables(model, jax.tree.map(np.asarray, variables))
    return model, {k: v.clone() for k, v in model.state_dict().items()}


def test_subgraph_matches_jax(powerlaw):
    rng = np.random.default_rng(1)
    for size in (1, 700, 2000):
        idx = rng.permutation(2000)[:size]
        want, n_want = jax_subgraph(idx, powerlaw, 2000)
        for ei in (powerlaw, torch.from_numpy(powerlaw).int()):
            got, n_got = subgraph(torch.from_numpy(idx), ei, 2000)
            assert n_got == n_want and got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pyg", [False, True])
@pytest.mark.parametrize("which", ["full", "tail"])
def test_build_subgraph_batch_is_bitwise_jax(powerlaw, which, pyg):
    perm = np.random.default_rng(2).permutation(2000)
    bidx = perm[:1500] if which == "full" else perm[1500:]
    jg = jax_build(powerlaw, bidx, 2000, with_pyg_norm=pyg)
    g = build_subgraph_batch(torch.from_numpy(powerlaw), torch.from_numpy(bidx), 2000,
                             with_pyg_norm=pyg)
    e, b = g.num_edges, len(bidx)
    assert g.num_nodes == b and not g.symmetric
    # the JAX graph pads its edges up to a ladder bucket: compare the real ones
    for name, want in (("edge_src", jg.edge_src), ("edge_dst", jg.edge_dst),
                       ("gcn_weight", jg.gcn_weight)):
        got = getattr(g, name).numpy()
        np.testing.assert_array_equal(got, np.asarray(want)[:e], err_msg=name)
        assert got.dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(g.indptr.numpy()[:-1], np.asarray(jg.indptr)[:-1])
    assert int(g.indptr[-1]) == e
    if pyg:
        p = g.pyg_src.shape[0]
        for name in ("pyg_src", "pyg_dst", "pyg_weight"):
            np.testing.assert_array_equal(getattr(g, name).numpy(),
                                          np.asarray(getattr(jg, name))[:p], err_msg=name)
        assert g.pyg_t_indptr is not None and g.pyg_t_hub_segments is not None
    # the transposed CSR and the hub plans are the port's own: A^T's edges
    # stably sorted by source, and each plan every row of more than 128
    # edges cut into runs of 128 in row and edge order
    order = np.argsort(g.edge_src.numpy(), kind="stable")
    np.testing.assert_array_equal(g.t_perm.numpy(), order)
    np.testing.assert_array_equal(g.t_edge_src.numpy(), g.edge_dst.numpy()[order])
    np.testing.assert_array_equal(g.t_weight.numpy(), g.gcn_weight.numpy()[order])
    for plan, indptr in ((g.hub_segments, g.indptr), (g.t_hub_segments, g.t_indptr)):
        indptr = indptr.numpy()
        want = [(r, b, min(b + 128, indptr[r + 1])) for r in range(len(indptr) - 1)
                if indptr[r + 1] - indptr[r] > 128 for b in range(indptr[r], indptr[r + 1], 128)]
        np.testing.assert_array_equal(plan.numpy(), np.array(want, np.int32).reshape(-1, 3))
    if which == "full":
        assert g.hub_segments.shape[0] > 0 and g.t_hub_segments.shape[0] > 0


def test_edge_transforms_on_tensors_match_numpy(powerlaw):
    from sgformer_tpu_torch.graph import add_self_loops, remove_self_loops, to_undirected

    ei = np.random.default_rng(3).integers(0, 400, (2, 5000))
    want = _edges(ei, 400)
    for t in (torch.from_numpy(ei), torch.from_numpy(ei).int()):
        got = add_self_loops(remove_self_loops(to_undirected(t)), 400)
        assert got.dtype == t.dtype
        np.testing.assert_array_equal(got.numpy(), want)


def _jax_fit(ds, edges, split, variables, model, eval_mode, **kw):
    full = jax_preprocess_graph(ds.graph["edge_index"], N)
    tc = JaxBatchConfig(**{**TRAIN, **kw}, eval_mode=eval_mode, ladder_base=1024)
    trainer = JaxBatchTrainer(model, edges, ds.graph["node_feat"], ds.label, tc,
                              full_graph=full)
    trainer.record_losses = True
    logger = trainer.fit([split], np_rng=np.random.default_rng(11), init_variables=variables)
    return trainer, logger


def _port_fit(ds, edges, split, state, model, eval_mode, **kw):
    full = preprocess_graph(ds.graph["edge_index"], N, device="cpu")
    tc = BatchTrainConfig(**{**TRAIN, **kw}, eval_mode=eval_mode)
    trainer = BatchTrainer(model, edges, ds.graph["node_feat"], ds.label, tc, full_graph=full,
                           device="cpu")
    trainer.record_losses = True
    logger = trainer.fit([split], np_rng=np.random.default_rng(11), init_state=state)
    return trainer, logger


def _check_fit(jt, jl, pt, pl, classes=C, columns=4):
    """Losses, the logger's first ``columns`` columns and the final
    parameters of the two fits."""
    # 2 epochs of 4 batches (3 of 300 nodes and a tail of 100)
    assert len(pt.train_losses) == len(jt.train_losses) == 8
    np.testing.assert_allclose(pt.train_losses, jt.train_losses, rtol=1e-5)
    assert len(pl.results[0]) == len(jl.results[0]) == 2
    np.testing.assert_allclose(np.array(pl.results[0])[:, :columns],
                               np.array(jl.results[0])[:, :columns], rtol=1e-6, atol=1e-6)
    # the JAX trainer's final variables, loaded into a port model by name
    _, want = _port_state({"params": jt.final_state["params"],
                           "batch_stats": jt.final_state["batch_stats"]}, classes)
    assert pt.final_state.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(pt.final_state[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("eval_mode", ["full", "batch"])
def test_fit_matches_jax(problem, eval_mode):
    ds, edges, split = problem
    jmodel, variables = _variables(ds, edges)
    jt, jl = _jax_fit(ds, edges, split, variables, jmodel, eval_mode)
    model, state = _port_state(variables)
    pt, pl = _port_fit(ds, edges, split, state, model, eval_mode)
    _check_fit(jt, jl, pt, pl)
    assert pt.train_losses[-1] < pt.train_losses[0]


def _bce_valid_loss(trainer, split, onehot):
    """The valid BCE of the full-graph Trainer's ``evaluate``
    (train/trainer.py), written out, on the trainer's final full-graph
    logits."""
    vidx = np.asarray(split["valid"])
    z = np.clip(trainer.eval_logits_full()[vidx], -30, 30)
    lab = onehot[vidx]
    return float(np.mean(np.maximum(z, 0) - z * lab + np.log1p(np.exp(-np.abs(z)))))


def _bce_fit(problem, label, classes):
    """JAX and port fits with ``loss='bce'``, rocauc and full-graph eval on
    ``label`` in place of the problem's."""
    ds, edges, split = problem
    ds.label, kept = label, ds.label
    try:
        jmodel, variables = _variables(ds, edges, classes=classes)
        kw = dict(loss="bce", metric="rocauc")
        jt, jl = _jax_fit(ds, edges, split, variables, jmodel, "full", **kw)
        model, state = _port_state(variables, classes=classes)
        pt, pl = _port_fit(ds, edges, split, state, model, "full", **kw)
    finally:
        ds.label = kept
    return jt, jl, pt, pl


def test_fit_with_bce_and_rocauc_matches_jax(problem):
    """Binary labels: the losses, metrics and parameters as the JAX
    trainer's; the valid loss (column 3) is the BCE of the full-graph
    Trainer, where the JAX batch trainer takes an NLL."""
    binary = jax_synthetic_dataset(num_nodes=N, num_edges=6000, num_features=F, num_classes=2,
                                   seed=4)
    jt, jl, pt, pl = _bce_fit(problem, binary.label, 2)
    _check_fit(jt, jl, pt, pl, classes=2, columns=3)
    onehot = np.eye(2, dtype=np.float32)[binary.label.reshape(-1)]
    assert pl.results[0][-1][3] == pytest.approx(_bce_valid_loss(pt, problem[2], onehot),
                                                 rel=1e-6)


def test_fit_with_multilabel_bce_reports_the_bce_valid_loss(problem):
    """Three binary label columns (ogbn-proteins' form, in small): train
    losses, metrics (rocauc per column) and parameters as the JAX
    trainer's; the valid loss (column 3) is the full-graph Trainer's BCE
    over every column, not the NLL of the flattened labels."""
    label = (np.random.default_rng(12).random((N, 3)) < 0.4).astype(np.int64)
    jt, jl, pt, pl = _bce_fit(problem, label, 3)
    _check_fit(jt, jl, pt, pl, classes=3, columns=3)
    want = _bce_valid_loss(pt, problem[2], label.astype(np.float32))
    assert pl.results[0][-1][3] == pytest.approx(want, rel=1e-6)
    assert abs(jl.results[0][-1][3] - want) > 1e-3  # the JAX trainer's NLL


def test_batch_of_all_nodes_is_the_full_graph_step(problem):
    """One batch of every node in node order is the full-graph Trainer's
    step: the same loss and the same parameters after Adam."""
    ds, edges, split = problem
    _, variables = _variables(ds, edges)
    results = []
    for kind in ("batch", "full"):
        model, state = _port_state(variables)
        if kind == "batch":
            tc = BatchTrainConfig(**{**TRAIN, "batch_size": N})
            trainer = BatchTrainer(model, edges, ds.graph["node_feat"], ds.label, tc,
                                   device="cpu")
            trainer.init_state(0, state)
            train_set = torch.zeros(N, dtype=torch.bool)
            train_set[torch.from_numpy(split["train"])] = True
            loss = trainer.train_step(trainer.build_batch(torch.arange(N), train_set))
        else:
            tc = TrainConfig(**{k: v for k, v in TRAIN.items() if k != "batch_size"})
            graph = preprocess_graph(ds.graph["edge_index"], N, device="cpu")
            trainer = Trainer(model, graph, ds.graph["node_feat"], ds.label, tc, device="cpu")
            trainer.init_state(0)
            model.load_state_dict(state)
            loss = trainer.train_step(trainer.prepare_train_idx(split))
        results.append((loss.item(), {k: v.clone() for k, v in model.state_dict().items()}))
    (lb, sb), (lf, sf) = results
    np.testing.assert_allclose(lb, lf, rtol=1e-6)
    for k in sf:
        torch.testing.assert_close(sb[k], sf[k], rtol=1e-5, atol=1e-6, msg=k)


def test_batch_without_train_nodes_still_steps_adam(problem):
    ds, edges, split = problem
    _, variables = _variables(ds, edges)
    model, state = _port_state(variables)
    trainer = BatchTrainer(model, edges, ds.graph["node_feat"], ds.label,
                           BatchTrainConfig(**TRAIN), device="cpu")
    trainer.init_state(0, state)
    loss = trainer.train_step(trainer.build_batch(torch.arange(B)))  # no train mask
    assert loss.item() == 0.0
    assert all(s["step"] == 1 for s in trainer.optimizer.state.values())
    assert len(trainer.optimizer.state) == len(list(model.parameters()))
    # the weight decay alone moves every parameter that is not all zeros
    for name, p in model.named_parameters():
        assert torch.equal(p, state[name]) == (not state[name].any()), name


def test_two_fits_are_identical(problem):
    ds, edges, split = problem
    cfg = dict(CFG, trans_dropout=0.3, gnn_dropout=0.3)
    runs = []
    for _ in range(2):
        model = SGFormer(SGFormerConfig.large(HIDDEN, C, **cfg), F, device="cpu")
        trainer = BatchTrainer(model, edges, ds.graph["node_feat"], ds.label,
                               BatchTrainConfig(**TRAIN, eval_mode="batch"), device="cpu")
        trainer.record_losses = True
        runs.append((trainer.fit([split]).results[0], trainer.train_losses,
                     trainer.final_state))
    assert runs[0][0] == runs[1][0] and runs[0][1] == runs[1][1]
    assert all(torch.equal(runs[0][2][k], runs[1][2][k]) for k in runs[0][2])


@pytest.mark.parametrize("case", ["unknown eval_mode", "full eval without full_graph"])
def test_an_eval_it_cannot_run_is_refused(problem, case):
    ds, edges, split = problem
    model = SGFormer(SGFormerConfig.large(HIDDEN, C, **CFG), F, device="cpu")
    if case == "unknown eval_mode":
        with pytest.raises(ValueError, match="eval_mode"):
            BatchTrainer(model, edges, ds.graph["node_feat"], ds.label,
                         BatchTrainConfig(eval_mode="offload"), device="cpu")
        return
    trainer = BatchTrainer(model, edges, ds.graph["node_feat"], ds.label,
                           BatchTrainConfig(**TRAIN, eval_mode="full"), device="cpu")
    with pytest.raises(ValueError, match="full_graph"):
        trainer.fit([split])
