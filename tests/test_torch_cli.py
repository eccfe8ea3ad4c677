"""The port's CLI against the JAX package's, on the CPU (``--device cpu``).

- ``build``'s parts against what the JAX CLI builds from the same flags (its
  trainer caught before ``fit``): the splits, the trainer's config, the
  model's config, and the edges after the CLI's transforms for each trainer
  (the full graph's CSR and weights, the batch and sampled trainers' edge
  list), bitwise;
- the flag mapping: the TPU layout flags ignored with one note, GAT's
  message type (f32, as the JAX CLI's GAT computes it), the int8 flags;
- the slice as a whole: the full trainer on ``synth-n300-e2400-f16-c4``
  with dropout 0 and the JAX trainer's parameters carried across by
  ``load_flax_variables``: the eval logits within 1e-5 of the largest and
  the first step's loss within 1e-5 (f32, summation order only);
- the zoo and the attention ablations: ``build`` for every ``--method`` and
  ``--attention`` the JAX CLI has beyond the baselines, against its model
  (NodeFormer's adjacencies and Graphormer's inputs bitwise, the eval
  logits with the JAX parameters carried across within 1e-5 of the
  largest), and a short run of each through ``main``;
- ``tests/test_cli.py``'s runs through the port's CLI, ``--trainer sharded``
  (with and without ``--use_halo``) in one process against ``--trainer
  full``, and the refusals: the methods the sharded trainer cannot run, and
  no card without ``--device cpu``.
"""

import argparse
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from sgformer_tpu.cli import main as jax_cli
from sgformer_tpu.train import BatchTrainer as JaxBatchTrainer
from sgformer_tpu.train import SampledTrainer as JaxSampledTrainer
from sgformer_tpu.train import Trainer as JaxTrainer

from sgformer_tpu_torch import load_flax_variables
from sgformer_tpu_torch.cli import main as cli
from sgformer_tpu_torch.cli.parse import parser_add_main_args

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
SYNTH = "synth-n300-e2400-f16-c4"


def _args(argv):
    return parser_add_main_args(argparse.ArgumentParser()).parse_args(argv)


class _Caught(Exception):
    pass


def _jax_trainer(monkeypatch, argv):
    """The trainer the JAX CLI builds from ``argv``, caught at ``fit``."""
    def catch(self, splits, *a, **k):
        raise _Caught(self, splits)

    for cls in (JaxTrainer, JaxBatchTrainer, JaxSampledTrainer):
        monkeypatch.setattr(cls, "fit", catch)
    with pytest.raises(_Caught) as caught:
        jax_cli.main(argv)
    return caught.value.args


def _eq(got, want, what):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=what)
    assert got.shape == want.shape, what


def _same_graph(g, jg, pyg: bool):
    for name in ("edge_src", "edge_dst", "gcn_weight", "indptr"):
        _eq(getattr(g, name), getattr(jg, name), name)
    assert g.num_nodes == jg.num_nodes and g.num_edges == jg.num_edges
    if pyg:
        for name in ("pyg_src", "pyg_dst", "pyg_weight"):
            _eq(getattr(g, name), getattr(jg, name), name)
    else:
        assert g.pyg_src is None and jg.pyg_src is None


BUILDS = {
    "full-sgformer-gcn": ["--trainer", "full", "--rand_split"],
    "full-sgformer-graphconv-bf16": ["--trainer", "full", "--backbone", "graphconv",
                                     "--compute_dtype", "bf16", "--runs", "2"],
    "full-gcn-class-split": ["--trainer", "full", "--method", "gcn", "--rand_split_class",
                             "--label_num_per_class", "10", "--valid_num", "40",
                             "--test_num", "80"],
    "full-directed-no-undirected": ["--trainer", "full", "--method", "appnp",
                                    "--no_undirected", "--rand_split"],
    "batch-sgformer-graphconv": ["--trainer", "batch", "--backbone", "graphconv",
                                 "--batch_size", "100", "--rand_split"],
    "batch-gcnjk": ["--trainer", "batch", "--method", "gcnjk", "--batch_size", "120",
                    "--rand_split"],
    "sampled-sgformer": ["--trainer", "sampled", "--backbone", "graphconv", "--batch_size",
                         "64", "--fanouts", "5", "3", "--rand_split"],
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_build_matches_the_jax_cli(monkeypatch, name):
    argv = ["--dataset", SYNTH, "--epochs", "2", "--seed", "7"] + BUILDS[name]
    jtrainer, jsplits = _jax_trainer(monkeypatch, argv)
    built = cli.build(_args(argv + CPU))
    trainer = built.trainer

    # the splits
    assert len(built.splits) == len(jsplits)
    for split, jsplit in zip(built.splits, jsplits):
        assert set(split) == set(jsplit)
        for k in split:
            _eq(split[k], jsplit[k], k)
    # the trainer's config: every field both have
    cfg, jcfg = dataclasses.asdict(trainer.config), dataclasses.asdict(jtrainer.config)
    shared = set(cfg) & set(jcfg)
    assert {"lr", "epochs", "eval_step", "metric", "loss", "trans_weight_decay",
            "gnn_weight_decay", "seed", "runs"} <= shared
    assert {k: cfg[k] for k in shared} == {k: jcfg[k] for k in shared}
    # the model's config
    if hasattr(jtrainer.model, "config"):
        mcfg = dataclasses.asdict(built.model.config)
        jmcfg = dataclasses.asdict(jtrainer.model.config)
        assert {k: mcfg[k] for k in jmcfg} == jmcfg
    else:
        assert type(built.model).__name__ == type(jtrainer.model).__name__
    # the node features and labels
    x = trainer.x if isinstance(trainer.x, torch.Tensor) else torch.as_tensor(trainer.x)
    _eq(x, jtrainer.x, "x")
    # the edges after the CLI's transforms
    pyg = "gcn" in name
    if name.startswith("full"):
        assert built.edges is None
        _same_graph(built.graph, jtrainer.graph, pyg)
        assert built.graph.chunk_dtype == "f32" and built.graph.slab_dtype == "compute"
    elif name.startswith("batch"):
        _eq(built.edges, jtrainer.edge_index, "batch edge list")
        _eq(trainer.edge_index, jtrainer.edge_index, "the trainer's edge list")
        _same_graph(built.graph, jtrainer.full_graph, pyg)
        assert trainer.with_pyg_norm == jtrainer.with_pyg_norm == pyg
    else:
        assert built.graph is None
        _eq(built.edges, jtrainer.edge_index, "sampled edge list")
        _eq(trainer.sampler.csr.indptr, jtrainer.sampler.csr.indptr, "csr indptr")
        _eq(trainer.sampler.csr.indices, jtrainer.sampler.csr.indices, "csr indices")


def test_h2gcn_build_matches_the_jax_cli(monkeypatch):
    argv = ["--dataset", "synth-n150-e1000-f12-c3", "--method", "h2gcn", "--epochs", "2",
            "--rand_split", "--hidden_channels", "16"]
    jtrainer, _ = _jax_trainer(monkeypatch, argv)
    built = cli.build(_args(argv + CPU))
    for g, jg in zip(built.trainer.model_kwargs["h2_graphs"],
                     jtrainer.model_kwargs["h2_graphs"]):
        _same_graph(g, jg, pyg=False)


# -- the flag mapping -----------------------------------------------------------


def test_tpu_layout_flags_are_ignored_with_one_note(capsys):
    argv = ["--dataset", "synth-n120-e600-f8-c3", "--epochs", "1", "--rand_split",
            "--use_pallas", "--spmm_mode", "ssel", "--hub_rows", "-1",
            "--attention_impl", "pallas", "--slab_dtype", "auto"] + CPU
    plain = cli.build(_args(["--dataset", "synth-n120-e600-f8-c3", "--epochs", "1",
                             "--rand_split"] + CPU))
    assert capsys.readouterr().err == ""
    built = cli.build(_args(argv))
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "ignored" in err
    for flag in ("--use_pallas", "--spmm_mode ssel", "--hub_rows -1",
                 "--attention_impl pallas", "--slab_dtype auto"):
        assert flag in err
    # the same graph and the same model as without the flags
    for name in ("edge_src", "edge_dst", "gcn_weight", "pyg_weight"):
        assert torch.equal(getattr(built.graph, name), getattr(plain.graph, name))
    assert built.graph.slab_dtype == "compute" and built.graph.chunk_dtype == "f32"
    assert dataclasses.replace(built.model.config, attention_impl="auto") == plain.model.config


@pytest.mark.parametrize("flags", [["--use_pallas"], ["--use_pallas", "--chunk_dtype", "bf16"],
                                   ["--chunk_dtype", "f32"], []])
def test_gat_messages_stay_f32_as_the_jax_cli_computes_them(monkeypatch, flags):
    """The JAX CLI builds chunk plans without ``chunk_perm``, so its GATConv
    never reads the chunk type: its messages are f32 on every run. The
    port's graph says f32 too."""
    argv = ["--dataset", "synth-n120-e600-f8-c3", "--method", "gat", "--epochs", "1",
            "--rand_split", "--hidden_channels", "8"] + flags
    jtrainer, _ = _jax_trainer(monkeypatch, argv)
    chunks = jtrainer.graph.chunks
    assert chunks is None or chunks.fwd.edge_perm is None
    assert cli.build(_args(argv + CPU)).graph.chunk_dtype == "f32"


@pytest.mark.parametrize("flags", [["--slab_int8"], ["--slab_dtype", "int8"],
                                   ["--slab_dtype", "int8", "--use_pallas", "--spmm_mode",
                                    "ssel"]])
def test_int8_flags_give_the_int8_aggregation(flags):
    base = ["--dataset", "synth-n120-e600-f8-c3", "--epochs", "1", "--rand_split",
            "--backbone", "graphconv"] + CPU
    graph = cli.build(_args(base + flags)).graph
    assert graph.slab_dtype == "int8" and graph.chunk_dtype == "bf16" and graph.rs is not None
    bf16 = cli.build(_args(base + ["--slab_dtype", "bf16"])).graph
    assert bf16.slab_dtype == "compute" and bf16.chunk_dtype == "f32"


# -- the slice as a whole ---------------------------------------------------------


@pytest.mark.parametrize("backbone", ["gcn", "graphconv"])
def test_full_trainer_logits_and_first_loss_match_jax(monkeypatch, backbone):
    argv = ["--dataset", SYNTH, "--method", "sgformer", "--backbone", backbone,
            "--trainer", "full", "--epochs", "2", "--rand_split", "--hidden_channels", "32",
            "--dropout", "0", "--trans_dropout", "0", "--gnn_dropout", "0"]
    jtrainer, jsplits = _jax_trainer(monkeypatch, argv)
    state, _, _ = jtrainer.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)  # BatchNorm statistics away from (0, 1)
    bs = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32),
                      state["batch_stats"])
    variables = {"params": state["params"], "batch_stats": bs}
    want = np.asarray(jtrainer.model.apply(variables, jtrainer.x, jtrainer.graph, train=False))
    train_idx = jtrainer._prepare_train_idx(jsplits[0])
    jloss, _ = jtrainer._make_loss_fn()(state["params"], bs, jax.random.PRNGKey(1), train_idx,
                                        jtrainer.x, jtrainer.graph)

    built = cli.build(_args(argv + CPU))
    trainer = built.trainer
    trainer.init_state(0)
    load_flax_variables(trainer.model, jax.tree.map(np.asarray, variables))
    got = trainer.eval_step().numpy()
    assert got.shape == want.shape == (300, 4)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    loss = trainer.loss(trainer.prepare_train_idx(built.splits[0])).item()
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)


# -- the zoo and the attention ablations ------------------------------------------

ZOO = {
    "difformer": ["--method", "difformer"],
    "nodeformer": ["--method", "nodeformer"],
    "graphtrans": ["--method", "graphtrans"],
    "graphgps": ["--method", "graphgps"],
    "graphormer": ["--method", "graphormer"],
    "softmax": ["--attention", "softmax"],
    "gat": ["--attention", "gat"],
    "performer": ["--attention", "performer"],
}


def _pin_jax_draws(model, hidden):
    """The port's fixed projections set to the JAX draws: NodeFormer's eval
    projection (the first half of PRNGKey(0)) and the performer ablation's
    (PRNGKey(0))."""
    from sgformer_tpu.ops.attention_variants import create_projection_matrix

    from sgformer_tpu_torch.nn.nodeformer import NodeFormerConv
    from sgformer_tpu_torch.nn.transconv import TransConvLayer

    for mod in model.modules():
        if isinstance(mod, NodeFormerConv):
            key = jax.random.split(jax.random.PRNGKey(0))[0]
            mod.eval_projection.copy_(torch.from_numpy(np.asarray(
                create_projection_matrix(mod.nb_random_features, hidden, key))))
        elif isinstance(mod, TransConvLayer) and mod.kernel == "performer":
            mod.projection.copy_(torch.from_numpy(np.asarray(
                create_projection_matrix(2 * hidden, hidden, jax.random.PRNGKey(0)))))


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_build_matches_the_jax_cli(monkeypatch, name):
    argv = (["--dataset", "synth-n120-e700-f10-c3", "--epochs", "2", "--rand_split",
             "--hidden_channels", "16", "--num_heads", "2", "--dropout", "0",
             "--trans_dropout", "0", "--gnn_dropout", "0"] + ZOO[name])
    jtrainer, jsplits = _jax_trainer(monkeypatch, argv)
    built = cli.build(_args(argv + CPU))
    trainer = built.trainer
    assert type(built.model).__name__ == type(jtrainer.model).__name__
    cfg, jcfg = dataclasses.asdict(trainer.config), dataclasses.asdict(jtrainer.config)
    shared = set(cfg) & set(jcfg)
    assert {k: cfg[k] for k in shared} == {k: jcfg[k] for k in shared}
    _same_graph(built.graph, jtrainer.graph, name in ("graphtrans", "graphgps", "softmax",
                                                      "gat", "performer"))
    if name == "nodeformer":
        for g, ja in zip(trainer.model_kwargs["adjs"], jtrainer.model_kwargs["adjs"]):
            ja = np.asarray(ja)
            order = np.argsort(ja[1], kind="stable")
            _eq(g.edge_src, ja[0][order], "adjacency sources")
            _eq(g.edge_dst, ja[1][order], "adjacency destinations")
    if name == "graphormer":
        jin = jtrainer.model_kwargs["inputs"]
        assert set(trainer.model_kwargs["inputs"]) == set(jin)
        for k, v in trainer.model_kwargs["inputs"].items():
            _eq(v, jin[k], k)

    # the eval logits with the JAX parameters carried across
    state, tx, _ = jtrainer.init_state(jax.random.PRNGKey(0))
    want = np.asarray(jtrainer._build_steps(tx)[1](state))
    trainer.init_state(0)
    load_flax_variables(trainer.model, jax.tree.map(np.asarray, dict(state)))
    _pin_jax_draws(trainer.model, 16)
    got = trainer.eval_step().numpy()
    assert got.shape == want.shape == (120, 3)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("name", sorted(ZOO))
def test_cli_zoo_methods_and_attentions(name):
    logger = cli.main([
        "--dataset", "synth-n200-e1500-f12-c3", "--trainer", "full", "--epochs", "5",
        "--eval_step", "5", "--display_step", "-1", "--rand_split", "--hidden_channels", "16",
        "--num_heads", "2"] + ZOO[name] + CPU)
    assert logger.results[0] and all(np.isfinite(r).all() for r in logger.results[0])


@pytest.mark.parametrize("attention", ["softmax", "gat"])
def test_cli_save_attn_for_the_dense_ablations(tmp_path, attention):
    cli.main([
        "--dataset", "synth-n80-e600-f8-c4", "--method", "sgformer", "--trainer", "full",
        "--hidden_channels", "16", "--epochs", "2", "--rand_split", "--display_step", "-1",
        "--attention", attention, "--save_attn", "--attn_dir", str(tmp_path)] + CPU)
    (path,) = tmp_path.iterdir()
    attn = np.load(path)
    assert attn.shape == (1, 80, 80) and np.isfinite(attn).all()
    np.testing.assert_allclose(attn.sum(-1), 1.0, rtol=1e-5)


# -- tests/test_cli.py's runs through the port ---------------------------------------


def test_cli_full_trainer(tmp_path):
    logger = cli.main([
        "--dataset", SYNTH, "--method", "sgformer", "--trainer", "full", "--epochs", "15",
        "--eval_step", "5", "--display_step", "-1", "--rand_split", "--hidden_channels", "32",
        "--save_result", "--result_dir", str(tmp_path)] + CPU)
    assert logger.run_summary(0)["final_test"] > 0.4
    (path,) = tmp_path.glob("*.txt")
    assert path.name == f"{SYNTH}_sgformer_gcn.txt"
    line = path.read_text()
    assert line.startswith("runs=1 lr=0.01 hidden=32 epochs=15 test_acc=") and "±" in line


def test_cli_batch_trainer():
    logger = cli.main([
        "--dataset", "synth-n400-e3000-f16-c4", "--method", "sgformer", "--trainer", "batch",
        "--batch_size", "150", "--epochs", "10", "--eval_step", "5", "--display_step", "-1",
        "--rand_split", "--backbone", "graphconv"] + CPU)
    assert logger.results[0]


def test_cli_sampled_trainer(tmp_path):
    argv = ["--dataset", SYNTH, "--method", "sgformer", "--trainer", "sampled",
            "--batch_size", "64", "--epochs", "3", "--fanouts", "5", "3", "--display_step",
            "-1", "--rand_split", "--backbone", "graphconv", "--save_model", "--model_dir",
            str(tmp_path)] + CPU
    assert cli.main(argv).results[0]
    assert (tmp_path / "model.pt").exists()
    assert cli.main(argv + ["--use_pretrained", "--epochs", "1"]).results[0]


def test_cli_sampler_workers_train_the_same_losses(monkeypatch):
    """``--sampler_workers 2`` samples through the C++ sampler in two
    threads: the same batches, so bitwise the losses and results of 0."""
    from sgformer_tpu_torch.train import SampledTrainer

    argv = ["--dataset", SYNTH, "--method", "sgformer", "--trainer", "sampled",
            "--batch_size", "64", "--epochs", "2", "--fanouts", "5", "3", "--display_step",
            "-1", "--rand_split", "--backbone", "graphconv"] + CPU
    step = SampledTrainer.train_step
    runs = {}
    for workers in ("0", "2"):
        losses = runs[workers] = []

        def recording(self, batch, losses=losses, workers=workers):
            assert self.config.sampler_workers == int(workers) and self.sampler.use_native
            loss = step(self, batch)
            losses.append(loss.item())
            return loss

        monkeypatch.setattr(SampledTrainer, "train_step", recording)
        runs[workers + " results"] = cli.main(argv + ["--sampler_workers", workers]).results
    assert len(runs["0"]) == 2 * 3 and runs["2"] == runs["0"]
    assert runs["2 results"] == runs["0 results"]


@pytest.mark.parametrize("method", ["gcn", "mlp", "sgc", "appnp", "link", "gat", "gatjk",
                                    "gcnjk", "sign", "sgc2", "mixhop", "gprgnn", "h2gcn"])
def test_cli_baseline_methods(method):
    logger = cli.main([
        "--dataset", "synth-n200-e1500-f12-c3", "--method", method, "--trainer", "full",
        "--epochs", "5", "--eval_step", "5", "--display_step", "-1", "--rand_split",
        "--hidden_channels", "16", "--num_heads", "2"] + CPU)
    assert logger.results[0]


def test_cli_time_test(capsys):
    res = cli.main([
        "--dataset", "synth-n200-e1500-f12-c3", "--method", "sgformer", "--trainer", "full",
        "--epochs", "3", "--display_step", "-1", "--rand_split", "--time_test"] + CPU)
    assert res.per_epoch_ms > 0 and res.forward_ms > 0 and res.device == "cpu"
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["per_epoch_ms"] == res.per_epoch_ms and len(printed["losses"]) == 3 + 3
    with pytest.raises(ValueError, match="full"):
        cli.main(["--dataset", "synth-small", "--trainer", "batch", "--time_test"] + CPU)


def test_cli_h2gcn_time_test_runs_its_graphs():
    res = cli.main([
        "--dataset", "synth-n150-e1000-f12-c3", "--method", "h2gcn", "--trainer", "full",
        "--epochs", "2", "--display_step", "-1", "--rand_split", "--hidden_channels", "16",
        "--time_test"] + CPU)
    assert res.per_epoch_ms > 0 and all(np.isfinite(res.losses))


def test_cli_save_attn(tmp_path):
    cli.main([
        "--dataset", "synth-n80-e600-f8-c4", "--method", "sgformer", "--trainer", "full",
        "--hidden_channels", "16", "--epochs", "2", "--runs", "1", "--rand_split",
        "--display_step", "-1", "--trans_num_layers", "2", "--save_attn", "--attn_dir",
        str(tmp_path)] + CPU)
    files = list(tmp_path.iterdir())
    assert len(files) == 1
    attn = np.load(files[0])
    assert attn.shape == (2, 80, 80) and np.isfinite(attn).all()


def test_cli_trans_residual_mode():
    from sgformer_tpu_torch.cli.parse import parse_method

    args = _args(["--method", "sgformer", "--backbone", "graphconv",
                  "--trans_residual_mode", "mean", "--alpha", "0.7"] + CPU)
    model = parse_method(args, n=100, c=4, d=16)
    assert model.config.trans_residual_mode == "mean"
    assert parse_method(_args(["--method", "sgformer"] + CPU), 100, 4, 16) \
        .config.trans_residual_mode == "alpha"


# -- refusals ---------------------------------------------------------------------


@pytest.mark.parametrize("halo", [False, True], ids=["allgather", "halo"])
def test_sharded_trainer_at_world_one_trains_as_the_full_trainer(halo):
    """``--trainer sharded`` in one process is a group of one (gloo on the
    CPU): the model gets ``axis_name="sp"``, and its fit gives the full
    trainer's statistics (one shard: the same rows, dropout masks and sums
    up to summation order)."""
    from sgformer_tpu_torch.parallel import ShardedTrainer

    flags = ["--dataset", "synth-n300-e2400-f16-c4", "--epochs", "6", "--eval_step", "2",
             "--rand_split", "--display_step", "-1", "--method", "sgformer",
             "--backbone", "graphconv"] + CPU
    sharded = ["--trainer", "sharded"] + (["--use_halo"] if halo else [])
    built = cli.build(_args(flags + sharded))
    assert isinstance(built.trainer, ShardedTrainer)
    assert built.model.config.axis_name == "sp"
    assert (built.trainer.graph.halo is not None) == halo
    got = np.array(cli.main(flags + sharded).results[0])
    want = np.array(cli.main(flags + ["--trainer", "full"]).results[0])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    res = cli.main(flags + sharded + ["--time_test"])
    assert np.isfinite(res.losses).all() and res.losses[-1] < res.losses[0]


@pytest.mark.parametrize("method", ["sgc", "sgc2", "sign", "mixhop", "gcnjk", "appnp",
                                    "gprgnn"])
def test_sharded_trainer_runs_the_baselines_as_the_full_trainer(method):
    """The baselines the JAX CLI also builds under ``--trainer sharded`` get
    the axis on their BatchNorm layers and train in one process. Their fit
    is not held to the full trainer's here: a bias that feeds a train-mode
    BatchNorm has an exact gradient of 0, and Adam turns the two trainers'
    different rounding of it into steps of lr. ``test_torch_parallel.py``
    holds their sharded step to the one-device ``Trainer``'s, gradient by
    gradient, at 2 and 3 ranks."""
    from sgformer_tpu_torch.nn.norm import MaskedBatchNorm
    from sgformer_tpu_torch.parallel import ShardedTrainer

    flags = ["--dataset", "synth-n300-e2400-f16-c4", "--epochs", "4", "--eval_step", "2",
             "--rand_split", "--display_step", "-1", "--method", method, "--hops", "2",
             "--num_layers", "3"] + CPU
    sharded = ["--trainer", "sharded", "--use_halo"]
    built = cli.build(_args(flags + sharded))
    assert isinstance(built.trainer, ShardedTrainer)
    assert all(m.axis_name == "sp" for m in built.model.modules()
               if isinstance(m, MaskedBatchNorm))
    got = np.array(cli.main(flags + sharded).results[0])
    assert got.shape == (2, 4) and np.isfinite(got).all()
    assert ((got[:, :3] >= 0) & (got[:, :3] <= 1)).all()


def test_sharded_trainer_refuses_what_it_cannot_run():
    for method in ("gat", "gatjk", "nodeformer"):
        with pytest.raises(ValueError, match="--trainer sharded runs"):
            cli.build(_args(["--dataset", "synth-small", "--rand_split", "--method", method,
                             "--trainer", "sharded"] + CPU))
    with pytest.raises(ValueError, match="save_attn"):
        cli.main(["--dataset", "synth-small", "--rand_split", "--trainer", "sharded",
                  "--save_attn"] + CPU)


def test_cli_raises_without_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--dataset", "synth-small", "--epochs", "1", "--rand_split"])
    assert _args([]).device == "cuda"


def _recipe_runs(path, module):
    """Each run of a recipe file as its flags: the ``RUN=`` prefix's (after
    ``python -m module``) and the run's own, ``"$@"`` dropped."""
    import shlex

    with open(path) as f:
        lines = f.read().replace("\\\n", " ").splitlines()
    prefix = []
    runs = []
    for line in lines:
        words = shlex.split(line, comments=True)
        if line.startswith("RUN="):
            prefix = shlex.split(line[len("RUN="):].strip().strip('"'))[3:]
        elif words[:3] == ["python", "-m", module]:
            runs.append(words[3:])
        elif words[:1] == ["$RUN"]:
            runs.append(prefix + words[1:])
    return [[a for a in run if a != "$@"] for run in runs]


@pytest.mark.parametrize("recipe", ["ablation.sh", "large.sh", "medium.sh", "100m.sh"])
def test_port_recipes_run_the_jax_recipes(recipe):
    """Each run of ``sgformer_tpu_torch/recipes/<recipe>`` parses to the
    same flags as the same run of ``configs/<recipe>`` (the ablation's for
    each of its kernels)."""
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jax_runs = _recipe_runs(os.path.join(repo, "configs", recipe), "sgformer_tpu.cli.main")
    port_runs = _recipe_runs(os.path.join(repo, "sgformer_tpu_torch", "recipes", recipe),
                             "sgformer_tpu_torch.cli.main")
    assert len(port_runs) == len(jax_runs) > 0
    for jax_run, port_run in zip(jax_runs, port_runs):
        for kernel in ("simple", "softmax", "gat", "performer"):
            def parsed(run):
                return vars(_args([kernel if a == "$KERNEL" else a for a in run]))

            assert parsed(port_run) == parsed(jax_run), port_run
