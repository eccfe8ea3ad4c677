"""The port's serving path (``Predictor`` over the whole SGFormer) against
the JAX ``Predictor`` with the same trained weights; ``load_predictor`` on
the port's checkpoints against the JAX ``load_predictor`` on its orbax
checkpoint of the same weights (f32, 2e-4) and against the trainer's own
eval logits (exact on the CPU); and a ``Predictor`` of the zoo models that
take keyword arguments or return a tuple against their trainer's
``eval_step`` (exact on the CPU: the same forward).

The JAX model (large tier, hidden 32, 3 GCN layers, dropout 0) is trained
for a few epochs first, so the BatchNorm statistics are not the identity.
f32 tolerance is 2e-4, the repo's own tolerance between its slab and XLA
paths (tests/test_slab_spmm.py), since only summation order differs; bf16
is held to argmax agreement >= 99% and logits atol 5e-2, because the two
frameworks round bf16 at different places (the JAX SpMM sums in bf16, the
port in f32)."""

import argparse
import dataclasses

import jax
import numpy as np
import pytest
import torch

from sgformer_tpu.data.loaders import synthetic_dataset as jax_synthetic_dataset
from sgformer_tpu.graph import preprocess_graph as jax_preprocess_graph
from sgformer_tpu.nn import SGFormer as JaxSGFormer
from sgformer_tpu.nn import SGFormerConfig as JaxConfig
from sgformer_tpu.serve import Predictor as JaxPredictor
from sgformer_tpu.serve import load_predictor as jax_load_predictor
from sgformer_tpu.train import TrainConfig, Trainer
from sgformer_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint

from sgformer_tpu_torch import (
    Predictor,
    SGFormer,
    SGFormerConfig,
    load_flax_variables,
    load_predictor,
    preprocess_graph,
)
from sgformer_tpu_torch import train as port_train
from sgformer_tpu_torch.cli import main as cli
from sgformer_tpu_torch.train import checkpoint

torch.set_num_threads(1)

CFG = dict(gnn_num_layers=3, trans_dropout=0.0, gnn_dropout=0.0)


@pytest.fixture(scope="module")
def trained():
    ds = jax_synthetic_dataset(num_nodes=300, num_edges=2400, num_features=16,
                               num_classes=4, seed=3)
    graph = jax_preprocess_graph(ds.graph["edge_index"], ds.num_nodes)
    model = JaxSGFormer(JaxConfig.large(32, 4, **CFG))
    tc = TrainConfig(lr=0.01, epochs=5, eval_step=5, display_step=-1)
    trainer = Trainer(model, graph, ds.graph["node_feat"], ds.label, tc)
    trainer.fit([ds.get_idx_split(rng=np.random.default_rng(0))])
    state = jax.tree.map(np.asarray, trainer.final_state)
    return ds, graph, model, state


def _port(ds, state, compute_dtype="f32"):
    cfg = SGFormerConfig.large(32, 4, compute_dtype=compute_dtype, **CFG)
    model = SGFormer(cfg, 16, device="cpu")
    graph = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, device="cpu")
    return Predictor(model, graph, ds.graph["node_feat"], state=state,
                     device="cpu").compile()


def test_batchnorm_stats_were_trained(trained):
    _, _, _, state = trained
    var = state["batch_stats"]["graph_conv"]["bn_0"]["var"]
    assert not np.allclose(var, 1.0)


def test_logits_match_jax_f32(trained):
    ds, graph, model, state = trained
    want = JaxPredictor(model, graph, ds.graph["node_feat"], state).logits()
    got = _port(ds, state).logits()
    assert got.dtype == np.float32 and got.shape == want.shape == (300, 4)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_logits_match_jax_pallas_path(trained):
    """Against the JAX forward through all four kernels of the serving path
    (the slab SpMM's ``_ssel_kernel`` and ``_spmm_kernel``, the attention
    reduce and apply), in interpret mode on a reordered ``ssel`` graph."""
    ds, _, model, state = trained
    g_ssel = jax_preprocess_graph(
        ds.graph["edge_index"], ds.num_nodes, with_chunks=True, spmm_mode="ssel",
        slab_rows=128, chunk_dtype="f32", chunk_interpret=True,
    )
    assert g_ssel.node_perm is not None
    pallas = JaxSGFormer(dataclasses.replace(model.config, attention_impl="pallas"))
    want = JaxPredictor(pallas, g_ssel, ds.graph["node_feat"], state).logits()
    got = _port(ds, state).logits()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_bf16_logits_close_to_jax(trained):
    ds, graph, _, state = trained
    jmodel = JaxSGFormer(JaxConfig.large(32, 4, compute_dtype="bf16", **CFG))
    want = JaxPredictor(jmodel, graph, ds.graph["node_feat"], state).logits()
    got = _port(ds, state, "bf16").logits()
    assert got.dtype == np.float32
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)


def test_predict_and_proba_match_jax(trained):
    ds, graph, model, state = trained
    jp = JaxPredictor(model, graph, ds.graph["node_feat"], state)
    tp = _port(ds, state)
    idx = np.array([5, 17, 250, 0])
    np.testing.assert_array_equal(tp.predict(idx), jp.predict(idx))
    np.testing.assert_array_equal(tp.predict(), jp.predict())
    np.testing.assert_allclose(tp.predict_proba(idx), jp.predict_proba(idx),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tp.predict_proba().sum(-1), 1.0, rtol=1e-5)


def test_attention_maps_match_jax(trained):
    """``get_attentions`` (the plain path's ``output_attn``), [L, N, N]."""
    ds, _, model, state = trained
    want = np.asarray(model.apply(state, ds.graph["node_feat"],
                                  method=JaxSGFormer.get_attentions))
    port = SGFormer(SGFormerConfig.large(32, 4, **CFG), 16, device="cpu")
    load_flax_variables(port, state).eval()
    with torch.no_grad():
        got = port.get_attentions(torch.from_numpy(ds.graph["node_feat"])).numpy()
    assert got.shape == want.shape == (1, 300, 300)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-7)


def test_predictor_rejects_wrong_feature_rows(trained):
    ds, _, _, state = trained
    model = SGFormer(SGFormerConfig.large(32, 4, **CFG), 16, device="cpu")
    graph = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, device="cpu")
    with pytest.raises(ValueError, match="rows"):
        Predictor(model, graph, ds.graph["node_feat"][:10], state=state, device="cpu")


@pytest.mark.parametrize("method", ["nodeformer", "h2gcn", "graphormer"])
def test_predictor_takes_model_kwargs_and_tuple_outputs(method):
    """NodeFormer (adjacency graphs in, (logits, link losses) out), H2GCN
    (its two hop graphs) and Graphormer (its structural inputs) behind a
    ``Predictor`` given the trainer's ``model_kwargs``: the logits are
    ``eval_step``'s, after two train steps moved the weights."""
    argv = ["--device", "cpu", "--dataset", "synth-n300-e2400-f16-c4", "--trainer", "full",
            "--method", method, "--rand_split", "--runs", "1", "--display_step", "-1"]
    built = cli.build(cli.parser_add_main_args(argparse.ArgumentParser()).parse_args(argv))
    trainer = built.trainer
    assert trainer.model_kwargs
    idx = trainer.prepare_train_idx(built.splits[0])
    trainer.init_state(0)
    for _ in range(2):
        trainer.train_step(idx)
    want = trainer.eval_step().numpy()
    pred = Predictor(trainer.model, trainer.graph, trainer.x,
                     model_kwargs=trainer.model_kwargs, device="cpu").compile()
    got = pred.logits()
    assert got.shape == (300, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pred.predict(), want.argmax(-1))


def _port_trainer(ds):
    model = SGFormer(SGFormerConfig.large(32, 4, **CFG), 16, device="cpu")
    graph = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, device="cpu")
    trainer = port_train.Trainer(model, graph, ds.graph["node_feat"], ds.label,
                                 port_train.TrainConfig(lr=0.01), device="cpu")
    idx = trainer.prepare_train_idx(ds.get_idx_split(rng=np.random.default_rng(0)))
    trainer.init_state(0)
    for _ in range(3):
        trainer.train_step(idx)
    return trainer


@pytest.mark.parametrize("saver", ["save_checkpoint", "save_state"])
def test_load_predictor_restores_the_port_checkpoints(trained, tmp_path, saver):
    """A checkpoint of either kind, loaded into a fresh model of the same
    config, serves the trainer's eval logits exactly."""
    ds = trained[0]
    trainer = _port_trainer(ds)
    path = str(tmp_path / "ck.pt")
    if saver == "save_checkpoint":
        checkpoint.save_checkpoint(path, trainer.model, trainer.optimizer, 3, trainer.generator)
    else:
        checkpoint.save_state(path, trainer.model.state_dict(), 3)
    want = trainer.eval_step().numpy()
    fresh = SGFormer(SGFormerConfig.large(32, 4, **CFG), 16,
                     generator=torch.Generator().manual_seed(9), device="cpu")
    graph = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, device="cpu")
    got = load_predictor(path, fresh, graph, ds.graph["node_feat"], device="cpu").logits()
    np.testing.assert_array_equal(got, want)


def test_load_predictor_matches_jax(trained, tmp_path):
    """The JAX ``load_predictor`` on its orbax checkpoint of the trained
    state against the port's ``load_predictor`` on a port checkpoint of the
    same weights (``load_flax_variables``)."""
    ds, graph, model, state = trained
    jax_save_checkpoint(str(tmp_path / "jax_ck"), state, step=5)
    want = jax_load_predictor(str(tmp_path / "jax_ck"), model, graph,
                              ds.graph["node_feat"]).logits()
    port = load_flax_variables(SGFormer(SGFormerConfig.large(32, 4, **CFG), 16, device="cpu"),
                               state)
    path = str(tmp_path / "port_ck.pt")
    checkpoint.save_state(path, port.state_dict(), 5)
    fresh = SGFormer(SGFormerConfig.large(32, 4, **CFG), 16, device="cpu")
    graph_t = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, device="cpu")
    got = load_predictor(path, fresh, graph_t, ds.graph["node_feat"], device="cpu").logits()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
