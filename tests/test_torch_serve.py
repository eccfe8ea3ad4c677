"""The port's serving path (``Predictor`` over the whole SGFormer) against
the JAX ``Predictor`` with the same trained weights.

The JAX model (large tier, hidden 32, 3 GCN layers, dropout 0) is trained
for a few epochs first, so the BatchNorm statistics are not the identity.
f32 tolerance is 2e-4, the repo's own tolerance between its slab and XLA
paths (tests/test_slab_spmm.py), since only summation order differs; bf16
is held to argmax agreement >= 99% and logits atol 5e-2, because the two
frameworks round bf16 at different places (the JAX SpMM sums in bf16, the
port in f32)."""

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
from sgformer_tpu.train import TrainConfig, Trainer

from sgformer_tpu_torch import (
    Predictor,
    SGFormer,
    SGFormerConfig,
    load_flax_variables,
    preprocess_graph,
)

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
