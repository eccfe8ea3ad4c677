"""The clustering reorder of the port (``native.reorder``, the C++
``lpa_cluster`` and ``cluster_pack`` of ``csrc/graph_kernels.cpp``) against
the JAX package's (``sgformer_tpu.native.api``, ``kernels/slabs.py::
reorder_for_slabs``, ``preprocess_graph(reorder=True)``), bitwise, and what
the port does with a reordered graph: ``Trainer`` and ``Predictor`` give the
logits of the unreordered graph in the caller's node order. A failed g++
build raises (the JAX function falls back to numpy)."""

import os
import shutil

import numpy as np
import pytest
import torch

import sgformer_tpu.native.api as jax_native
from sgformer_tpu.data.loaders import synthetic_dataset as jax_synthetic_dataset
from sgformer_tpu.graph import preprocess_graph as jax_preprocess_graph
from sgformer_tpu.graph import add_self_loops, remove_self_loops, to_undirected
from sgformer_tpu.kernels.slabs import reorder_for_slabs

from sgformer_tpu_torch import Predictor, SGFormer, SGFormerConfig, preprocess_graph
from sgformer_tpu_torch.native import build, cluster_pack_native, lpa_cluster_native
from sgformer_tpu_torch.native.reorder import reorder_for_clusters
from sgformer_tpu_torch.train import TrainConfig, Trainer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def community_graph():
    """A homophilous synthetic graph (communities for LPA to find) and its
    symmetrised, self-looped edge list as the reorder sees it."""
    ds = jax_synthetic_dataset(num_nodes=1200, num_edges=9000, num_features=8, num_classes=6,
                               seed=4)
    ei = np.asarray(ds.graph["edge_index"])
    full = add_self_loops(remove_self_loops(to_undirected(ei)), 1200)
    return ds, ei, full


@pytest.mark.parametrize("seed,iters", [(0, 40), (1, 40), (5, 7)])
def test_lpa_cluster_is_jaxs(community_graph, seed, iters):
    _, _, full = community_graph
    m = full[0] != full[1]
    src, dst = full[0][m], full[1][m]
    want = jax_native.lpa_cluster_native(src, dst, 1200, iters, 1201, seed)
    got = lpa_cluster_native(src, dst, 1200, iters, 1201, seed)
    np.testing.assert_array_equal(got, want)
    assert got.max() + 1 < 1200  # it found clusters


@pytest.mark.parametrize("slab_rows", [1200, 100, 7])
def test_cluster_pack_is_jaxs(community_graph, slab_rows):
    _, _, full = community_graph
    m = full[0] != full[1]
    clusters = jax_native.lpa_cluster_native(full[0][m], full[1][m], 1200, 40, 1201, 0)
    np.testing.assert_array_equal(cluster_pack_native(clusters, slab_rows),
                                  jax_native.cluster_pack_native(clusters, slab_rows))


def test_reorder_is_jaxs_restart_loop(community_graph):
    """The JAX restart-and-score loop at slab_rows = N (the reorder=True
    call): every restart scores 1 and the first one's labels win."""
    _, _, full = community_graph
    perm, inv = reorder_for_clusters(full, 1200)
    want = reorder_for_slabs(full, 1200, slab_rows=1200)
    np.testing.assert_array_equal(perm, want[0])
    np.testing.assert_array_equal(inv, want[1])


@pytest.mark.parametrize("undirected", [True, False])
def test_preprocess_graph_reorder_is_jaxs(community_graph, undirected):
    _, ei, _ = community_graph
    jg = jax_preprocess_graph(ei, 1200, reorder=True, undirected=undirected,
                              with_pyg_norm=True)
    g = preprocess_graph(ei, 1200, reorder=True, undirected=undirected, with_pyg_norm=True,
                         device="cpu")
    np.testing.assert_array_equal(g.node_perm.numpy(), np.asarray(jg.node_perm))
    for name, jname in (("edge_src", "edge_src"), ("edge_dst", "edge_dst"),
                        ("gcn_weight", "gcn_weight"), ("pyg_weight", "pyg_weight")):
        np.testing.assert_array_equal(getattr(g, name).numpy(), np.asarray(getattr(jg, jname)))
    # the graph carries the permutation through to() and its leaves
    assert torch.equal(g.to("cpu").node_perm, g.node_perm)
    from sgformer_tpu_torch.graph import graph_from_leaves, graph_leaves

    assert torch.equal(graph_from_leaves(*graph_leaves(g)).node_perm, g.node_perm)


def _model(seed=0):
    cfg = SGFormerConfig.large(16, 6, trans_num_layers=1, gnn_num_layers=2,
                               trans_dropout=0.0, gnn_dropout=0.0)
    return SGFormer(cfg, 8, generator=torch.Generator().manual_seed(seed), device="cpu")


@pytest.mark.parametrize("loss", ["nll", "bce"])
def test_trainer_on_a_reordered_graph_gives_the_callers_order(community_graph, loss):
    ds, ei, _ = community_graph
    x, label = np.asarray(ds.graph["node_feat"]), np.asarray(ds.label)
    split = ds.get_idx_split(rng=np.random.default_rng(0))
    out = {}
    for reorder in (False, True):
        g = preprocess_graph(ei, 1200, reorder=reorder, device="cpu")
        tr = Trainer(_model(), g, x, label, TrainConfig(lr=1e-2, loss=loss, epochs=4,
                                                         display_step=-1), device="cpu")
        tr.init_state(0)
        logits = tr.eval_step()
        loss_v = tr.loss(tr.prepare_train_idx(split)).item()
        results = tr.fit([split]).results[0]
        out[reorder] = (logits, loss_v, np.array(results))
    np.testing.assert_allclose(out[True][0].numpy(), out[False][0].numpy(), rtol=0,
                               atol=1e-5 * out[False][0].abs().max().item())
    np.testing.assert_allclose(out[True][1], out[False][1], rtol=1e-5)
    np.testing.assert_allclose(out[True][2], out[False][2], rtol=1e-4, atol=1e-6)


def test_predictor_on_a_reordered_graph_gives_the_callers_order(community_graph, tmp_path):
    ds, ei, _ = community_graph
    x = np.asarray(ds.graph["node_feat"])
    plain = Predictor(_model(), preprocess_graph(ei, 1200, device="cpu"), x, device="cpu")
    g = preprocess_graph(ei, 1200, reorder=True, device="cpu")
    re = Predictor(_model(), g, x, device="cpu")
    want = plain.logits()
    np.testing.assert_allclose(re.logits(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(re.predict([3, 700, 5]), re.logits()[[3, 700, 5]].argmax(-1))
    # the export bundle maps the program's rows to the caller's ids
    path = re.export_artifact(str(tmp_path / "fwd.pt2"), include_inputs=True)
    inv = np.load(path + ".inputs.npz")["inv_perm"]
    np.testing.assert_array_equal(g.node_perm.numpy()[inv], np.arange(1200))


def test_a_failed_build_raises(monkeypatch, tmp_path, community_graph):
    """No numpy fallback: the reorder raises with the compiler's error."""
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setenv("SGFORMER_CACHE_DIR", str(tmp_path / "cache"))
    broken = tmp_path / "graph_kernels.cpp"
    shutil.copy(build.SOURCE, broken)
    with open(broken, "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(build, "SOURCE", str(broken))
    _, ei, _ = community_graph
    with pytest.raises(RuntimeError, match="(?s)build failed.*error"):
        preprocess_graph(ei, 1200, reorder=True, device="cpu")
    assert not os.listdir(tmp_path / "cache" / "native")
