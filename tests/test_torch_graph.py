"""The port's graph preprocessing and synthetic data against the JAX
package's: the same edge list must give the same arrays, exactly."""

import numpy as np
import pytest
import torch

from sgformer_tpu.data.loaders import _parse_synth_name
from sgformer_tpu.data.loaders import synthetic_dataset as jax_synthetic_dataset
from sgformer_tpu.graph import preprocess_graph as jax_preprocess_graph
from sgformer_tpu.ops.spmm import spmm as jax_spmm

from sgformer_tpu_torch.data import SYNTHETIC, synthetic_dataset
from sgformer_tpu_torch.graph import preprocess_graph

torch.set_num_threads(1)


def _edges(seed, n=200, e=900):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, (2, e)).astype(np.int64)
    ei[:, :5] = np.arange(5)  # a few self-loops to replace
    return ei, n


@pytest.mark.parametrize("kw", [
    {},
    {"undirected": False},
    {"self_loops": False},
    {"with_pyg_norm": True},
])
def test_preprocess_graph_matches_jax(kw):
    ei, n = _edges(0)
    want = jax_preprocess_graph(ei, n, **kw)
    got = preprocess_graph(ei, n, device="cpu", **kw)
    assert got.num_nodes == want.num_nodes and got.num_edges == want.num_edges
    assert got.node_perm is None
    for name in ("edge_src", "edge_dst", "gcn_weight", "indptr"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == (torch.float32 if name == "gcn_weight" else torch.int32)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if kw.get("with_pyg_norm"):
        for name in ("pyg_src", "pyg_dst", "pyg_weight"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                err_msg=name)
        counts = np.bincount(got.pyg_dst.numpy(), minlength=n)
        np.testing.assert_array_equal(np.diff(got.pyg_indptr.numpy()), counts)
    else:
        assert got.pyg_src is None and got.pyg_indptr is None


def test_preprocess_graph_takes_a_tensor_edge_list():
    ei, n = _edges(1)
    a = preprocess_graph(ei, n, device="cpu")
    b = preprocess_graph(torch.from_numpy(ei), n, device="cpu")
    assert torch.equal(a.edge_src, b.edge_src) and torch.equal(a.indptr, b.indptr)


@pytest.mark.parametrize("kind", ["gcn", "pyg"])
def test_propagate_matches_jax_spmm(kind):
    """Graph.propagate (the kernel wrapper's plain path on the CPU) against
    the JAX XLA aggregation, f32: only the summation order differs."""
    ei, n = _edges(2)
    jg = jax_preprocess_graph(ei, n, with_pyg_norm=True)
    tg = preprocess_graph(ei, n, with_pyg_norm=True, device="cpu")
    x = np.random.default_rng(3).standard_normal((n, 12)).astype(np.float32)
    if kind == "gcn":
        want = jax_spmm(x, jg.edge_src, jg.edge_dst, jg.gcn_weight, n)
    else:
        want = jax_spmm(x, jg.pyg_src, jg.pyg_dst, jg.pyg_weight, n)
    got = tg.propagate(torch.from_numpy(x), kind=kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_propagate_rejects_missing_pyg_edges():
    ei, n = _edges(4)
    g = preprocess_graph(ei, n, device="cpu")
    with pytest.raises(ValueError, match="pyg"):
        g.propagate(torch.zeros(n, 4), kind="pyg")


def test_graph_to_keeps_every_field():
    ei, n = _edges(5)
    g = preprocess_graph(ei, n, with_pyg_norm=True, device="cpu")
    h = g.to("cpu")
    assert h.num_nodes == g.num_nodes and h.num_edges == g.num_edges
    assert torch.equal(h.pyg_weight, g.pyg_weight) and h.device.type == "cpu"


@pytest.mark.parametrize("kw", [
    dict(num_nodes=300, num_edges=2400, num_features=16, num_classes=4, seed=3),
    dict(num_nodes=500, num_edges=3000, num_features=8, num_classes=5, seed=11,
         powerlaw=1.2, homophily=0.6, feature_scale=0.5),
])
def test_synthetic_dataset_same_arrays(kw):
    want = jax_synthetic_dataset(**kw)
    got = synthetic_dataset(device="cpu", **kw)
    np.testing.assert_array_equal(got.graph["edge_index"], want.graph["edge_index"])
    np.testing.assert_array_equal(got.graph["node_feat"].numpy(),
                                  want.graph["node_feat"])
    np.testing.assert_array_equal(got.label, want.label)
    assert got.num_nodes == want.num_nodes and got.num_classes == want.num_classes
    s1 = got.get_idx_split(rng=np.random.default_rng(0))
    s2 = want.get_idx_split(rng=np.random.default_rng(0))
    for part in ("train", "valid", "test"):
        np.testing.assert_array_equal(s1[part], s2[part])


def test_synth_arxiv_name_matches_jax():
    want = _parse_synth_name("synth-arxiv")
    got = synthetic_dataset("synth-arxiv", device="cpu")
    shape = SYNTHETIC["synth-arxiv"]
    assert got.num_nodes == want.num_nodes == shape["num_nodes"]
    assert got.graph["edge_index"].shape == (2, shape["num_edges"])
    np.testing.assert_array_equal(got.graph["edge_index"], want.graph["edge_index"])
    np.testing.assert_array_equal(got.label, want.label)
    np.testing.assert_array_equal(got.graph["node_feat"].numpy(),
                                  want.graph["node_feat"])


def test_unknown_synthetic_name_raises():
    with pytest.raises(ValueError, match="unknown synthetic"):
        synthetic_dataset("synth-nope", device="cpu")
