"""The port's host transforms against the JAX package's on the same inputs:
each bitwise (the same numpy and scipy calls in the same order), on seeded
graphs with duplicate edges, self-loops and isolated nodes."""

import numpy as np
import pytest
import torch

import reference_numpy as ref

from sgformer_tpu.data import transforms as jt
from sgformer_tpu.data.loaders import synthetic_dataset as jax_synthetic_dataset

from sgformer_tpu_torch.data import transforms as pt
from sgformer_tpu_torch.data.loaders import synthetic_dataset

N = 60


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(21)
    e = ref.random_graph(rng, N - 5, 300)  # the last five nodes isolated
    e = np.concatenate([e, e[:, :7], np.array([[3, 9], [3, 9]])], axis=1)  # dups, loops
    x = rng.standard_normal((N, 6)).astype(np.float32)
    return e, x


def _eq(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_normalize_features_matches_jax(graph):
    _, x = graph
    x = np.abs(x)
    x[4] = 0.0
    _eq(pt.normalize_features(x), jt.normalize_features(x))


@pytest.mark.parametrize("num_props", [1, 3])
def test_sgc_features_match_jax(graph, num_props):
    e, x = graph
    _eq(pt.compute_sgc_features(e, x, num_props=num_props),
        jt.compute_sgc_features(e, x, num_props=num_props))


@pytest.mark.parametrize("flags", [
    dict(use_sgc_features=True),
    dict(use_identity_features=True),
    dict(use_adjacency_features=True, do_not_use_original_features=True),
    dict(use_sgc_features=True, use_identity_features=True, use_adjacency_features=True),
])
def test_augment_node_features_matches_jax(graph, flags):
    e, x = graph
    _eq(pt.augment_node_features(e, x, **flags), jt.augment_node_features(e, x, **flags))


def test_augment_node_features_refuses_no_source(graph):
    e, x = graph
    with pytest.raises(ValueError, match="disabled"):
        pt.augment_node_features(e, x, do_not_use_original_features=True)


@pytest.mark.parametrize("method", ["rcm", "degree"])
def test_reorder_dataset_matches_jax(method):
    jds = jax_synthetic_dataset(num_nodes=120, num_edges=500, num_features=5, seed=2)
    pds = synthetic_dataset(num_nodes=120, num_edges=500, num_features=5, seed=2, device="cpu")
    jds, jperm = jt.reorder_dataset(jds, method)
    pds, perm = pt.reorder_dataset(pds, method)
    _eq(perm, jperm)
    _eq(pds.graph["edge_index"], jds.graph["edge_index"])
    _eq(pds.label, jds.label)
    feat = pds.graph["node_feat"]
    assert isinstance(feat, torch.Tensor)
    _eq(feat.numpy(), jds.graph["node_feat"])
    with pytest.raises(ValueError):
        pt.reorder_dataset(pds, "spectral")


def test_gen_normalized_adjs_match_jax(graph):
    e, _ = graph
    for got, want in zip(pt.gen_normalized_adjs(e, N), jt.gen_normalized_adjs(e, N)):
        for g, w in zip(got, want):
            _eq(g, w)


@pytest.mark.parametrize("power", [1, 2, 3])
def test_adj_mul_matches_jax(graph, power):
    e, _ = graph
    _eq(pt.adj_mul(e, N, power=power), jt.adj_mul(e, N, power=power))


def test_convert_to_adj_matches_jax(graph):
    e, _ = graph
    _eq(pt.convert_to_adj(e, N), jt.convert_to_adj(e, N))
