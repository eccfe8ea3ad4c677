"""The port's C++ host sampler against the JAX package's, on the CPU.

- ``sgformer_tpu_torch.native.sample_batch_native`` bit for bit the JAX
  ``sgformer_tpu.native.api.sample_batch_native`` for the same seed: the
  batch's nodes, its dst-sorted edges, their f32 weights and the node count,
  over the JAX call's real (unpadded) part, with caps above any batch;
- ``NeighborSampler``'s default (the C++ path) bitwise the JAX default over
  an epoch, and ``epoch(workers > 0)`` bitwise ``workers=0``;
- the worst-case caps: reached exactly without truncating, a smaller cap
  refused, and a failed build refused (no numpy fallback);
- ``SampledTrainer.fit`` on the C++ path against the JAX trainer's default
  path (dropout 0, lr 1e-3: losses 1e-5, state 1e-4, as
  ``test_torch_sampled.py`` holds the numpy path), and bitwise the same with
  ``sampler_workers=2``;
- the hop sampler: ``sample_neighbors_native`` bit for bit the JAX one for
  the same frontier and seed, ``use_native=False`` batches bitwise the JAX
  sampler's ``use_native=False`` batches with its library loaded, a failed
  build refused there too, and ``native_available``.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

import sgformer_tpu.native.api as jax_native
from sgformer_tpu.native import native_available
from sgformer_tpu.sample.neighbor import CSRGraph as JaxCSRGraph
from sgformer_tpu.sample.neighbor import NeighborSampler as JaxSampler

from sgformer_tpu_torch.native import build, sample_batch_native, sample_neighbors_native
from sgformer_tpu_torch.native import native_available as port_native_available
from sgformer_tpu_torch.sample import CSRGraph, NeighborSampler, neighbor
from sgformer_tpu_torch.sample.neighbor import worst_case_caps
from sgformer_tpu_torch.train import build_sampled_graph
from test_torch_sampled import (FANOUTS, _check_state, _edges, _jax_fit, _jax_sampler,
                                _port_fit, _port_state, _variables, problem)  # noqa: F401
from test_torch_sampled import _check_batch as _check_hop_batch

torch.set_num_threads(1)


def _powerlaw(n, e, seed):
    from sgformer_tpu.data.loaders import synthetic_dataset

    ds = synthetic_dataset(num_nodes=n, num_edges=e, num_features=4, num_classes=3,
                           powerlaw=1.1, seed=seed)
    return _edges(ds.graph["edge_index"], n)


def _low_degree(n):
    """In-degree 1 to 3 everywhere: every node takes all its in-edges."""
    rng = np.random.default_rng(3)
    dst = np.repeat(np.arange(n), rng.integers(1, 4, n))
    return np.stack([rng.integers(0, n, len(dst)), dst])


# name: (edge list, nodes, seeds, fanouts)
def _case(name):
    rng = np.random.default_rng(11)
    if name == "powerlaw-hubs":
        e = _powerlaw(3000, 30000, 0)
        assert np.bincount(e[1]).max() > 100  # hubs far above the fanouts
        return e, 3000, rng.permutation(3000)[:200], (15, 10, 5)
    if name == "low-degree":
        return _low_degree(500), 500, rng.permutation(500)[:60], (4, 4, 4)
    if name == "no-in-edges":
        # nodes 2, 4 and 5 receive nothing; seeds 5 and 4 sample nothing
        ei = np.array([[1, 2, 3, 4, 2], [0, 0, 1, 1, 3]])
        return ei, 6, np.array([5, 0, 4, 2]), (2, 2)
    if name == "fanout-above-64":
        e = _powerlaw(2000, 40000, 1)
        assert (np.bincount(e[1]) > 64).sum() > 5
        return e, 2000, rng.permutation(2000)[:40], (100, 3)
    raise KeyError(name)


CASES = ("powerlaw-hubs", "low-degree", "no-in-edges", "fanout-above-64")


def _check_native_batch(jax_out, port_out):
    """The port's real-size arrays against the JAX call's padded ones."""
    node_ids, src, dst, w, mask, n, trunc = jax_out
    p_nodes, p_src, p_dst, p_w, p_trunc = port_out
    e = len(p_src)
    assert len(p_nodes) == n and not trunc.any() and p_trunc == (False, False)
    assert p_nodes.dtype == np.int64 and p_src.dtype == p_dst.dtype == np.int32
    assert p_w.dtype == np.float32
    np.testing.assert_array_equal(p_nodes, node_ids[:n])
    np.testing.assert_array_equal(p_src, src[:e])
    np.testing.assert_array_equal(p_dst, dst[:e])
    np.testing.assert_array_equal(p_w.view(np.int32), w[:e].view(np.int32))
    # the JAX call's rest is its padding, and every real weight is positive
    assert (w[:e] > 0).all() and not w[e:].any() and (mask[:n] == 1).all() and not mask[n:].any()


@pytest.mark.parametrize("rng_seed", [0, 7, 2 ** 62 - 1])
@pytest.mark.parametrize("name", CASES)
def test_sample_batch_is_bitwise_jax(name, rng_seed):
    assert native_available(), "the JAX package's library builds here"
    ei, n, seeds, fanouts = _case(name)
    csr = JaxCSRGraph.from_edge_index(ei, n)
    caps = (n + 1, ei.shape[1] + n + 1)
    want = jax_native.sample_batch_native(csr.indptr, csr.indices, seeds, fanouts, *caps,
                                          rng_seed)
    got = sample_batch_native(csr.indptr, csr.indices, seeds, fanouts, *caps, rng_seed)
    _check_native_batch(want, got)
    if name == "no-in-edges":
        assert got[0].tolist()[:4] == [5, 0, 4, 2] and len(got[1]) > 4


def _jax_default(ei, n, **kw):
    """The JAX sampler with its default (C++) path and caps no batch reaches."""
    return JaxSampler(ei, n, node_cap=n + 1, edge_cap=ei.shape[1] + n + 1, **kw)


def _check_batch(jb, pb):
    k, m = pb.num_nodes, len(pb.edge_src)
    assert (jb.num_nodes, jb.num_seeds) == (k, pb.num_seeds)
    np.testing.assert_array_equal(pb.node_ids, jb.node_ids[:k])
    np.testing.assert_array_equal(pb.edge_src, jb.edge_src[:m])
    np.testing.assert_array_equal(pb.edge_dst, jb.edge_dst[:m])
    np.testing.assert_array_equal(pb.edge_weight, jb.edge_weight[:m])
    assert not jb.edge_weight[m:].any() and jb.edge_weight[:m].all()
    # the batch graph trains on the sampler's weights, as the JAX trainer does
    np.testing.assert_array_equal(build_sampled_graph(pb, "cpu").gcn_weight.numpy(),
                                  pb.edge_weight)


@pytest.mark.parametrize("shuffle", [True, False])
def test_sampler_default_is_bitwise_jax(shuffle):
    """Every batch of an epoch (a tail batch included), then single batches,
    from samplers seeded alike, both on their default path."""
    ei = _powerlaw(3000, 30000, 0)
    pool = np.random.default_rng(1).permutation(3000)[:1000]
    js = _jax_default(ei, 3000, fanouts=FANOUTS, batch_size=70, seed=7)
    ps = NeighborSampler(ei, 3000, FANOUTS, 70, seed=7)
    assert js.use_native and ps.use_native
    batches = list(zip(js.epoch(pool, shuffle=shuffle), ps.epoch(pool, shuffle=shuffle)))
    assert len(batches) == 15 and batches[-1][1].num_seeds == 1000 % 70
    for jb, pb in batches:
        _check_batch(jb, pb)
    for seeds in (np.arange(5), np.array([2999, 0, 17]), pool[:300]):
        _check_batch(js.sample(seeds), ps.sample(seeds))
    assert js.truncated_node_batches == js.truncated_edge_batches == 0
    assert js.rng.integers(2 ** 62) == ps.rng.integers(2 ** 62)


@pytest.mark.parametrize("workers", [1, 3, 16])
def test_threaded_epoch_is_bitwise_serial(workers):
    """Threads (more than the cores at 16) give the batches of workers=0, in
    order, and leave the generator where workers=0 leaves it; a short switch
    interval interleaves them often."""
    ei = _powerlaw(3000, 30000, 0)
    pool = np.arange(3000)[::2]
    serial = NeighborSampler(ei, 3000, FANOUTS, 50, seed=4)
    threaded = NeighborSampler(serial.csr, 3000, FANOUTS, 50, seed=4)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for shuffle in (True, False):
            want = list(serial.epoch(pool, shuffle=shuffle))
            got = list(threaded.epoch(pool, shuffle=shuffle, workers=workers))
            assert len(got) == len(want) == 30
            for a, b in zip(got, want):
                for f in ("node_ids", "edge_src", "edge_dst", "edge_weight"):
                    np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    finally:
        sys.setswitchinterval(interval)
    assert serial.rng.integers(2 ** 62) == threaded.rng.integers(2 ** 62)


def test_threaded_epoch_stops_early_and_raises():
    """A consumer that stops early leaves no pool thread running; a worker's
    exception reaches the consumer."""
    import threading

    ei = _powerlaw(3000, 30000, 0)
    sampler = NeighborSampler(ei, 3000, FANOUTS, 50, seed=4)
    before = threading.active_count()
    epoch = sampler.epoch(np.arange(3000), workers=4)
    next(epoch)
    epoch.close()
    assert threading.active_count() == before
    bad = np.arange(3000)
    bad[700] = 5000  # outside the graph: the wrapper refuses the batch
    with pytest.raises(ValueError, match="seeds"):
        list(sampler.epoch(bad, shuffle=False, workers=4))
    assert threading.active_count() == before


def _tree(b, fanouts):
    """b roots, each node of level h with f_h in-neighbours of its own at
    level h + 1: every draw meets a new node, so a batch of the roots
    reaches the worst-case caps exactly."""
    src, dst, level, nxt = [], [], list(range(b)), b
    for f in fanouts:
        new = []
        for v in level:
            for _ in range(f):
                src.append(nxt)
                dst.append(v)
                new.append(nxt)
                nxt += 1
        level = new
    return np.array([src, dst]), nxt


def _complete(n):
    a, c = np.meshgrid(np.arange(n), np.arange(n))
    return np.stack([a.ravel(), c.ravel()])


@pytest.mark.parametrize("graph", ["tree", "complete", "star"])
def test_worst_case_caps_are_reached_without_truncating(graph):
    if graph == "tree":
        fanouts, seeds = (3, 2, 2), np.arange(7)
        ei, n = _tree(7, fanouts)
    elif graph == "complete":  # every fanout above the degree, clamped at 64
        n, fanouts, seeds = 50, (70, 70), np.array([3, 1])
        ei = _complete(n)
    else:  # a hub with every leaf as its in-neighbour, each leaf with the hub
        n, fanouts, seeds = 400, (10, 10), np.array([0])
        leaves = np.arange(1, n)
        ei = np.stack([np.concatenate([leaves, np.zeros(n - 1, int)]),
                       np.concatenate([np.zeros(n - 1, int), leaves])])
    node_cap, edge_cap = worst_case_caps(len(seeds), fanouts, n)
    csr = CSRGraph.from_edge_index(ei, n)
    got = sample_batch_native(csr.indptr, csr.indices, seeds, fanouts, node_cap, edge_cap, 5)
    want = jax_native.sample_batch_native(csr.indptr, csr.indices, seeds, fanouts, node_cap,
                                          edge_cap, 5)
    _check_native_batch(want, got)
    batch = NeighborSampler(csr, n, fanouts, len(seeds)).sample(seeds)
    if graph == "tree":
        # 7 + 21 + 42 + 84 nodes; 21 + 42 + 84 sampled edges and a self-loop a node
        assert (batch.num_nodes, len(batch.edge_src)) == (node_cap, edge_cap) == (154, 301)
    elif graph == "complete":
        assert (batch.num_nodes, len(batch.edge_src)) == (n, 2 * 50 + 48 * 50 + n)
        assert node_cap == n
    else:
        assert batch.num_nodes == 11 and len(batch.edge_src) == 10 + 10 + 11


@pytest.mark.parametrize("short", ["node", "edge"])
def test_a_truncated_batch_is_refused(monkeypatch, short):
    fanouts, seeds = (3, 2, 2), np.arange(7)
    ei, n = _tree(7, fanouts)
    node_cap, edge_cap = worst_case_caps(len(seeds), fanouts, n)
    caps = (node_cap - 1, edge_cap) if short == "node" else (node_cap, edge_cap - 1)
    monkeypatch.setattr(neighbor, "worst_case_caps", lambda *a: caps)
    with pytest.raises(RuntimeError, match="truncated"):
        NeighborSampler(ei, n, fanouts, 7).sample(seeds)


@pytest.mark.parametrize("fault", ["compile-error", "no-compiler"])
def test_a_failed_build_raises(monkeypatch, tmp_path, fault):
    """No numpy fallback: the sampler raises with the compiler's error, and
    it does not sample on the numpy path instead."""
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setenv("SGFORMER_CACHE_DIR", str(tmp_path / "cache"))
    if fault == "compile-error":
        broken = tmp_path / "graph_kernels.cpp"
        shutil.copy(build.SOURCE, broken)
        with open(broken, "a") as f:
            f.write("\nthis is not C++;\n")
        monkeypatch.setattr(build, "SOURCE", str(broken))
        match = "(?s)build failed.*error"
    else:
        monkeypatch.setattr(shutil, "which", lambda name: None)
        match = "g\\+\\+ not found"
    ei, n, seeds, fanouts = _case("low-degree")
    sampler = NeighborSampler(ei, n, fanouts, 60, seed=0)
    state = sampler.rng.bit_generator.state
    monkeypatch.setattr(sampler, "_sample_numpy", lambda *a: pytest.fail("numpy fallback"))
    with pytest.raises(RuntimeError, match=match):
        sampler.sample(seeds)
    if fault == "compile-error":  # the failed build left no library behind
        assert not os.listdir(tmp_path / "cache" / "native")
    # the generator moved by the one seed draw only
    rng = np.random.default_rng(0)
    rng.bit_generator.state = state
    rng.integers(2 ** 62)
    assert rng.bit_generator.state == sampler.rng.bit_generator.state


def test_fit_matches_jax_on_the_cpp_path(problem):  # noqa: F811
    """Two epochs of 400 train seeds in batches of 120 (a tail of 40) with
    their valid and test sweeps, both trainers on their default C++ path;
    then the port's fit with ``sampler_workers=2``, bitwise the same."""
    ds, edges, split = problem
    jmodel, variables = _variables(ds, edges)
    jt, jl = _jax_fit(ds, edges, split, jmodel, variables, native=True)
    model, state = _port_state(variables)
    pt, pl = _port_fit(ds, edges, split, model, state, native=True)
    assert pt.sampler.use_native and len(jt.losses) == len(pt.train_losses) == 8
    np.testing.assert_allclose(pt.train_losses, jt.losses, rtol=1e-5)
    assert pl.results == jl.results
    _check_state(pt.final_state, jt.last_state, 8)
    threaded, tl = _port_fit(ds, edges, split, model, state, native=True, sampler_workers=2)
    assert threaded.config.sampler_workers == 2
    assert threaded.train_losses == pt.train_losses and tl.results == pl.results
    for k, v in pt.final_state.items():
        assert torch.equal(threaded.final_state[k], v), k


# -- the hop sampler -----------------------------------------------------------------


@pytest.mark.parametrize("rng_seed", [0, 7, 2 ** 62 - 1])
@pytest.mark.parametrize("name", CASES)
def test_hop_sampler_is_bitwise_jax(name, rng_seed):
    """One hop from the seeds at each of the case's fanouts."""
    assert native_available(), "the JAX package's library builds here"
    ei, n, seeds, fanouts = _case(name)
    csr = JaxCSRGraph.from_edge_index(ei, n)
    for fanout in fanouts:
        want = jax_native.sample_neighbors_native(csr.indptr, csr.indices, seeds, fanout,
                                                  rng_seed)
        got = sample_neighbors_native(csr.indptr, csr.indices, seeds, fanout, rng_seed)
        for g, w in zip(got, want):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shuffle", [True, False])
def test_hop_path_is_bitwise_jax_with_its_library(shuffle):
    """``use_native=False`` in both packages, the JAX library loaded (its hop
    sampler then runs in C++): every batch of an epoch, then single batches.
    The JAX numpy body draws other batches, so the check tells them apart."""
    assert native_available(), "the JAX package's library builds here"
    ei = _powerlaw(3000, 30000, 0)
    pool = np.random.default_rng(1).permutation(3000)[:1000]
    js = _jax_sampler(ei, 3000, fanouts=FANOUTS, batch_size=70, seed=7)
    ps = NeighborSampler(ei, 3000, FANOUTS, 70, seed=7, use_native=False)
    batches = list(zip(js.epoch(pool, shuffle=shuffle), ps.epoch(pool, shuffle=shuffle)))
    assert len(batches) == 15 and batches[-1][1].num_seeds == 1000 % 70
    for jb, pb in batches:
        _check_hop_batch(jb, pb)
    for seeds in (np.arange(5), np.array([2999, 0, 17]), pool[:300]):
        _check_hop_batch(js.sample(seeds), ps.sample(seeds))
    hop = NeighborSampler(ei, 3000, FANOUTS, 70, seed=7, use_native=False).sample(pool[:300])
    with pytest.MonkeyPatch.context() as m:
        m.setattr(neighbor, "_sample_neighbors", neighbor._sample_neighbors_plain)
        plain = NeighborSampler(ei, 3000, FANOUTS, 70, seed=7,
                                use_native=False).sample(pool[:300])
    assert not np.array_equal(plain.node_ids, hop.node_ids)


def test_a_failed_build_raises_on_the_hop_path(monkeypatch):
    """No numpy fallback on the hop path either; ``native_available`` then
    says False."""
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(neighbor, "_sample_neighbors_plain",
                        lambda *a: pytest.fail("numpy fallback"))
    ei, n, seeds, fanouts = _case("low-degree")
    sampler = NeighborSampler(ei, n, fanouts, 60, seed=0, use_native=False)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        sampler.sample(seeds)
    assert not port_native_available()


def test_native_available_builds_the_library():
    assert port_native_available() and build.library() is not None
