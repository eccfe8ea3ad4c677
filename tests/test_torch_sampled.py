"""The port's sampled tier against the JAX package's, on the CPU: the host
CSR, the neighbour sampler's batches (bitwise, draw for draw), the prefetch
iterator, the out-of-core CSR build, the feature store, each batch's graph
and ``SampledTrainer.fit``.

Here both packages sample on their numpy paths (the port's C++ samplers,
the full-batch default and the hop sampler of ``use_native=False``, are held
to the JAX ones in ``test_torch_native.py``): every port sampler and trainer
here has ``use_native=False``. Two things keep the JAX package on its numpy
path: its C++ sampler would run whenever its library loads (the hop sampler
even with ``use_native=False``), so the ``numpy_sampler`` fixture patches
``sample_neighbors_native`` to return None, and swaps the port's hop
``_sample_neighbors`` for its plain version, the JAX numpy body; every JAX
sampler here has ``use_native=False``; and its static caps are set above
anything a batch can reach (``node_cap`` one more than the graph's nodes,
``edge_cap`` above its edges plus one self-loop a node). The port samples
uncapped.

The fits start from the same flax variables (``load_flax_variables``; the
JAX trainer's ``init`` returns them) and draw the same batches from one
numpy seed; dropout is 0, lr 1e-3. Only summation order differs: per-batch
losses within 1e-5 relative, final parameters within 1e-4 (but for the
biases whose exact gradient is 0, see ``_NOISE_DRIVEN``), the logger's
accuracies equal.
"""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import sgformer_tpu.native.api as jax_native
from sgformer_tpu.data.feature_store import FeatureStore as JaxFeatureStore
from sgformer_tpu.data.loaders import synthetic_dataset as jax_synthetic_dataset
from sgformer_tpu.data.prep import build_undirected_csr as jax_build_undirected_csr
from sgformer_tpu.data.prep import csr_to_edge_index as jax_csr_to_edge_index
from sgformer_tpu.data.prep import load_csr as jax_load_csr
from sgformer_tpu.graph import add_self_loops as jax_add_self_loops
from sgformer_tpu.graph import preprocess_graph as jax_preprocess_graph
from sgformer_tpu.graph import remove_self_loops as jax_remove_self_loops
from sgformer_tpu.graph import to_undirected as jax_to_undirected
from sgformer_tpu.nn import SGFormer as JaxSGFormer
from sgformer_tpu.nn import SGFormerConfig as JaxConfig
from sgformer_tpu.sample.neighbor import CSRGraph as JaxCSRGraph
from sgformer_tpu.sample.neighbor import NeighborSampler as JaxSampler
from sgformer_tpu.train.sampled_trainer import SampledTrainConfig as JaxSampledConfig
from sgformer_tpu.train.sampled_trainer import SampledTrainer as JaxSampledTrainer

from sgformer_tpu_torch import SGFormer, SGFormerConfig, load_flax_variables
from sgformer_tpu_torch.data.feature_store import FeatureStore
from sgformer_tpu_torch.data.prep import build_undirected_csr, csr_to_edge_index, load_csr
from sgformer_tpu_torch.sample import CSRGraph, NeighborSampler, PrefetchIterator, neighbor
from sgformer_tpu_torch.train import SampledTrainConfig, SampledTrainer, build_sampled_graph

torch.set_num_threads(1)

N, F, C, HIDDEN = 800, 12, 4, 32
FANOUTS = (6, 4, 2)
CFG = dict(trans_num_layers=1, gnn_num_layers=3, graph_weight=0.8, gnn_use_init=True,
           gnn_dropout=0.0, trans_dropout=0.0)
TRAIN = dict(lr=1e-3, trans_weight_decay=1e-3, gnn_weight_decay=1e-5, epochs=2,
             batch_size=120, fanouts=FANOUTS, display_step=-1, seed=3)


def _edges(ei, n):
    """The JAX CLI's sampled-tier edge list: symmetrised, self-loops
    replaced."""
    return jax_add_self_loops(jax_remove_self_loops(jax_to_undirected(ei)), n)


@pytest.fixture
def numpy_sampler(monkeypatch):
    """Both hop samplers on their numpy bodies: the JAX C++ hop sampler
    declines, and the port's hop is its plain version."""
    monkeypatch.setattr(jax_native, "sample_neighbors_native", lambda *a, **k: None)
    monkeypatch.setattr(neighbor, "_sample_neighbors", neighbor._sample_neighbors_plain)


def _jax_sampler(edges, n, **kw):
    """A JAX sampler on its numpy path with caps no batch reaches."""
    return JaxSampler(edges, n, node_cap=n + 1, edge_cap=edges.shape[1] + n + 1,
                      use_native=False, **kw)


@pytest.fixture(scope="module")
def problem():
    ds = jax_synthetic_dataset(num_nodes=N, num_edges=4000, num_features=F, num_classes=C,
                               powerlaw=1.1, seed=4)
    split = ds.get_idx_split(rng=np.random.default_rng(0))
    return ds, _edges(ds.graph["edge_index"], N), split


@pytest.fixture(scope="module")
def hub_edges():
    """A power-law graph whose hubs hold more in-edges than the hub segment
    length (128), and the seeds of a batch that reaches them."""
    ds = jax_synthetic_dataset(num_nodes=3000, num_edges=30000, num_features=4,
                               num_classes=3, powerlaw=1.1, seed=0)
    e = _edges(ds.graph["edge_index"], 3000)
    assert np.bincount(e[1]).max() > 3 * 128
    return e


def _check_batch(jb, pb):
    """A port batch against the JAX batch's real rows and edges, weights
    from the port's graph built on CPU tensors."""
    k, m = pb.num_nodes, len(pb.edge_src)
    assert (jb.num_nodes, jb.num_seeds) == (k, pb.num_seeds)
    assert pb.node_ids.dtype == np.int64 and pb.edge_src.dtype == pb.edge_dst.dtype == np.int32
    np.testing.assert_array_equal(pb.node_ids, jb.node_ids[:k])
    np.testing.assert_array_equal(pb.edge_src, jb.edge_src[:m])
    np.testing.assert_array_equal(pb.edge_dst, jb.edge_dst[:m])
    assert not jb.edge_weight[m:].any() and jb.edge_weight[:m].all()  # the rest is padding
    g = build_sampled_graph(pb, "cpu")
    np.testing.assert_array_equal(g.gcn_weight.numpy(), jb.edge_weight[:m])


@pytest.mark.parametrize("as_tensor", [False, True])
def test_csr_graph_is_bitwise_jax(hub_edges, as_tensor):
    rng = np.random.default_rng(5)
    for ei, n in ((hub_edges, 3000), (rng.integers(0, 90, (2, 700)).astype(np.int32), 100)):
        want = JaxCSRGraph.from_edge_index(ei, n)
        got = CSRGraph.from_edge_index(torch.from_numpy(ei) if as_tensor else ei, n)
        for name in ("indptr", "indices"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert got.num_nodes == n


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("graph", ["powerlaw", "hubs"])
def test_sampler_batches_are_bitwise_jax(numpy_sampler, problem, hub_edges, graph, shuffle):
    """Every batch of an epoch (a tail batch included), then single batches
    of other seeds, from samplers seeded alike."""
    edges, n = (problem[1], N) if graph == "powerlaw" else (hub_edges, 3000)
    pool = np.random.default_rng(1).permutation(n)[:n // 3]
    js = _jax_sampler(edges, n, fanouts=FANOUTS, batch_size=70, seed=7)
    ps = NeighborSampler(edges, n, FANOUTS, 70, seed=7, use_native=False)
    batches = list(zip(js.epoch(pool, shuffle=shuffle), ps.epoch(pool, shuffle=shuffle)))
    assert len(batches) == -(-len(pool) // 70) and batches[-1][1].num_seeds == len(pool) % 70
    for jb, pb in batches:
        _check_batch(jb, pb)
    for seeds in (np.arange(5), np.array([n - 1, 0, 17]), pool[:300]):
        _check_batch(js.sample(seeds), ps.sample(seeds))
    assert js.truncated_node_batches == js.truncated_edge_batches == 0


def test_seeds_without_in_edges(numpy_sampler):
    """A seed with no in-edge (and no self-loop in the graph) samples
    nothing: its batch holds it with its self-loop alone; a batch of such
    seeds stops after the first hop."""
    ei = np.array([[1, 2, 3, 4, 2], [0, 0, 1, 1, 3]])  # nodes 2, 4, 5 receive nothing
    for seeds in (np.array([0, 2]), np.array([5, 4])):
        js = _jax_sampler(ei, 6, fanouts=(2, 2), batch_size=2, seed=0)
        pb = NeighborSampler(ei, 6, (2, 2), 2, seed=0, use_native=False).sample(seeds)
        _check_batch(js.sample(seeds), pb)
    assert pb.num_nodes == 2 and pb.edge_src.tolist() == [0, 1] == pb.edge_dst.tolist()


def test_epoch_refuses_workers(problem):
    sampler = NeighborSampler(problem[1], N, FANOUTS, 50, use_native=False)
    with pytest.raises(ValueError, match="workers"):
        next(sampler.epoch(np.arange(100), workers=2))


def test_prefetch_iterator_order_bound_and_errors():
    made = []

    def items(k, fail_at=None):
        for i in range(k):
            if i == fail_at:
                raise KeyError("producer failed")
            made.append(i)
            yield i

    it = PrefetchIterator(items(10), depth=2)
    first = next(it)
    it.thread.join(timeout=0.5)
    # one item taken, two queued, one made and waiting for room
    assert first == 0 and len(made) == 4 and it.thread.is_alive()
    assert [first, *it] == list(range(10))
    with pytest.raises(StopIteration):
        next(it)
    it = PrefetchIterator(items(10, fail_at=3), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(KeyError, match="producer failed"):
        next(it)
    made.clear()
    with PrefetchIterator(items(1000), depth=2) as it:
        next(it)
    assert not it.thread.is_alive() and len(made) < 10


@pytest.mark.parametrize("chunk_edges,num_buckets,add_loops",
                         [(10 ** 6, 4, True), (97, 4, True), (64, 300, True), (50, 7, False)])
def test_out_of_core_csr_is_bitwise_jax(tmp_path, chunk_edges, num_buckets, add_loops):
    """Chunks smaller than E, more buckets than nodes, input with self-loops
    and duplicate edges, the edge list from an .npy file."""
    rng = np.random.default_rng(9)
    n = 120
    ei = rng.integers(0, n, (2, 900))
    ei[:, :40] = ei[0, :40]  # self-loops
    ei = np.concatenate([ei, ei[:, 100:160]], axis=1)  # duplicates
    np.save(tmp_path / "edges.npy", ei)
    kw = dict(chunk_edges=chunk_edges, num_buckets=num_buckets, add_loops=add_loops)
    jax_build_undirected_csr(str(tmp_path / "edges.npy"), n, str(tmp_path / "jax"), **kw)
    assert build_undirected_csr(str(tmp_path / "edges.npy"), n, str(tmp_path / "port"),
                                **kw) == str(tmp_path / "port")
    for name in ("csr_meta.json", "csr_indptr.npy", "csr_indices.bin"):
        with open(tmp_path / "jax" / name, "rb") as a, open(tmp_path / "port" / name, "rb") as b:
            assert a.read() == b.read(), name
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for in_ram in (True, False):
        want, got = jax_load_csr(str(tmp_path / "jax"), in_ram), load_csr(str(tmp_path / "port"),
                                                                          in_ram)
        assert isinstance(got, CSRGraph)
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(np.asarray(got.indices), np.asarray(want.indices))
        np.testing.assert_array_equal(csr_to_edge_index(got), jax_csr_to_edge_index(want))
    if add_loops:  # the in-RAM pipeline's CSR, as the JAX package's tests hold it
        want = JaxCSRGraph.from_edge_index(_edges(ei, n), n)
        np.testing.assert_array_equal(load_csr(str(tmp_path / "port")).indices, want.indices)
    with pytest.raises(ValueError, match=r"\[2, E\]"):
        build_undirected_csr(ei[:1], n, str(tmp_path / "bad"))


def test_feature_store_reads_and_writes_the_jax_bytes(tmp_path):
    x = np.random.default_rng(2).standard_normal((60, 9)).astype(np.float32)
    x[0, :3] = [1 + 2 ** -8, 1 + 3 * 2 ** -9, -0.0]  # bf16 ties and a signed zero
    idx = np.array([5, 0, 59, 5])
    for dtype, port_dtype in ((np.float32, np.float32), (ml_dtypes.bfloat16, torch.bfloat16)):
        name = np.dtype(dtype).name
        want = JaxFeatureStore.create(str(tmp_path / f"jax_{name}"), x, dtype)
        # the JAX file read by the port, and the port's file byte for byte
        got = FeatureStore(str(tmp_path / f"jax_{name}"), x.shape, port_dtype)
        made = FeatureStore.create(str(tmp_path / f"port_{name}"), x, port_dtype)
        with open(tmp_path / f"jax_{name}", "rb") as a, open(tmp_path / f"port_{name}", "rb") as b:
            assert a.read() == b.read()
        for store in (got, made):
            rows = store[idx]
            assert rows.dtype == (torch.float32 if dtype == np.float32 else torch.bfloat16)
            np.testing.assert_array_equal(rows.float().numpy(),
                                          np.asarray(want[idx], dtype=np.float32))
            assert len(store) == 60 and store.ndim == 2
    np.save(tmp_path / "x.npy", x)
    np.testing.assert_array_equal(FeatureStore.from_npy(str(tmp_path / "x.npy"))[idx].numpy(),
                                  x[idx])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        FeatureStore.create(str(tmp_path / "bad"), x, np.float16)


def test_sampled_graph_carries_the_transposed_csr(numpy_sampler, hub_edges):
    """The batch graph on CPU tensors: the sampler's edges as given, the GCN
    weights, row pointers, the transposed CSR sorted stably by source, and
    hub plans of 128-edge runs of every longer row of A and A^T. The seeds are
    the largest hub's neighbours, so that many of them sample it."""
    hub = np.bincount(hub_edges[1]).argmax()
    seeds = np.unique(hub_edges[0][hub_edges[1] == hub])
    batch = NeighborSampler(hub_edges, 3000, FANOUTS, len(seeds), seed=1,
                            use_native=False).sample(seeds)
    g = build_sampled_graph(batch, "cpu")
    assert (g.num_nodes, g.num_edges, g.symmetric) == (batch.num_nodes, len(batch.edge_src),
                                                         False)
    np.testing.assert_array_equal(g.edge_src.numpy(), batch.edge_src)
    np.testing.assert_array_equal(g.edge_dst.numpy(), batch.edge_dst)
    np.testing.assert_array_equal(g.indptr.numpy(), np.searchsorted(
        batch.edge_dst, np.arange(g.num_nodes + 1)))
    deg = np.bincount(batch.edge_dst, minlength=g.num_nodes).astype(np.float64)
    dinv = 1.0 / np.sqrt(deg)
    np.testing.assert_array_equal(g.gcn_weight.numpy(), (dinv[batch.edge_dst]
                                                         * dinv[batch.edge_src]).astype(np.float32))
    order = np.argsort(batch.edge_src, kind="stable")
    np.testing.assert_array_equal(g.t_perm.numpy(), order)
    np.testing.assert_array_equal(g.t_edge_src.numpy(), batch.edge_dst[order])
    np.testing.assert_array_equal(g.t_edge_dst.numpy(), batch.edge_src[order])
    np.testing.assert_array_equal(g.t_weight.numpy(), g.gcn_weight.numpy()[order])
    for plan, indptr in ((g.hub_segments, g.indptr), (g.t_hub_segments, g.t_indptr)):
        indptr = indptr.numpy()
        want = [(r, b, min(b + 128, indptr[r + 1])) for r in range(len(indptr) - 1)
                if indptr[r + 1] - indptr[r] > 128 for b in range(indptr[r], indptr[r + 1], 128)]
        np.testing.assert_array_equal(plan.numpy(), np.array(want, np.int32).reshape(-1, 3))
    # a row of A holds at most max(fanouts) sampled edges and its self-loop;
    # a source sampled by many parents is a long row of A^T
    assert g.hub_segments.shape[0] == 0 and g.t_hub_segments.shape[0] > 0


# -- fit --------------------------------------------------------------------


class _PinnedInit:
    """The JAX model whose ``init`` returns the given variables."""

    def __init__(self, model, variables):
        self.model, self.variables, self.config = model, variables, model.config

    def init(self, *args, **kwargs):
        return self.variables

    def apply(self, *args, **kwargs):
        return self.model.apply(*args, **kwargs)


class _RecordingJaxTrainer(JaxSampledTrainer):
    """The JAX trainer, recording each step's loss and the last state."""

    losses: list
    last_state: dict

    def _steps(self, tx):
        train_step, eval_step = super()._steps(tx)

        def recorded(*args):
            state, opt_state, loss = train_step(*args)
            self.losses.append(float(loss))
            self.last_state = jax.tree.map(np.asarray, state)
            return state, opt_state, loss

        return recorded, eval_step


def _variables(ds, edges):
    model = JaxSGFormer(JaxConfig.papers100m(HIDDEN, C, **CFG))
    g = jax_preprocess_graph(edges, N, undirected=False, self_loops=False)
    variables = jax.jit(lambda r, x, g: model.init({"params": r}, x, g, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(ds.graph["node_feat"]), g)
    # random BatchNorm statistics, so that no identity hides a mapping error
    rng = np.random.default_rng(6)
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32),
                         variables["batch_stats"])
    return model, {"params": variables["params"], "batch_stats": stats}


def _port_state(variables):
    model = SGFormer(SGFormerConfig.papers100m(HIDDEN, C, **CFG), F, device="cpu")
    load_flax_variables(model, jax.tree.map(np.asarray, variables))
    return model, {k: v.clone() for k, v in model.state_dict().items()}


def _jax_fit(ds, edges, split, model, variables, native=False, **kw):
    """The JAX trainer's fit on its numpy path (``native``: its default C++
    path) with caps no batch reaches."""
    cfg = JaxSampledConfig(**{**TRAIN, **kw}, node_cap=N + 1, edge_cap=edges.shape[1] + N + 1)
    trainer = _RecordingJaxTrainer(_PinnedInit(model, variables), edges, ds.graph["node_feat"],
                                   ds.label, cfg)
    trainer.sampler.use_native = native
    trainer.sampler.rng = np.random.default_rng(11)
    trainer.losses = []
    logger = trainer.fit([split])
    assert trainer.sampler.truncated_node_batches == trainer.sampler.truncated_edge_batches == 0
    return trainer, logger


def _port_fit(ds, edges, split, model, state, native=False, **kw):
    """The port's fit on its numpy path (``native``: its default C++ path)."""
    trainer = SampledTrainer(model, edges, ds.graph["node_feat"], ds.label,
                             SampledTrainConfig(**{**TRAIN, **kw}), device="cpu")
    trainer.sampler.use_native = native
    trainer.record_losses = True
    logger = trainer.fit([split], np_rng=np.random.default_rng(11), init_state=state)
    return trainer, logger


# the biases that feed a train-mode BatchNorm, and those norms' running
# means: the batch mean takes any shift out, so the exact gradient of such a
# bias is 0 and each package's is rounding noise, which Adam normalises into
# steps of up to lr. They are held to lr a step (the running means average
# the biases' values); every other parameter and statistic to 1e-4.
_NOISE_DRIVEN = {"graph_conv.fc_in.bias", "graph_conv.bn_in.running_mean",
                 *(f"graph_conv.conv_{i}.W.bias" for i in range(3)),
                 *(f"graph_conv.bn_{i}.running_mean" for i in range(3))}


def _check_state(got: dict, jax_state: dict, steps: int):
    _, want = _port_state({"params": jax_state["params"], "batch_stats": jax_state["batch_stats"]})
    assert got.keys() == want.keys() and _NOISE_DRIVEN <= want.keys()
    for k, v in want.items():
        tol = dict(rtol=0, atol=TRAIN["lr"] * steps) if k in _NOISE_DRIVEN else dict(
            rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **tol)


@pytest.mark.parametrize("eval_train", [False, True])
def test_fit_matches_jax(numpy_sampler, problem, eval_train):
    """Two epochs of 400 train seeds in batches of 120 (a tail of 40), each
    with its valid and test sweeps (and the train sweep with
    ``eval_train``)."""
    ds, edges, split = problem
    jmodel, variables = _variables(ds, edges)
    jt, jl = _jax_fit(ds, edges, split, jmodel, variables, eval_train=eval_train)
    model, state = _port_state(variables)
    pt, pl = _port_fit(ds, edges, split, model, state, eval_train=eval_train)
    assert len(split["train"]) == 400 and len(jt.losses) == len(pt.train_losses) == 8
    np.testing.assert_allclose(pt.train_losses, jt.losses, rtol=1e-5)
    assert pl.results == jl.results
    assert (np.array(pl.results[0])[:, 0] > 0).all() == eval_train
    _check_state(pt.final_state, jt.last_state, 8)
    _check_state(pt.best_state, jax.tree.map(np.asarray, jt.best_state), 8)


def test_use_pretrained_restores_the_parameters_only(numpy_sampler, problem, tmp_path):
    """``save_model`` writes the best-on-valid state; a run with
    ``use_pretrained`` starts from its parameters with the BatchNorm
    statistics it drew itself, as the JAX trainer does: its losses match the
    JAX finetune run's, and with no epoch its state is the saved parameters
    beside the initial statistics."""
    ds, edges, split = problem
    jmodel, variables = _variables(ds, edges)
    model, state = _port_state(variables)
    for d in ("jax", "port"):
        kw = dict(save_model=True, model_dir=str(tmp_path / d))
        fit = _jax_fit if d == "jax" else _port_fit
        fit(ds, edges, split, *((jmodel, variables) if d == "jax" else (model, state)), **kw)
    kw = dict(use_pretrained=True, epochs=1, lr=1e-4)
    jt, _ = _jax_fit(ds, edges, split, jmodel, variables, model_dir=str(tmp_path / "jax"), **kw)
    pt, _ = _port_fit(ds, edges, split, model, state, model_dir=str(tmp_path / "port"), **kw)
    assert len(pt.train_losses) == len(jt.losses) == 4
    np.testing.assert_allclose(pt.train_losses, jt.losses, rtol=1e-5)

    saved = torch.load(tmp_path / "port" / "model.pt", weights_only=True)
    assert saved["step"] == TRAIN["epochs"]
    pt, _ = _port_fit(ds, edges, split, model, state, model_dir=str(tmp_path / "port"),
                      use_pretrained=True, epochs=0)
    params = dict(model.named_parameters())
    for k, v in pt.final_state.items():
        want = saved["model"][k] if k in params else state[k]
        assert torch.equal(v, want), k
    assert any(not torch.equal(saved["model"][k], state[k]) for k in state if k not in params)


def test_transfer_type_follows_the_model(problem, tmp_path):
    """'auto' sends bf16 rows to a bf16 model, as ml_dtypes rounds them; a
    bf16 store's rows pass uncast; an unknown type is refused."""
    ds, edges, _ = problem
    x = ds.graph["node_feat"]
    ids = np.array([3, 1, 799])
    for compute, want in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        model = SGFormer(SGFormerConfig.papers100m(HIDDEN, C, compute_dtype=compute), F,
                         device="cpu")
        trainer = SampledTrainer(model, edges, x, ds.label, SampledTrainConfig(), device="cpu")
        rows = trainer.gather_x(ids)
        assert rows.dtype == want
        expect = x[ids].astype(ml_dtypes.bfloat16).astype(np.float32) if compute == "bf16" \
            else x[ids]
        np.testing.assert_array_equal(rows.float().numpy(), expect)
    store = FeatureStore.create(str(tmp_path / "x16"), x, torch.bfloat16)
    trainer = SampledTrainer(model, CSRGraph.from_edge_index(edges, N), store, ds.label,
                             SampledTrainConfig(), device="cpu")
    assert trainer.gather_x(ids).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="transfer_dtype"):
        SampledTrainer(model, edges, x, ds.label, SampledTrainConfig(transfer_dtype="f16"),
                       device="cpu")
