"""The port's serving hand-off on the CPU: ``Predictor.export_artifact``,
``load_exported`` and the flat ``export_leaves``; the forward kernels as
``torch.library`` custom ops; ``Graph`` as flat tensors; the kernel build
directory's cache rule; and ``TrainConfig.rng_impl``.

- The exported program, called with the bundle's ``arr_*`` tensors and
  mapped by its ``inv_perm``, gives ``Predictor.logits()`` within 1e-6 (the
  JAX package's own round-trip tolerance, ``tests/test_serve.py``); the
  JAX ``export_artifact``/``load_exported`` on the CPU and the port's
  exported call on the same weights (``load_flax_variables``) agree within
  2e-4 in f32 (summation order only, as ``tests/test_torch_serve.py``).
- The exported graph holds one op node for each kernel launch a card
  forward makes: 3 ``csr_spmm`` and the attention reduce and apply for
  SGFormer, 3 ``quantize_absmax`` and 3 ``csr_spmm_q8_apply`` in their
  place on an int8 graph, 2 ``csr_spmm_ev`` for GAT; so the same program
  on the card runs the kernels.
- ``torch.library.opcheck`` holds each op's schema, fake implementation and
  CPU implementation together.
"""

import os

import jax
import numpy as np
import pytest
import torch

from sgformer_tpu.data.loaders import synthetic_dataset as jax_synthetic_dataset
from sgformer_tpu.graph import preprocess_graph as jax_preprocess_graph
from sgformer_tpu.nn import SGFormer as JaxSGFormer
from sgformer_tpu.nn import SGFormerConfig as JaxConfig
from sgformer_tpu.serve import Predictor as JaxPredictor
from sgformer_tpu.serve import load_exported as jax_load_exported
from sgformer_tpu.train import TrainConfig as JaxTrainConfig
from sgformer_tpu.train import Trainer as JaxTrainer

from sgformer_tpu_torch import (Predictor, SGFormer, SGFormerConfig, load_exported,
                                preprocess_graph)
from sgformer_tpu_torch.data import synthetic_dataset
from sgformer_tpu_torch.graph import graph_from_leaves, graph_leaves
from sgformer_tpu_torch.kernels import _build, ops
from sgformer_tpu_torch.kernels.attention import reduce_plain
from sgformer_tpu_torch.nn import GAT
from sgformer_tpu_torch.ops.spmm import quantize_absmax
from sgformer_tpu_torch.train import TrainConfig, Trainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(gnn_num_layers=3, trans_dropout=0.0, gnn_dropout=0.0)
NO_OPS = dict.fromkeys(ops.OPS, 0)
SGFORMER_OPS = dict(NO_OPS, csr_spmm=3, linear_attention_reduce=1, linear_attention_apply=1)
# each kind: (model config, preprocess_graph options, op nodes of its forward)
KINDS = {
    "sgformer-f32": ("f32", {}, SGFORMER_OPS),
    "sgformer-bf16": ("bf16", {}, SGFORMER_OPS),
    "sgformer-int8": ("bf16", dict(chunk_dtype="bf16", slab_dtype="int8"),
                      dict(SGFORMER_OPS, csr_spmm=0, quantize_absmax=3, csr_spmm_q8_apply=3)),
    "gat": (None, dict(chunk_dtype="bf16"), dict(NO_OPS, csr_spmm_ev=2)),
}


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(num_nodes=300, num_edges=2400, num_features=16, num_classes=4,
                             seed=3, device="cpu")


def _predictor(ds, kind):
    dtype, graph_options, _ = KINDS[kind]
    gen = torch.Generator().manual_seed(0)
    if dtype is None:
        model = GAT(16, 32, 4, heads=2, generator=gen, device="cpu")
    else:
        model = SGFormer(SGFormerConfig.large(32, 4, compute_dtype=dtype, **CFG), 16,
                         generator=gen, device="cpu")
    graph = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, device="cpu",
                             **graph_options)
    return Predictor(model, graph, ds.graph["node_feat"], device="cpu").compile()


def _bundle_leaves(path):
    bundle = np.load(path + ".inputs.npz")
    names = sorted((f for f in bundle.files if f.startswith("arr_")),
                   key=lambda f: int(f.split("_")[1]))
    return [torch.from_numpy(bundle[f]) for f in names], bundle["inv_perm"]


@pytest.mark.parametrize("kind", list(KINDS))
def test_exported_bundle_serves_the_predictors_logits(ds, tmp_path, kind):
    pred = _predictor(ds, kind)
    want = pred.logits()
    path = str(tmp_path / "forward.pt2")
    assert pred.export_artifact(path, include_inputs=True) == path
    program = load_exported(path)
    leaves, inv_perm = _bundle_leaves(path)
    np.testing.assert_array_equal(inv_perm, np.arange(ds.num_nodes))
    assert len(leaves) == len(pred.export_leaves())
    for got, leaf in zip(leaves, pred.export_leaves()):
        assert torch.equal(got, leaf)
    with torch.no_grad():
        from_bundle = program.module()(*leaves).numpy()[inv_perm]
        from_leaves = program.module()(*pred.export_leaves()).numpy()
    assert from_bundle.shape == want.shape and from_bundle.dtype == np.float32
    np.testing.assert_allclose(from_bundle, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(from_leaves, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", list(KINDS))
def test_exported_graph_calls_each_kernel_as_its_op(ds, tmp_path, kind):
    path = _predictor(ds, kind).export_artifact(str(tmp_path / "forward.pt2"))
    assert ops.op_calls(load_exported(path)) == KINDS[kind][2]


def test_export_takes_the_weights_as_inputs(ds, tmp_path):
    """Another checkpoint of the same config runs through the same artifact:
    its weights are leaves, not constants of the program."""
    pred = _predictor(ds, "sgformer-f32")
    program = load_exported(pred.export_artifact(str(tmp_path / "forward.pt2")))
    assert not program.state_dict
    other = _predictor(ds, "sgformer-f32")
    with torch.no_grad():
        for p in other.model.parameters():
            p.add_(0.01)
        got = program.module()(*other.export_leaves()).numpy()
    np.testing.assert_allclose(got, other.logits(), rtol=1e-6, atol=1e-6)
    assert not np.allclose(got, pred.logits(), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def jax_trained():
    jds = jax_synthetic_dataset(num_nodes=300, num_edges=2400, num_features=16,
                                num_classes=4, seed=3)
    graph = jax_preprocess_graph(jds.graph["edge_index"], jds.num_nodes)
    model = JaxSGFormer(JaxConfig.large(32, 4, **CFG))
    trainer = JaxTrainer(model, graph, jds.graph["node_feat"], jds.label,
                         JaxTrainConfig(lr=0.01, epochs=5, eval_step=5, display_step=-1))
    trainer.fit([jds.get_idx_split(rng=np.random.default_rng(0))])
    return jds, graph, model, jax.tree.map(np.asarray, trainer.final_state)


def test_exported_forward_matches_the_jax_export(jax_trained, tmp_path):
    jds, graph, model, state = jax_trained
    jax_path = str(tmp_path / "sgformer.jaxexport")
    jax_pred = JaxPredictor(model, graph, jds.graph["node_feat"], state)
    jax_pred.export_artifact(jax_path)
    want = np.asarray(jax_load_exported(jax_path).call(*jax_pred.export_leaves()))

    port_model = SGFormer(SGFormerConfig.large(32, 4, **CFG), 16, device="cpu")
    port_graph = preprocess_graph(jds.graph["edge_index"], jds.num_nodes, device="cpu")
    pred = Predictor(port_model, port_graph, jds.graph["node_feat"], state=state, device="cpu")
    program = load_exported(pred.export_artifact(str(tmp_path / "sgformer.pt2")))
    with torch.no_grad():
        got = program.module()(*pred.export_leaves()).numpy()
    assert got.shape == want.shape == (300, 4)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _op_args(ds):
    g = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, device="cpu",
                         chunk_dtype="bf16", slab_dtype="int8")
    n = g.num_nodes
    gen = torch.Generator().manual_seed(0)
    csr = (g.indptr, g.edge_src, g.edge_dst, g.gcn_weight)
    plan = (g.hub_segments, g.hub_edges)
    x = torch.randn(n, 8, generator=gen)
    q, s = quantize_absmax(x, g.rs)
    heads = torch.randn(3, n, 2, 8, generator=gen)  # strided per-head views
    qh, kh, vh = heads[0, :, 0], heads[1, :, 0], heads[2, :, 1]
    kvs, ksum, scal = reduce_plain(qh, kh, vh, True)
    return {
        "csr_spmm": (x, *csr, *plan),
        "csr_spmm_ev": (torch.randn(n, 2, 8, generator=gen).bfloat16(), *csr[:3],
                        torch.rand(g.num_edges, 2, generator=gen), torch.float32, *plan),
        "quantize_absmax": (x, g.rs),
        "csr_spmm_q8_apply": (q, s, x.bfloat16(), *csr, g.rs, torch.bfloat16, None, None),
        "linear_attention_reduce": (qh, kh, vh, False),
        "linear_attention_apply": (qh, vh, kvs, ksum, scal, torch.tensor(float(n)), True),
    }


@pytest.mark.parametrize("name", list(ops.OPS))
def test_opcheck_on_the_cpu(ds, name):
    torch.library.opcheck(ops.OPS[name], _op_args(ds)[name])


@pytest.mark.parametrize("options", [{}, dict(undirected=False, with_pyg_norm=True),
                                     dict(chunk_dtype="bf16", slab_dtype="int8")])
def test_graph_leaves_rebuild_the_graph(ds, options):
    g = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, device="cpu", **options)
    leaves, spec = graph_leaves(g)
    assert all(isinstance(t, torch.Tensor) for t in leaves)
    again = graph_from_leaves(leaves, spec)
    for name, value in vars(g).items():
        other = getattr(again, name)
        if isinstance(value, torch.Tensor):
            assert other is value
        else:
            assert other == value
    with pytest.raises(ValueError, match="tensors"):
        graph_from_leaves(leaves[:-1], spec)


def test_cache_dir_moves_the_kernel_build(monkeypatch, tmp_path):
    monkeypatch.delenv("SGFORMER_CACHE_DIR", raising=False)
    src, default = _build._target("spmm")
    assert os.path.dirname(default) == os.path.join(REPO, "build", "kernels")
    assert _build.build_dir() == os.path.join(REPO, "build", "kernels")
    lib = os.path.basename(default)
    monkeypatch.setenv("SGFORMER_CACHE_DIR", "")
    assert _build._target("spmm") == (src, default)
    monkeypatch.setenv("SGFORMER_CACHE_DIR", str(tmp_path / "env"))
    assert _build._target("spmm") == (src, os.path.join(str(tmp_path / "env"), "kernels", lib))
    # an explicit directory comes before the environment's
    assert _build._target("spmm", str(tmp_path / "arg")) == (
        src, os.path.join(str(tmp_path / "arg"), "kernels", lib))


def _trajectory(ds, rng_impl):
    model = SGFormer(SGFormerConfig.large(32, 4, gnn_num_layers=2, trans_dropout=0.3,
                                          gnn_dropout=0.3), 16, device="cpu")
    graph = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, device="cpu")
    trainer = Trainer(model, graph, ds.graph["node_feat"], ds.label,
                      TrainConfig(lr=0.01, rng_impl=rng_impl), device="cpu")
    idx = trainer.prepare_train_idx(ds.get_idx_split(rng=np.random.default_rng(0)))
    trainer.init_state(0)
    losses = trainer.multi_step(idx, 4)
    return losses, trainer.model.state_dict()


@pytest.mark.parametrize("rng_impl", ["threefry2x32", "rbg", "unsafe_rbg"])
def test_rng_impl_leaves_training_unchanged(ds, rng_impl):
    """The JAX package's choice of bit generator is accepted and ignored: a
    trajectory with dropout draws the same masks under every value."""
    losses, state = _trajectory(ds, "auto")
    other_losses, other_state = _trajectory(ds, rng_impl)
    assert torch.equal(losses, other_losses)
    assert all(torch.equal(state[k], other_state[k]) for k in state)
