"""The port's graph-transformer zoo (DIFFormer, NodeFormer, GraphGPS,
GraphTrans, Graphormer) against the JAX package's on the CPU, the flax
variables (randomised) carried across by ``load_flax_variables``:

- eval logits within 1e-5 of the largest; one train-mode loss (dropout 0)
  at 1e-5 and every parameter's gradient against ``jax.value_and_grad`` at
  1e-4 (``check_grads``: and 1e-4 of the model's largest gradient, for the
  parameters whose gradient vanishes);
- NodeFormer with ``use_gumbel=False`` and the JAX eval projection (JAX's
  ``PRNGKey(0)`` draw) set, link losses included; its Gumbel path with the
  JAX uniforms passed in, and a layer against a numpy transcription of the
  Gumbel attention on the same uniforms;
- GraphGPS in train-mode BatchNorm; Graphormer with ``q_noise=0`` and
  ``layerdrop=0`` and each of its options, LayerDrop and quantisation noise
  checked statistically (as ``tests/test_graph_transformers.py`` does);
- the host preprocessing (``build_nodeformer_adjs``, ``graphormer_inputs``,
  ``collate_graphs``) bitwise the JAX package's;
- the full-graph trainer with NodeFormer: the first loss, the lamda term
  included, against the JAX ``Trainer``'s at 1e-5.

f32 throughout: only the summation order differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_numpy as ref
from test_torch_attention_variants import check_grads
from test_torch_modules import _randomize

from sgformer_tpu.graph import preprocess_graph as jax_preprocess_graph
from sgformer_tpu.nn import DIFFormer as JaxDIFFormer
from sgformer_tpu.nn import GraphGPS as JaxGraphGPS
from sgformer_tpu.nn import Graphormer as JaxGraphormer
from sgformer_tpu.nn import GraphTrans as JaxGraphTrans
from sgformer_tpu.nn import NodeFormer as JaxNodeFormer
from sgformer_tpu.nn import build_nodeformer_adjs as jax_build_nodeformer_adjs
from sgformer_tpu.nn import graphormer_inputs as jax_graphormer_inputs
from sgformer_tpu.nn.graphormer import collate_graphs as jax_collate_graphs
from sgformer_tpu.ops.attention_variants import create_projection_matrix as jax_projection

from sgformer_tpu_torch import load_flax_variables, preprocess_graph
from sgformer_tpu_torch.nn import (
    DIFFormer,
    GraphGPS,
    Graphormer,
    GraphTrans,
    NodeFormer,
    build_nodeformer_adjs,
    build_nodeformer_graphs,
    collate_graphs,
    graphormer_inputs,
    inputs_to,
)
from sgformer_tpu_torch.nn.graphormer import LayerDrop, QuantNoiseLinear
from sgformer_tpu_torch.nn.nodeformer import NodeFormerConv
from sgformer_tpu_torch.train import TrainConfig, Trainer

torch.set_num_threads(1)

N, F, C, H = 50, 10, 4, 16
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(12)
    edge_index = ref.random_graph(rng, N, 250)
    x = rng.standard_normal((N, F)).astype(np.float32)
    label = rng.integers(0, C, N)
    jg = jax_preprocess_graph(edge_index, N, with_pyg_norm=True)
    g = preprocess_graph(edge_index, N, with_pyg_norm=True, device="cpu")
    jadjs = jax_build_nodeformer_adjs(edge_index, N, rb_order=2)
    adjs = build_nodeformer_graphs(edge_index, N, rb_order=2, device="cpu")
    jin = jax_graphormer_inputs(edge_index, (x > 0).astype(np.int64), N)
    aet = np.zeros((N, N, 2), dtype=np.int64)  # per-pair edge types, 0 = none
    src, dst = edge_index
    aet[src, dst, 0] = 1 + (np.arange(len(src)) % 7)
    aet[dst, src, 1] = 1 + (np.arange(len(src)) % 5)
    jin_edges = dict(jin, attn_edge_type=aet)
    return dict(edge_index=edge_index, x=x, label=label, jg=jg, g=g, jadjs=jadjs, adjs=adjs,
                jin=jin, jin_edges=jin_edges)


def _eval_projection(d, m=30):
    """The JAX NodeFormerConv's projection without a 'performer' rng:
    the first half of PRNGKey(0)."""
    pkey, _ = jax.random.split(jax.random.PRNGKey(0))
    return torch.from_numpy(np.asarray(jax_projection(m, d, pkey)))


def _set_eval_projection(model, d):
    for mod in model.modules():
        if isinstance(mod, NodeFormerConv):
            mod.eval_projection.copy_(_eval_projection(d))


# name -> (flax module, the port's module, JAX call kwargs, port call kwargs)
def _models(p, name):
    ins = inputs_to(p["jin"], "cpu")
    ins_e = inputs_to(p["jin_edges"], "cpu")
    nf = dict(num_layers=2, num_heads=2, rb_order=2, use_gumbel=False, dropout=0.0)
    gf = dict(embed_dim=H, num_layers=2, num_heads=2)
    make = {
        "difformer-simple": lambda: (
            JaxDIFFormer(H, C, num_layers=2, num_heads=2, dropout=0.0),
            DIFFormer(F, H, C, num_layers=2, num_heads=2, dropout=0.0, **CPU), {}, {}),
        "difformer-sigmoid": lambda: (
            JaxDIFFormer(H, C, kernel="sigmoid", graph_weight=0.5, use_source=True,
                         dropout=0.0),
            DIFFormer(F, H, C, kernel="sigmoid", graph_weight=0.5, use_source=True, dropout=0.0,
                      **CPU), {}, {}),
        "nodeformer": lambda: (
            JaxNodeFormer(H, C, **nf), NodeFormer(F, H, C, **nf, **CPU),
            dict(adjs=p["jadjs"]), dict(adjs=p["adjs"])),
        "nodeformer-jk-identity": lambda: (
            JaxNodeFormer(H, C, **dict(nf, rb_trans="identity"), use_jk=True, use_act=True,
                          tau=0.5),
            NodeFormer(F, H, C, **dict(nf, rb_trans="identity"), use_jk=True, use_act=True,
                       tau=0.5, **CPU), dict(adjs=p["jadjs"]), dict(adjs=p["adjs"])),
        "graphgps": lambda: (
            JaxGraphGPS(H, C, num_layers=2, num_heads=2, dropout=0.0),
            GraphGPS(F, H, C, num_layers=2, num_heads=2, dropout=0.0, **CPU), {}, {}),
        "graphtrans": lambda: (
            JaxGraphTrans(H, C, gnn_emb_dim=H, d_model=H, num_trans_layers=2, num_trans_head=2,
                          dim_feedforward=32, dropout=0.0, trans_dropout=0.0),
            GraphTrans(F, H, C, gnn_emb_dim=H, d_model=H, num_trans_layers=2, num_trans_head=2,
                       dim_feedforward=32, dropout=0.0, trans_dropout=0.0, **CPU), {}, {}),
        "graphormer": lambda: (
            JaxGraphormer(C, **gf), Graphormer(F, C, **gf, **CPU),
            dict(inputs=p["jin"]), dict(inputs=ins)),
        "graphormer-no-token": lambda: (
            JaxGraphormer(C, **gf, use_graph_token=False),
            Graphormer(F, C, **gf, use_graph_token=False, **CPU),
            dict(inputs=p["jin"]), dict(inputs=ins)),
        "graphormer-edge-bias-virtual-distance": lambda: (
            JaxGraphormer(C, **gf, use_edge_bias=True, use_virtual_distance=True),
            Graphormer(F, C, **gf, use_edge_bias=True, use_virtual_distance=True, **CPU),
            dict(inputs=p["jin_edges"]), dict(inputs=ins_e)),
        "graphormer-embed-out-ffn": lambda: (
            JaxGraphormer(C, **gf, use_embed_out=True, ffn_dim=24),
            Graphormer(F, C, **gf, use_embed_out=True, ffn_dim=24, **CPU),
            dict(inputs=p["jin"]), dict(inputs=ins)),
    }
    return make[name]()


NAMES = ["difformer-simple", "difformer-sigmoid", "nodeformer", "nodeformer-jk-identity",
         "graphgps", "graphtrans", "graphormer", "graphormer-no-token",
         "graphormer-edge-bias-virtual-distance", "graphormer-embed-out-ffn"]


def _logits(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("name", NAMES)
def test_zoo_eval_logits_and_train_loss_and_gradients_match_jax(problem, name):
    p = problem
    jmodel, model, jkw, kw = _models(p, name)
    x = jnp.asarray(p["x"])
    init = jmodel.init(jax.random.PRNGKey(0), x, p["jg"], train=False, **jkw)
    variables = _randomize(init, 3)
    if "batch_stats" in init:
        # a randomised projection is no projection: GPS keeps its draw
        variables["batch_stats"] = _with_projections(variables["batch_stats"],
                                                     init["batch_stats"])
    load_flax_variables(model, jax.tree.map(np.asarray, variables))
    if name.startswith("nodeformer"):
        _set_eval_projection(model, H)

    # eval logits
    want = np.asarray(_logits(jmodel.apply(variables, x, p["jg"], train=False, **jkw)))
    model.eval()
    xt = torch.from_numpy(p["x"])
    got = _logits(model(xt, p["g"], **kw)).detach().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    # one train-mode loss and its gradients, dropout 0 (JAX's NodeFormer,
    # given no 'performer' rng, draws its projection from PRNGKey(0) in
    # train mode too: the port gets the same one passed in)
    train_idx, label = np.arange(0, N, 2), p["label"]

    def loss_of(out, mean_link):
        logits, link = out if isinstance(out, tuple) else (out, [])
        logp = (jax.nn.log_softmax(logits, axis=-1) if isinstance(logits, jax.Array)
                else torch.log_softmax(logits, dim=-1))
        loss = -logp[train_idx, label[train_idx]].mean()
        return loss - 0.5 * mean_link(link) if link else loss

    def jloss(params):
        out, _ = jmodel.apply({**variables, "params": params}, x, p["jg"], train=True,
                              rngs={"dropout": jax.random.PRNGKey(1)},
                              mutable=["batch_stats"], **jkw)
        return loss_of(out, lambda ls: sum(ls) / len(ls))

    want_loss, grads = jax.value_and_grad(jloss)(variables["params"])
    model.train()
    model.set_dropout_generator(torch.Generator().manual_seed(0))
    if name.startswith("nodeformer"):
        kw = dict(kw, draws=[(_eval_projection(H), None)] * 2)
    loss = loss_of(model(xt, p["g"], **kw), lambda ls: sum(ls) / len(ls))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    check_grads(model, grads)


def _with_projections(rand, init):
    """``rand`` with every ``projection`` leaf taken from ``init``."""
    return {k: _with_projections(rand[k], init[k]) if hasattr(rand[k], "items")
            else (init[k] if k == "projection" else rand[k]) for k in rand}


def test_nodeformer_gumbel_path_with_the_jax_uniforms_matches_jax(problem):
    """use_gumbel=True in train mode: JAX, given no 'performer' rng, draws
    its uniforms from the second half of PRNGKey(0); the port takes them."""
    p = problem
    kw = dict(num_layers=2, num_heads=2, rb_order=2, nb_gumbel_sample=3, dropout=0.0)
    jmodel, model = JaxNodeFormer(H, C, **kw), NodeFormer(F, H, C, **kw, **CPU)
    x = jnp.asarray(p["x"])
    variables = _randomize(jmodel.init(jax.random.PRNGKey(0), x, p["jg"], adjs=p["jadjs"]), 4)
    load_flax_variables(model, jax.tree.map(np.asarray, variables))
    want, wlinks = jmodel.apply(variables, x, p["jg"], train=True, adjs=p["jadjs"],
                                rngs={"dropout": jax.random.PRNGKey(1)})
    _, gkey = jax.random.split(jax.random.PRNGKey(0))
    u = torch.from_numpy(np.asarray(jax.random.uniform(gkey, (N, 2, 3), minval=1e-20,
                                                       maxval=1.0)))
    model.train()
    got, links = model(torch.from_numpy(p["x"]), p["g"], adjs=p["adjs"],
                       draws=[(_eval_projection(H), u)] * 2)
    want = np.asarray(want)
    assert np.abs(got.detach().numpy() - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose([float(v) for v in links], [float(v) for v in wlinks],
                               rtol=1e-5)


def _np_kernel_features(data, is_query, proj, eps=1e-6):
    d = data.shape[-1]
    data = data / np.sqrt(np.sqrt(d))
    dd = np.einsum("nhd,md->nhm", data, proj)
    diag = (data ** 2).sum(-1, keepdims=True) / 2.0
    stab = dd.max(axis=-1, keepdims=True) if is_query else dd.max(axis=(-1, -3), keepdims=True)
    return (np.exp(dd - diag - stab) + eps) / np.sqrt(proj.shape[0])


def test_nodeformer_gumbel_layer_matches_a_numpy_transcription():
    """One layer's Gumbel attention (no relational bias, no edge loss), in
    f64 numpy from the layer's weights and the same projection and
    uniforms."""
    rng = np.random.default_rng(9)
    n, h, d, k, tau = 30, 2, 8, 4, 0.25
    conv = NodeFormerConv(12, d, num_heads=h, nb_random_features=10, nb_gumbel_sample=k,
                          rb_order=0, use_edge_loss=False)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    for lin in (conv.Wq, conv.Wk, conv.Wv, conv.Wo):
        lin.reset_parameters(torch.Generator().manual_seed(int(rng.integers(1 << 30))))
    z = rng.standard_normal((n, 12)).astype(np.float32)
    proj = rng.standard_normal((10, d)).astype(np.float32)
    u = rng.uniform(1e-20, 1.0, (n, h, k)).astype(np.float32)
    conv.train()
    got, ll = conv(torch.from_numpy(z), [], tau, draws=(torch.from_numpy(proj),
                                                         torch.from_numpy(u)))
    assert ll is None

    def lin(mod, a):
        return a @ mod.weight.detach().double().numpy().T + mod.bias.detach().double().numpy()

    zd = z.astype(np.float64)
    q, kk, v = (lin(m, zd).reshape(n, h, d) for m in (conv.Wq, conv.Wk, conv.Wv))
    qp = _np_kernel_features(q / np.sqrt(tau), True, proj.astype(np.float64))
    kp = _np_kernel_features(kk / np.sqrt(tau), False, proj.astype(np.float64))
    gumbels = -np.log(-np.log(u.astype(np.float64))) / tau
    k_g = kp[:, :, None, :] * np.exp(gumbels)[..., None]
    num = np.einsum("nhm,hkmd->nhkd", qp, np.einsum("nhkm,nhd->hkmd", k_g, v))
    den = np.einsum("nhm,hkm->nhk", qp, k_g.sum(0))[..., None]
    want = lin(conv.Wo, (num / den).mean(2).reshape(n, h * d))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)


def test_nodeformer_draws_come_from_its_generator(problem):
    p = problem
    model = NodeFormer(F, H, C, num_heads=2, dropout=0.0, **CPU).train()
    with pytest.raises(RuntimeError, match="Generator"):
        model(torch.from_numpy(p["x"]), p["g"], adjs=p["adjs"])

    def run(seed):
        model.set_dropout_generator(torch.Generator().manual_seed(seed))
        return model(torch.from_numpy(p["x"]), p["g"], adjs=p["adjs"])[0].detach()

    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    model.eval()
    a = model(torch.from_numpy(p["x"]), p["g"], adjs=p["adjs"])[0]
    b = model(torch.from_numpy(p["x"]), p["g"], adjs=p["adjs"])[0]
    assert torch.equal(a, b)
    # the fixed eval projection is no state: a state dict carries none
    assert not any("projection" in k for k in model.state_dict())


def test_nodeformer_without_adjs_uses_the_graphs_edges(problem):
    p = problem
    kw = dict(num_layers=1, num_heads=2, rb_order=2, use_gumbel=False, dropout=0.0)
    jmodel, model = JaxNodeFormer(H, C, **kw), NodeFormer(F, H, C, **kw, **CPU)
    x = jnp.asarray(p["x"])
    variables = _randomize(jmodel.init(jax.random.PRNGKey(0), x, p["jg"]), 6)
    # one adjacency: the JAX layer's b is [1, H]; the port uses b's first row
    want, _ = jmodel.apply(variables, x, p["jg"])
    params = jax.tree.map(np.asarray, variables["params"])
    b1 = params["conv_0"]["b"]
    params["conv_0"]["b"] = np.concatenate([b1, np.zeros_like(b1)])
    load_flax_variables(model, {"params": params})
    _set_eval_projection(model, H)
    got, _ = model.eval()(torch.from_numpy(p["x"]), p["g"])
    want = np.asarray(want)
    assert np.abs(got.detach().numpy() - want).max() <= 1e-5 * np.abs(want).max()


# -- host preprocessing, bitwise ---------------------------------------------------


@pytest.mark.parametrize("rb_order", [1, 2, 3])
def test_build_nodeformer_adjs_is_bitwise_jax(problem, rb_order):
    # duplicates and self-loops: kept and replaced as the JAX function does
    ei = np.concatenate([problem["edge_index"], [[3, 3, 7], [3, 9, 9]]], axis=1)
    want = jax_build_nodeformer_adjs(ei, N, rb_order=rb_order)
    got = build_nodeformer_adjs(ei, N, rb_order=rb_order)
    assert len(got) == len(want) == rb_order
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    graphs = build_nodeformer_graphs(ei, N, rb_order=rb_order, device="cpu")
    for a, gr in zip(got, graphs):
        order = np.argsort(a[1], kind="stable")
        src, dst = a[0][order], a[1][order]
        np.testing.assert_array_equal(gr.edge_src.numpy(), src)
        np.testing.assert_array_equal(gr.edge_dst.numpy(), dst)
        d_in = np.maximum(np.bincount(dst, minlength=N), 1).astype(np.float32)
        w = 1.0 / np.sqrt(d_in[dst]) / np.sqrt(d_in[src])
        np.testing.assert_allclose(gr.gcn_weight.numpy(), w, rtol=1e-6)
        assert not gr.symmetric and gr.t_indptr is not None


@pytest.mark.parametrize("spatial", ["bfs", "random"])
def test_graphormer_inputs_are_bitwise_jax(problem, spatial):
    p = problem
    feat = (p["x"] > 0).astype(np.int64)
    want = jax_graphormer_inputs(p["edge_index"], feat, N, spatial=spatial, seed=1)
    got = graphormer_inputs(p["edge_index"], feat, N, spatial=spatial, seed=1)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype


def _two_graphs():
    rng = np.random.default_rng(3)
    n1, n2 = 20, 13
    e1, e2 = ref.random_graph(rng, n1, 60), ref.random_graph(rng, n2, 40)
    f1 = (rng.standard_normal((n1, F)) > 0).astype(np.int64)
    f2 = (rng.standard_normal((n2, F)) > 0).astype(np.int64)
    return [graphormer_inputs(e1, f1, n1), graphormer_inputs(e2, f2, n2)], n2


@pytest.mark.parametrize("max_nodes", [None, 24])
def test_collate_graphs_is_bitwise_jax(max_nodes):
    graphs, _ = _two_graphs()
    want = jax_collate_graphs(graphs, max_nodes=max_nodes)
    got = collate_graphs(graphs, max_nodes=max_nodes)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="max_nodes"):
        collate_graphs(graphs, max_nodes=15)


def test_graphormer_collated_batch_matches_jax_and_the_unpadded_graph():
    graphs, n2 = _two_graphs()
    batch = collate_graphs(graphs)
    jmodel = JaxGraphormer(C, embed_dim=32, num_layers=2, num_heads=2)
    model = Graphormer(F, C, embed_dim=32, num_layers=2, num_heads=2, **CPU).eval()
    variables = _randomize(jmodel.init(jax.random.PRNGKey(0), None, None, inputs=batch), 2)
    want = np.asarray(jmodel.apply(variables, None, None, inputs=batch))
    load_flax_variables(model, jax.tree.map(np.asarray, variables))
    got = model(inputs=inputs_to(batch, "cpu")).detach().numpy()
    assert got.shape == want.shape == (2, 20, C)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    solo = model(inputs=inputs_to(collate_graphs([graphs[1]]), "cpu")).detach().numpy()
    np.testing.assert_allclose(got[1, :n2], solo[0], rtol=2e-4, atol=2e-5)


# -- Graphormer's regularisers, statistically -------------------------------------


def test_graphormer_layerdrop_and_quant_noise_leave_eval_alone(problem):
    ins = inputs_to(problem["jin"], "cpu")
    base = Graphormer(F, C, embed_dim=32, num_layers=2, num_heads=2, **CPU).eval()
    reg = Graphormer(F, C, embed_dim=32, num_layers=2, num_heads=2, layerdrop=0.5, q_noise=0.3,
                     qn_block_size=8, **CPU)
    reg.load_state_dict(base.state_dict())
    assert torch.equal(base(inputs=ins), reg.eval()(inputs=ins))
    reg.train()
    outs = []
    for seed in (0, 1):
        reg.set_dropout_generator(torch.Generator().manual_seed(seed))
        outs.append(reg(inputs=ins).detach())
    assert not torch.allclose(outs[0], outs[1])
    assert all(torch.isfinite(o).all() for o in outs)


def test_layerdrop_keeps_each_layer_with_one_minus_its_rate():
    drop = LayerDrop(0.3, 4)
    assert drop.eval()() is None
    drop.train().generator = torch.Generator().manual_seed(0)
    keep = torch.stack([drop() for _ in range(4000)]).float()
    assert keep.shape == (4000, 4)
    assert abs(keep.mean().item() - 0.7) < 0.02
    assert LayerDrop(0.0, 4).train()() is None


def test_quant_noise_drops_blocks_and_rescales_the_rest():
    p, block = 0.25, 8
    lin = QuantNoiseLinear(64, 48, p=p, block_size=block)
    lin.reset_parameters(torch.Generator().manual_seed(0))
    eye = torch.eye(64)
    with torch.no_grad():
        assert torch.equal(lin.eval()(eye) - lin.bias, lin.kernel)
        lin.train().generator = torch.Generator().manual_seed(1)
        dropped = []
        for _ in range(50):
            eff = (lin(eye) - lin.bias).reshape(64 // block, block, 48)
            ker = lin.kernel.reshape(64 // block, block, 48)
            zero = (eff == 0).all(dim=1)  # [blocks, out]: whole blocks go
            kept = ~zero
            torch.testing.assert_close(eff.permute(0, 2, 1)[kept],
                                       (ker / (1 - p)).permute(0, 2, 1)[kept])
            dropped.append(zero.float().mean().item())
    assert abs(np.mean(dropped) - p) < 0.02
    with pytest.raises(ValueError, match="qn_block_size"):
        QuantNoiseLinear(12, 4, p=0.5, block_size=8).train()(torch.ones(1, 12))


# -- the trainer ---------------------------------------------------------------------


def test_trainer_first_loss_with_the_link_losses_matches_jax(problem, monkeypatch):
    """NodeFormer behind both trainers, lamda 0.5: the JAX trainer draws a
    train projection from its per-step 'performer' key and the port from
    its generator; both are pinned to one matrix here."""
    from sgformer_tpu.nn import nodeformer as jax_nodeformer
    from sgformer_tpu.train import TrainConfig as JaxTrainConfig
    from sgformer_tpu.train import Trainer as JaxTrainer

    from sgformer_tpu_torch.nn import nodeformer as port_nodeformer

    p = problem
    proj = _eval_projection(H)
    monkeypatch.setattr(jax_nodeformer, "create_projection_matrix",
                        lambda m, d, key: jnp.asarray(proj.numpy()))
    monkeypatch.setattr(port_nodeformer, "create_projection_matrix",
                        lambda m, d, generator: proj.clone())
    kw = dict(num_layers=2, num_heads=2, rb_order=2, use_gumbel=False, dropout=0.0)
    label = p["label"].reshape(-1, 1)
    tc = dict(lr=0.01, epochs=2, lamda=0.5)
    jtrainer = JaxTrainer(JaxNodeFormer(H, C, **kw), p["jg"], p["x"], label,
                          JaxTrainConfig(**tc), model_kwargs={"adjs": p["jadjs"]})
    state, tx, _ = jtrainer.init_state(jax.random.PRNGKey(0))
    split = {"train": np.arange(0, N, 2), "valid": np.arange(1, N, 4),
             "test": np.arange(3, N, 4)}
    train_idx = jtrainer._prepare_train_idx(split)
    jloss, _ = jtrainer._make_loss_fn()(state["params"], state["batch_stats"],
                                        jax.random.PRNGKey(1), train_idx, jtrainer.x,
                                        jtrainer.graph)
    want_logits = np.asarray(jtrainer._build_steps(tx)[1](state))

    trainer = Trainer(NodeFormer(F, H, C, **kw, **CPU), p["g"], p["x"], label,
                      TrainConfig(**tc), model_kwargs={"adjs": p["adjs"]}, device="cpu")
    trainer.init_state(0)
    load_flax_variables(trainer.model, jax.tree.map(np.asarray, state))
    _set_eval_projection(trainer.model, H)
    loss = trainer.loss(trainer.prepare_train_idx(split)).item()
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    # the eval step returns the logits alone
    got = trainer.eval_step().numpy()
    assert got.shape == (N, C)
    assert np.abs(got - want_logits).max() <= 1e-5 * np.abs(want_logits).max()


PORT_ONLY = {
    "difformer": lambda **kw: DIFFormer(F, H, C, **CPU, **kw),
    "nodeformer": lambda **kw: NodeFormer(F, H, C, num_heads=2, **CPU, **kw),
    "graphgps": lambda **kw: GraphGPS(F, H, C, num_heads=2, **CPU, **kw),
    "graphtrans": lambda **kw: GraphTrans(F, H, C, gnn_emb_dim=H, d_model=H, **CPU, **kw),
    "graphormer": lambda **kw: Graphormer(F, C, embed_dim=H, num_heads=2, layerdrop=0.1,
                                          q_noise=0.1, use_virtual_distance=True,
                                          use_embed_out=True, **CPU, **kw),
}


@pytest.mark.parametrize("name", sorted(PORT_ONLY))
def test_zoo_reset_parameters_redraws_what_a_new_model_draws(name):
    """A zoo model reset from a generator seeded s equals one built from a
    generator seeded s, and every train-mode draw (dropout, NodeFormer's
    projections, LayerDrop, quantisation noise) comes from the generator
    set last."""
    from sgformer_tpu_torch.nn.layers import Draws

    model = PORT_ONLY[name]()
    for p in model.parameters():
        p.data.add_(1.0)
    model.reset_parameters(torch.Generator().manual_seed(11))
    fresh = PORT_ONLY[name](generator=torch.Generator().manual_seed(11))
    got, want = model.state_dict(), fresh.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    gen = torch.Generator().manual_seed(2)
    model.set_dropout_generator(gen)
    draws = [m for m in model.modules() if isinstance(m, Draws)]
    assert draws and all(m.generator is gen for m in draws)
