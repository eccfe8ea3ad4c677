"""The CSR kernels' walk order (``Graph.schedule``): the clustering reorder's
permutation of the rows, built once per graph by ``preprocess_graph``, that
``csr_spmm`` and ``csr_spmm_ev`` walk their rows in so that the rows they
gather stay in the card's L2. The nodes keep their labels and each row is
written in place, summed edge for edge as in node order, so the result does
not depend on it: on the CPU the wrappers check it and run their plain
versions. Here: the order is a permutation, deterministic and the JAX
package's clustering; a ``reorder=True`` graph and the batch tiers' graphs
take none; it survives ``Graph.to``, the export leaves and an exported
forward; a bad one is refused where the graph is built; a numpy emulation of
the kernel's walk (persistent walkers over the order, rows in place, hub
rows in segments) gives the plain sum bitwise; and on a planted-partition
graph the order cuts the distinct source rows that a window of rows gathers.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sgformer_tpu.data.loaders import synthetic_dataset as jax_synthetic_dataset
from sgformer_tpu.graph import add_self_loops, remove_self_loops, to_undirected
from sgformer_tpu.kernels.slabs import reorder_for_slabs

from sgformer_tpu_torch import Predictor, SGFormer, SGFormerConfig, load_exported
from sgformer_tpu_torch import preprocess_graph
from sgformer_tpu_torch.data import synthetic_dataset
from sgformer_tpu_torch.graph import (gcn_norm_rs, graph_from_leaves, graph_from_sorted,
                                      graph_leaves)
from sgformer_tpu_torch.kernels.spmm import (csr_spmm, csr_spmm_ev, csr_spmm_ev_bwd,
                                             csr_spmm_q8, csr_spmm_q8_apply, hub_plan)
from sgformer_tpu_torch.native.reorder import reorder_for_clusters
from sgformer_tpu_torch.ops.spmm import quantize_absmax
from sgformer_tpu_torch.ops.spmm import spmm as spmm_plain
from sgformer_tpu_torch.ops.spmm import spmm_q8_apply

torch.set_num_threads(1)

N = 1200


@pytest.fixture(scope="module")
def community():
    """A homophilous synthetic graph, its edge list and the symmetrised,
    self-looped edges the walk order is built from."""
    ds = jax_synthetic_dataset(num_nodes=N, num_edges=9000, num_features=8, num_classes=6,
                               seed=4)
    ei = np.asarray(ds.graph["edge_index"])
    full = add_self_loops(remove_self_loops(to_undirected(ei)), N)
    return ds, ei, full


@pytest.fixture(scope="module")
def graph(community):
    _, ei, _ = community
    return preprocess_graph(ei, N, device="cpu")


@pytest.mark.parametrize("undirected", [True, False])
def test_walk_order_is_a_permutation_of_the_rows(community, undirected):
    _, ei, _ = community
    g = preprocess_graph(ei, N, undirected=undirected, with_pyg_norm=True, device="cpu")
    orders = [g.schedule] + ([] if undirected else [g.t_schedule])
    for order in orders:
        assert order.dtype == torch.int32 and order.shape == (N,) and order.is_contiguous()
        assert torch.equal(torch.sort(order).values, torch.arange(N, dtype=torch.int32))
    if undirected:  # A^T is A's own: it walks in A's order
        assert g.t_schedule is None
        assert g.walk_orders[0] is g.schedule and g.walk_orders[1] is g.schedule
    else:
        assert g.walk_orders == (g.schedule, g.t_schedule)


def test_walk_order_is_the_clustering_reorders_order(community, graph):
    """Deterministic, and the permutation ``reorder_for_clusters`` gives the
    graph's symmetrised, self-looped edges: the JAX package's clustering
    (``reorder_for_slabs`` at one slab), which relabels the nodes where the
    walk order only orders the rows."""
    _, ei, full = community
    again = preprocess_graph(ei, N, device="cpu")
    assert torch.equal(again.schedule, graph.schedule)
    perm, _ = reorder_for_clusters(full, N)
    np.testing.assert_array_equal(graph.schedule.numpy(), perm)
    np.testing.assert_array_equal(graph.schedule.numpy(),
                                  reorder_for_slabs(full, N, slab_rows=N)[0])
    # the transposed order of a directed graph clusters the transposed edges
    directed = preprocess_graph(ei, N, undirected=False, device="cpu")
    loops = add_self_loops(remove_self_loops(ei), N)
    np.testing.assert_array_equal(directed.schedule.numpy(), reorder_for_clusters(loops, N)[0])
    np.testing.assert_array_equal(directed.t_schedule.numpy(),
                                  reorder_for_clusters(loops[::-1], N)[0])


def test_graphs_without_a_walk_order(community):
    """A reordered graph (its labels already clustered) and the batch
    tiers' per-batch graphs walk in node order."""
    from sgformer_tpu_torch.sample import NeighborSampler
    from sgformer_tpu_torch.train import build_sampled_graph, build_subgraph_batch

    _, ei, _ = community
    reordered = preprocess_graph(ei, N, reorder=True, device="cpu")
    assert reordered.schedule is None and reordered.t_schedule is None
    assert reordered.walk_orders == (None, None)
    edges = torch.from_numpy(ei)
    batch = build_subgraph_batch(edges, torch.arange(0, N, 3), N)
    assert batch.schedule is None and batch.t_schedule is None
    sampled = build_sampled_graph(NeighborSampler(ei, N, (5, 3), 40, seed=0,
                                                  use_native=False).sample(np.arange(40)),
                                  "cpu")
    assert sampled.schedule is None and sampled.t_schedule is None


def test_walk_order_survives_to_and_the_export_leaves(community):
    _, ei, _ = community
    g = preprocess_graph(ei, N, undirected=False, device="cpu")
    for name in ("schedule", "t_schedule"):
        assert torch.equal(getattr(g.to("cpu"), name), getattr(g, name))
        leaves, spec = graph_leaves(g)
        assert name in spec["tensors"]
        assert torch.equal(getattr(graph_from_leaves(leaves, spec), name), getattr(g, name))


def _model():
    cfg = SGFormerConfig.large(16, 6, trans_num_layers=1, gnn_num_layers=2,
                               trans_dropout=0.0, gnn_dropout=0.0)
    return SGFormer(cfg, 8, generator=torch.Generator().manual_seed(0), device="cpu")


def test_exported_forward_with_a_walk_order_matches_predictor(community, graph, tmp_path):
    """The walk order is one of the exported program's graph leaves, and its
    forward gives ``Predictor``'s logits, which are the logits of the same
    graph without an order."""
    ds, _, _ = community
    x = np.asarray(ds.graph["node_feat"])
    pred = Predictor(_model(), graph, x, device="cpu")
    path = pred.export_artifact(str(tmp_path / "fwd.pt2"))
    got = load_exported(path).module()(*pred.export_leaves())
    np.testing.assert_array_equal(got.numpy(), pred.logits())
    unordered = Predictor(_model(), dataclasses.replace(graph, schedule=None), x, device="cpu")
    np.testing.assert_array_equal(unordered.logits(), pred.logits())


@pytest.mark.parametrize("case", ["short", "repeated", "float", "2-d", "symmetric-t"])
def test_a_bad_walk_order_is_refused_when_the_graph_is_built(graph, case):
    perm = graph.schedule.clone()
    kw = {"schedule": perm}
    if case == "short":
        kw["schedule"] = perm[:-1]
    elif case == "repeated":
        perm[5] = perm[6]
    elif case == "float":
        kw["schedule"] = perm.float()
    elif case == "2-d":
        kw["schedule"] = perm[None]
    else:
        kw = {"t_schedule": perm}
    with pytest.raises(ValueError, match="permutation|A's order"):
        graph_from_sorted(graph.edge_src, graph.edge_dst, graph.gcn_weight, N,
                          symmetric=True, **kw)
    if case == "repeated":  # the permutation itself is taken, as int32
        perm[5] = graph.schedule[5]
        built = graph_from_sorted(graph.edge_src, graph.edge_dst, graph.gcn_weight, N,
                                  symmetric=True, schedule=perm.long())
        assert built.schedule.dtype == torch.int32 and torch.equal(built.schedule, perm)


def emulate_walk(indptr, src, weight, x, order, walkers, max_edges):
    """The kernel's walk in numpy with the plain version's arithmetic (an f32
    product, then f32 adds in edge order from 0): ``walkers`` persistent
    walkers, walker j taking positions j, j + walkers, ... of ``order`` (node
    order when None) and writing row ``order[p]`` in place; a row of more
    than ``max_edges`` edges summed in segments of that many, their sums
    added in segment order (the hub pass). Returns the rows and how often
    each was written."""
    n, f = len(indptr) - 1, x.shape[1]
    order = np.arange(n) if order is None else order
    out = np.full((n, f), np.nan, np.float32)
    written = np.zeros(n, np.int64)

    def chain(b, e):
        acc = np.zeros(f, np.float32)
        for t in range(b, e):
            acc = acc + weight[t] * x[src[t]]
        return acc

    for j in range(walkers):
        for p in range(j, n, walkers):
            row = order[p]
            b, e = indptr[row], indptr[row + 1]
            if e - b <= max_edges:
                out[row] = chain(b, e)
                written[row] += 1
    for row in np.flatnonzero(np.diff(indptr) > max_edges):
        b, e = indptr[row], indptr[row + 1]
        parts = [chain(s, min(s + max_edges, e)) for s in range(b, e, max_edges)]
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        out[row] = acc
        written[row] += 1
    return out, written


def _walk_graph(graph, which):
    """The community graph with the kernel's segment length, or a power-law
    graph with rows of up to a few hundred edges, cut into segments of 16."""
    if which == "community":
        return graph, 128
    ds = synthetic_dataset(num_nodes=900, num_edges=7000, num_features=4, num_classes=5,
                           powerlaw=1.1, seed=2, device="cpu")
    g = preprocess_graph(ds.graph["edge_index"], 900, device="cpu")
    assert int(torch.diff(g.indptr).max()) > 4 * 16
    return g, 16


@pytest.mark.parametrize("which", ["community", "power-law hubs"])
def test_emulated_walk_in_the_order_gives_the_plain_sum_bitwise(community, graph, which):
    g, max_edges = _walk_graph(graph, which)
    n = g.num_nodes
    x = np.random.default_rng(1).standard_normal((n, 5)).astype(np.float32)
    args = (g.indptr.numpy(), g.edge_src.numpy(), g.gcn_weight.numpy(), x)
    want = spmm_plain(torch.from_numpy(x), g.edge_src, g.edge_dst, g.gcn_weight, n).numpy()
    node_order, _ = emulate_walk(*args, None, n, max_edges)
    for walkers in (1, 7, 64):
        got, written = emulate_walk(*args, g.schedule.numpy(), walkers, max_edges)
        assert (written == 1).all()
        np.testing.assert_array_equal(got, node_order)
        if which == "community":  # no hub row: one chain a row, the plain sum's
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def emulate_q8_walk(indptr, src, weight, q, dq, rs, x_self, order, walkers, max_edges):
    """The int8 walk in numpy: ``walkers`` persistent walkers over the
    positions of ``order``, each row written in place: the exact int32 sum
    of q over its non-self edges (in segments of ``max_edges`` edges, their
    integer partials added, for longer rows) and its self edges' weights
    added in edge order from 0 (a segment's from 0, the segments' sums in
    segment order), then the epilogue ``((acc * dq) * rs) + w_self * x_self``
    in f32, each operation rounded. Returns the f32 rows and how often each
    was written."""
    n, f = len(indptr) - 1, q.shape[1]
    out = np.full((n, f), np.nan, np.float32)
    written = np.zeros(n, np.int64)

    def walk(row, b, e):
        acc = np.zeros(f, np.int32)
        w = np.float32(0)
        for t in range(b, e):
            if src[t] == row:
                w = np.float32(w + weight[t])
            else:
                acc = acc + q[src[t]].astype(np.int32)
        return acc, w

    def finish(row, acc, w):
        t = (acc.astype(np.float32) * dq).astype(np.float32) * rs[row]
        out[row] = t + np.float32(w) * x_self[row]
        written[row] += 1

    for j in range(walkers):
        for p in range(j, n, walkers):
            row = order[p]
            b, e = indptr[row], indptr[row + 1]
            if e - b <= max_edges:
                finish(row, *walk(row, b, e))
    for row in np.flatnonzero(np.diff(indptr) > max_edges):
        b, e = indptr[row], indptr[row + 1]
        parts = [walk(row, s, min(s + max_edges, e)) for s in range(b, e, max_edges)]
        acc, w = parts[0]
        for part_acc, part_w in parts[1:]:
            acc, w = acc + part_acc, np.float32(w + part_w)
        finish(row, acc, w)
    return out, written


@pytest.mark.parametrize("which", ["community", "power-law hubs"])
def test_emulated_int8_walk_in_the_order_gives_the_plain_version_bitwise(community, graph,
                                                                           which):
    """``csr_spmm_q8``'s walk in the graph's order, emulated: integer sums in
    any order and split, the self weight in edge order, so the rows are
    ``spmm_q8_apply``'s bit for bit in f32 and in bf16, and the node-order
    walk's."""
    g, max_edges = _walk_graph(graph, which)
    n = g.num_nodes
    rs = gcn_norm_rs(g.edge_dst, n)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((n, 12)).astype(np.float32))
    q, s = quantize_absmax(x, rs)
    xb = x.to(torch.bfloat16)
    dq = np.float32(s.item()) / np.float32(127)
    args = (g.indptr.numpy(), g.edge_src.numpy(), g.gcn_weight.numpy(), q.numpy(), dq,
            rs.numpy(), xb.float().numpy())
    node_order, _ = emulate_q8_walk(*args, np.arange(n), n, max_edges)
    for walkers in (1, 7, 64):
        got, written = emulate_q8_walk(*args, g.schedule.numpy(), walkers, max_edges)
        assert (written == 1).all()
        np.testing.assert_array_equal(got, node_order)
    for dtype in (torch.float32, torch.bfloat16):
        want = spmm_q8_apply(q, s, xb, g.edge_src, g.edge_dst, g.gcn_weight, rs, n, dtype)
        assert torch.equal(torch.from_numpy(got).to(dtype), want)


def test_walk_order_keeps_a_windows_gathers_local():
    """On a planted-partition graph (20,000 nodes, 40 classes, 80 % of the
    edges inside a class, as synth-arxiv is drawn), the rows that a window
    of 2,048 consecutive positions gathers from: at least 2x fewer distinct
    ones in the walk order than in node order (2.3x here), so the warps in
    flight on the card keep fewer rows in L2."""
    ds = synthetic_dataset(num_nodes=20_000, num_edges=140_000, num_features=4, num_classes=40,
                           seed=0, device="cpu")
    g = preprocess_graph(ds.graph["edge_index"], 20_000, device="cpu")
    indptr, src = g.indptr.numpy(), g.edge_src.numpy()

    def distinct_sources(order, window=2048):
        return np.mean([np.unique(np.concatenate([src[indptr[r]:indptr[r + 1]]
                                                  for r in order[s:s + window]])).size
                        for s in range(0, len(order), window)])

    node_order = distinct_sources(np.arange(20_000))
    walk_order = distinct_sources(g.schedule.numpy())
    assert node_order >= 2.0 * walk_order, (node_order, walk_order)


def test_cpu_wrappers_check_the_walk_order_and_ignore_it(graph):
    n = graph.num_nodes
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(n, 6, generator=gen)
    csr = (graph.indptr, graph.edge_src, graph.edge_dst, graph.gcn_weight)
    plan = (graph.hub_segments, graph.hub_edges)
    assert torch.equal(csr_spmm(x, *csr, *plan, schedule=graph.schedule),
                       csr_spmm(x, *csr, *plan))
    xh = torch.randn(n, 2, 3, generator=gen)
    v = torch.rand(graph.num_edges, 2, generator=gen)
    assert torch.equal(
        csr_spmm_ev(xh, *csr[:3], v, torch.float32, *plan, schedule=graph.schedule),
        csr_spmm_ev(xh, *csr[:3], v, torch.float32, *plan))
    t_csr = (graph.t_indptr, graph.t_edge_src, graph.t_edge_dst, graph.t_perm)
    for a, b in zip(csr_spmm_ev_bwd(xh, xh, v, *t_csr, torch.float32, graph.t_hub_segments,
                                    graph.hub_edges, t_schedule=graph.walk_orders[1]),
                    csr_spmm_ev_bwd(xh, xh, v, *t_csr, torch.float32, graph.t_hub_segments,
                                    graph.hub_edges)):
        assert torch.equal(a, b)
    for bad, err in ((graph.schedule.long(), TypeError), (graph.schedule[1:], TypeError),
                     (graph.schedule.reshape(2, -1), TypeError)):
        with pytest.raises(err, match="walk order"):
            csr_spmm(x, *csr, *plan, schedule=bad)
        with pytest.raises(err, match="walk order"):
            csr_spmm_ev(xh, *csr[:3], v, torch.float32, *plan, schedule=bad)
        with pytest.raises(err, match="walk order"):
            csr_spmm_ev_bwd(xh, xh, v, *t_csr, torch.float32, graph.t_hub_segments,
                            graph.hub_edges, t_schedule=bad)
    rs = gcn_norm_rs(graph.edge_dst, n)
    q, s = quantize_absmax(x, rs)
    assert torch.equal(csr_spmm_q8(x, *csr, rs, *plan, schedule=graph.schedule),
                       csr_spmm_q8(x, *csr, rs, *plan))
    assert torch.equal(
        csr_spmm_q8_apply(q, s, x.bfloat16(), *csr, rs, torch.float32, *plan,
                          schedule=graph.schedule),
        csr_spmm_q8_apply(q, s, x.bfloat16(), *csr, rs, torch.float32, *plan))
    for bad, err in ((graph.schedule.long(), TypeError), (graph.schedule[1:], TypeError)):
        with pytest.raises(err, match="walk order"):
            csr_spmm_q8(x, *csr, rs, *plan, schedule=bad)
        with pytest.raises(err, match="walk order"):
            csr_spmm_q8_apply(q, s, x.bfloat16(), *csr, rs, torch.float32, *plan, schedule=bad)
    assert hub_plan(graph.indptr).shape == (0, 3)


@pytest.mark.parametrize("kind", ["gcn", "pyg", "edge-values", "link", "int8"])
def test_the_model_paths_take_the_walk_order_unchanged(community, kind):
    """``Graph.propagate`` (A, PyG, and A on an int8 graph),
    ``propagate_edge_values`` and LINK's aggregation run their kernels' CPU
    versions with the graph's walk orders in hand, forward and backward: the
    same values and gradients as the graph without them."""
    _, ei, _ = community
    g = preprocess_graph(ei, N, undirected=False, with_pyg_norm=True, device="cpu",
                         **(dict(chunk_dtype="bf16", slab_dtype="int8") if kind == "int8"
                            else {}))
    assert g.schedule is not None and g.t_schedule is not None
    bare = dataclasses.replace(g, schedule=None, t_schedule=None)
    gen = torch.Generator().manual_seed(5)
    outs = []
    if kind == "link":
        from sgformer_tpu_torch.nn import LINK

        for graph_ in (g, bare):
            model = LINK(N, 4, generator=torch.Generator().manual_seed(0), device="cpu")
            out = model(torch.zeros(N, 1), graph_)
            out.square().sum().backward()
            outs.append((out, model.weight.grad))
    else:
        x0 = torch.randn(N, 2, 4, generator=gen)
        v0 = torch.rand(g.num_edges, 2, generator=gen)
        for graph_ in (g, bare):
            x, v = x0.clone().requires_grad_(), v0.clone().requires_grad_()
            if kind == "edge-values":
                out = graph_.propagate_edge_values(x, v)
            else:
                out = graph_.propagate(x.reshape(N, 8), "gcn" if kind == "int8" else kind)
            out.square().sum().backward()
            outs.append((out, x.grad) + ((v.grad,) if kind == "edge-values" else ()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
