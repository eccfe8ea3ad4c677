"""The graph maker: sizes, seeds, the power-law sources; the traffic
generator: the same work for every seed."""

import torch

from portbench.graphgen import derive_seed, planted_partition
from portbench.traffic import request_schedule

SMALL = dict(num_nodes=3000, num_edges=20000, num_features=16, num_classes=5, train_nodes=1000,
             homophily=0.8, powerlaw=1.1, feature_scale=2.0)


def test_sizes():
    g = planted_partition(SMALL, 7, "cpu")
    assert g.edge_index.shape == (2, 20000) and g.edge_index.dtype == torch.int64
    assert g.x.shape == (3000, 16) and g.x.dtype == torch.float32
    assert g.label.shape == (3000,) and int(g.label.max()) < 5
    assert g.train.shape == (1000,) and g.train.unique().numel() == 1000
    assert int(g.edge_index.min()) >= 0 and int(g.edge_index.max()) < 3000


def test_same_seed_same_inputs_and_other_seed_other_inputs():
    big = 2 ** 31 + 12345
    a, b, c = (planted_partition(SMALL, s, "cpu") for s in (big, big, big + 1))
    for f in ("edge_index", "x", "label", "train"):
        assert torch.equal(getattr(a, f), getattr(b, f))
        assert not torch.equal(getattr(a, f), getattr(c, f))


def test_power_law_sources_have_hubs_and_uniform_ones_do_not():
    law = planted_partition(dict(SMALL, num_edges=60000), 3, "cpu")
    flat = planted_partition(dict(SMALL, num_edges=60000, powerlaw=0.0), 3, "cpu")
    top = [int(torch.bincount(g.edge_index[0], minlength=3000).max()) for g in (law, flat)]
    # Zipf 1.1 from rank 11: the top node takes ~1/(11^1.1 * 4.2) of the edges
    assert top[0] > 600 and top[1] < 60


def test_homophily_joins_classes():
    g = planted_partition(dict(SMALL, homophily=1.0, powerlaw=0.0), 1, "cpu")
    src, dst = g.edge_index
    assert torch.equal(g.label[src], g.label[dst])


def test_derived_seeds_fit_a_generator():
    for s in (0, 1, 2 ** 31 + 5, 2 ** 40):
        for p in range(6):
            torch.Generator().manual_seed(derive_seed(s, p))
    assert derive_seed(5, 1) != derive_seed(5, 2)


def test_every_seed_gets_the_same_requests_evenly_spaced_in_another_order():
    mix = {"rate_per_s": 92, "min_nodes": 1, "max_nodes": 4096}
    a = request_schedule(mix, 2 ** 31 + 5, 2.0, 1000)
    b = request_schedule(mix, 7, 2.0, 1000)
    assert len(a) == len(b) == 184
    assert [r.due_s for r in a] == [r.due_s for r in b] == [i / 92 for i in range(184)]
    sizes_a, sizes_b = [r.node_ids.size for r in a], [r.node_ids.size for r in b]
    assert sorted(sizes_a) == sorted(sizes_b) and sizes_a != sizes_b
    assert min(sizes_a) == 1 and max(sizes_a) <= 4096
    assert all(0 <= r.node_ids.min() and r.node_ids.max() < 1000 for r in a)
