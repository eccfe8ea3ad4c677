"""The benchmark's inputs, made on the device from a seed: a planted-partition
graph with class-correlated features (a torch rewrite of the recipe of the
program's ``data/loaders.py::synthetic_dataset``, which draws on the host),
a train split, and the raw edge list both the program and the reference
start from.

Every draw comes from one ``torch.Generator`` on the device in a fixed
order, so a seed gives the same inputs on the same device, and every seed
gives the same sizes: N nodes, E directed edges, F features, C classes.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class GraphInputs:
    """Raw inputs: ``edge_index`` [2, E] int64 (src, dst), directed, with
    duplicates and self-loops as drawn; ``x`` [N, F] f32; ``label`` [N]
    int64; ``train`` [T] int64 node ids."""

    edge_index: torch.Tensor
    x: torch.Tensor
    label: torch.Tensor
    train: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])


def derive_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed for one purpose of a run's seed (any whole number)."""
    return (int(seed) * 1_000_003 + 7_919 * int(purpose)) % (2 ** 63 - 1)


def planted_partition(graph: dict, seed: int, device) -> GraphInputs:
    """The graph of ``graph`` (a configuration's ``graph`` section:
    ``num_nodes``, ``num_edges``, ``num_features``, ``num_classes``,
    ``homophily``, ``powerlaw``, ``feature_scale``, ``train_nodes``).

    Labels are uniform over the classes; each class has a centre drawn
    N(0, feature_scale^2) and a node's features are its centre plus N(0, 1)
    noise. Sources are uniform, or with ``powerlaw`` > 0 drawn from a Zipf
    popularity (k + 10)^-powerlaw shuffled over the nodes; with probability
    ``homophily`` an edge's destination is a uniform node of the source's
    class, else a uniform node. The train split is ``train_nodes`` distinct
    nodes."""
    n, e = int(graph["num_nodes"]), int(graph["num_edges"])
    f, c = int(graph["num_features"]), int(graph["num_classes"])
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, 1))
    label = torch.randint(0, c, (n,), generator=gen, device=device)
    centers = torch.randn(c, f, generator=gen, device=device) * float(graph["feature_scale"])
    x = centers[label] + torch.randn(n, f, generator=gen, device=device)
    powerlaw = float(graph.get("powerlaw", 0.0))
    if powerlaw > 0.0:
        pop = (torch.arange(1, n + 1, dtype=torch.float64, device=device) + 10.0) ** -powerlaw
        pop = pop[torch.randperm(n, generator=gen, device=device)]
        cdf = torch.cumsum(pop, 0)
        u = torch.rand(e, generator=gen, device=device, dtype=torch.float64) * cdf[-1]
        src = torch.searchsorted(cdf, u).clamp_(max=n - 1)
    else:
        src = torch.randint(0, n, (e,), generator=gen, device=device)
    same = torch.rand(e, generator=gen, device=device) < float(graph["homophily"])
    order = torch.sort(label, stable=True).indices
    counts = torch.bincount(label, minlength=c)
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    ls, le = starts[label[src]], ends[label[src]]
    pick = ls + (torch.rand(e, generator=gen, device=device, dtype=torch.float64)
                 * (le - ls)).long()
    dst_same = order[pick.clamp_(max=n - 1)]
    dst_rand = torch.randint(0, n, (e,), generator=gen, device=device)
    dst = torch.where(same, dst_same, dst_rand)
    del same, ls, le, pick, dst_same, dst_rand
    train = torch.randperm(n, generator=gen, device=device)[: int(graph["train_nodes"])]
    return GraphInputs(torch.stack([src, dst]), x, label, train)
