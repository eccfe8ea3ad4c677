"""Synthetic datasets: the port of ``sgformer_tpu/data/loaders.py``'s
``synthetic_dataset`` and its ``synth-arxiv`` name.

The generator is plain numpy ``default_rng``, so the same seed gives the same
arrays as the JAX package's. The node features, which the model reads, are
placed on ``device``; the edge list and the labels stay numpy arrays, because
graph preprocessing and splits run on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from sgformer_tpu_torch.data.ncdataset import NCDataset
from sgformer_tpu_torch.device import resolve_device

# named shapes; synth-arxiv has ogbn-arxiv's node and directed-edge counts,
# feature width and class count
SYNTHETIC = {
    "synth-arxiv": dict(
        num_nodes=169_343, num_edges=1_166_243, num_features=128, num_classes=40
    ),
}


def synthetic_dataset(
    name: str | None = None,
    *,
    num_nodes: int = 2708,
    num_edges: int = 10556,
    num_features: int = 128,
    num_classes: int = 7,
    seed: int = 0,
    homophily: float = 0.8,
    powerlaw: float = 0.0,
    feature_scale: float = 2.0,
    device="cuda",
) -> NCDataset:
    """Planted-partition graph with class-correlated features.

    ``name`` picks a shape from :data:`SYNTHETIC` in place of ``num_nodes``,
    ``num_edges``, ``num_features`` and ``num_classes``. With probability
    ``homophily`` an edge joins two nodes of one class; ``powerlaw`` > 0
    draws sources from a shuffled Zipf popularity; ``feature_scale`` sets the
    class-centre separation against unit noise.
    """
    dev = resolve_device(device)
    if name is not None:
        if name not in SYNTHETIC:
            raise ValueError(f"unknown synthetic dataset {name!r}; known: {sorted(SYNTHETIC)}")
        shape = SYNTHETIC[name]
        num_nodes, num_edges = shape["num_nodes"], shape["num_edges"]
        num_features, num_classes = shape["num_features"], shape["num_classes"]
    rng = np.random.default_rng(seed)
    label = rng.integers(0, num_classes, num_nodes)
    centers = rng.standard_normal((num_classes, num_features)) * feature_scale
    feat = centers[label] + rng.standard_normal((num_nodes, num_features))
    if powerlaw > 0.0:
        pop = (np.arange(1, num_nodes + 1, dtype=np.float64) + 10.0) ** (-powerlaw)
        pop = rng.permutation(pop / pop.sum())
        src = rng.choice(num_nodes, size=num_edges, p=pop)
    else:
        src = rng.integers(0, num_nodes, num_edges)
    same = rng.random(num_edges) < homophily
    order = np.argsort(label, kind="stable")
    class_starts = np.searchsorted(label[order], np.arange(num_classes))
    class_ends = np.searchsorted(label[order], np.arange(num_classes), side="right")
    ls, le = class_starts[label[src]], class_ends[label[src]]
    dst_same = order[(ls + (rng.random(num_edges) * (le - ls)).astype(np.int64))]
    dst_rand = rng.integers(0, num_nodes, num_edges)
    dst = np.where(same, dst_same, dst_rand)

    ds = NCDataset(name or f"synth-n{num_nodes}")
    ds.graph = {
        "edge_index": np.stack([src, dst]).astype(np.int64),
        "node_feat": torch.from_numpy(feat.astype(np.float32)).to(dev),
        "edge_feat": None,
        "num_nodes": num_nodes,
    }
    ds.label = label.reshape(-1, 1).astype(np.int64)
    return ds
