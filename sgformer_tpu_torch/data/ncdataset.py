"""NCDataset: the node-classification dataset container.

A numpy copy of ``sgformer_tpu/data/ncdataset.py``: an OGB-style dict graph
(``edge_index``, ``node_feat``, ``edge_feat``, ``num_nodes``), a ``label``
array and ``get_idx_split``, as in the SGFormer reference's
``large/dataset.py``. Splits are computed on the host.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from sgformer_tpu_torch.data.splits import class_rand_splits, rand_train_test_idx


class NCDataset:
    def __init__(self, name: str):
        self.name = name
        self.graph: dict = {}
        self.label: Optional[np.ndarray] = None
        # Datasets with committed splits attach a loader here
        # (reference monkey-patches closures, large/dataset.py:298-416).
        self.load_fixed_splits: Optional[Callable[[], dict]] = None

    def get_idx_split(
        self,
        split_type: str = "random",
        train_prop: float = 0.5,
        valid_prop: float = 0.25,
        label_num_per_class: int = 20,
        rng: np.random.Generator | None = None,
    ) -> dict:
        if split_type == "random":
            return rand_train_test_idx(
                self.label, train_prop=train_prop, valid_prop=valid_prop, rng=rng
            )
        if split_type == "class":
            return class_rand_splits(self.label, label_num_per_class, rng=rng)
        raise ValueError(f"unknown split_type {split_type}")

    @property
    def num_nodes(self) -> int:
        return int(self.graph["num_nodes"])

    @property
    def num_classes(self) -> int:
        label = np.asarray(self.label)
        if label.ndim > 1 and label.shape[1] > 1:
            return label.shape[1]
        return int(label.max()) + 1

    def __repr__(self):
        return f"NCDataset({self.name}, N={self.graph.get('num_nodes')})"
