"""Train/valid/test split generators.

A numpy copy of ``sgformer_tpu/data/splits.py`` (the SGFormer reference's
``large/data_utils.py`` splits), seeded through explicit numpy Generators.
"""

from __future__ import annotations

import numpy as np


def rand_train_test_idx(
    label: np.ndarray,
    train_prop: float = 0.5,
    valid_prop: float = 0.25,
    ignore_negative: bool = True,
    rng: np.random.Generator | None = None,
):
    """Random split over labeled (!= -1) nodes, 50/25/25 by default."""
    rng = rng or np.random.default_rng()
    label = np.asarray(label).reshape(-1)
    if ignore_negative:
        labeled = np.where(label != -1)[0]
    else:
        labeled = np.arange(label.shape[0])
    n = labeled.shape[0]
    train_num = int(n * train_prop)
    valid_num = int(n * valid_prop)
    perm = rng.permutation(n)
    return {
        "train": labeled[perm[:train_num]],
        "valid": labeled[perm[train_num : train_num + valid_num]],
        "test": labeled[perm[train_num + valid_num :]],
    }


def class_rand_splits(
    label: np.ndarray,
    label_num_per_class: int,
    valid_num: int = 500,
    test_num: int = 1000,
    rng: np.random.Generator | None = None,
):
    """k labeled nodes per class for train + fixed-size valid/test
    (``large/data_utils.py:61-77``)."""
    rng = rng or np.random.default_rng()
    label = np.asarray(label).reshape(-1)
    train_idx, non_train = [], []
    for c in np.unique(label):
        idx_c = np.where(label == c)[0]
        idx_c = idx_c[rng.permutation(len(idx_c))]
        train_idx += idx_c[:label_num_per_class].tolist()
        non_train += idx_c[label_num_per_class:].tolist()
    non_train = np.asarray(non_train)
    non_train = non_train[rng.permutation(len(non_train))]
    return {
        "train": np.asarray(train_idx),
        "valid": non_train[:valid_num],
        "test": non_train[valid_num : valid_num + test_num],
    }


def even_quantile_labels(vals: np.ndarray, nclasses: int) -> np.ndarray:
    """Quantile-bucketed int labels (arxiv-year/snap-patents,
    ``large/data_utils.py:80-101``)."""
    label = -1 * np.ones(vals.shape[0], dtype=np.int64)
    lower = -np.inf
    for k in range(nclasses - 1):
        upper = np.quantile(vals, (k + 1) / nclasses)
        label[(vals >= lower) & (vals < upper)] = k
        lower = upper
    label[vals >= lower] = nclasses - 1
    return label


def masks_to_idx(split: dict) -> dict:
    """Convert boolean-mask splits (geom-gcn npz) to index arrays."""
    out = {}
    for k, v in split.items():
        v = np.asarray(v)
        out[k] = np.where(v)[0] if v.dtype == bool else v
    return out
