"""Evaluation metrics, numpy and scipy on the host: the port of
``sgformer_tpu/data/metrics.py``.

The JAX module calls scikit-learn for ROC-AUC and F1; the port computes
both itself. ROC-AUC is the rank statistic (Mann-Whitney U) with tied
scores given their average rank, which is the area under the trapezoidal
ROC curve that ``roc_auc_score`` gives. Micro-F1 over single-label classes
is 2 TP / (2 TP + FP + FN) summed over every class, as ``f1_score(...,
average="micro")`` gives.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import rankdata


def eval_acc(y_true, y_pred) -> float:
    """Per-column mean accuracy. ``y_true`` [N, C_lab] (NaN for unlabeled
    rows, which are skipped), ``y_pred`` [N, C] logits (argmaxed here)."""
    y_true = np.asarray(y_true)
    if y_true.ndim == 1:
        y_true = y_true[:, None]
    y_pred = np.asarray(y_pred).argmax(axis=-1, keepdims=True)
    accs = []
    for i in range(y_true.shape[1]):
        is_labeled = y_true[:, i] == y_true[:, i]
        correct = y_true[is_labeled, i] == y_pred[is_labeled, 0]
        accs.append(float(np.sum(correct)) / len(correct))
    return sum(accs) / len(accs)


def roc_auc(y_true, score) -> float:
    """Area under the ROC curve of binary labels ``y_true`` (0/1) for the
    scores ``score``, from average ranks (ties count one half)."""
    y_true = np.asarray(y_true).reshape(-1)
    ranks = rankdata(np.asarray(score, dtype=np.float64).reshape(-1))
    pos = y_true == 1
    n_pos = int(pos.sum())
    n_neg = y_true.shape[0] - n_pos
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def eval_rocauc(y_true, y_pred) -> float:
    """OGB-adapted ROC-AUC. Single-column labels score with the softmax
    probability of class 1; multi-column labels score each column that has
    both classes, over its labeled rows, and average."""
    y_true = np.asarray(y_true)
    if y_true.ndim == 1:
        y_true = y_true[:, None]
    y_pred = np.asarray(y_pred).astype(np.float64)
    if y_true.shape[1] == 1:
        e = np.exp(y_pred - y_pred.max(axis=-1, keepdims=True))
        y_pred = (e / e.sum(axis=-1, keepdims=True))[:, 1:2]
    scores = []
    for i in range(y_true.shape[1]):
        if np.sum(y_true[:, i] == 1) > 0 and np.sum(y_true[:, i] == 0) > 0:
            is_labeled = y_true[:, i] == y_true[:, i]
            scores.append(roc_auc(y_true[is_labeled, i], y_pred[is_labeled, i]))
    if not scores:
        raise RuntimeError(
            "No positively labeled data available. Cannot compute ROC-AUC."
        )
    return sum(scores) / len(scores)


def eval_f1(y_true, y_pred) -> float:
    """Micro-F1 of the argmax class against single-column labels."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).argmax(axis=-1).reshape(-1)
    tp = fp = fn = 0
    for c in np.union1d(y_true, y_pred):
        hit_true, hit_pred = y_true == c, y_pred == c
        tp += int(np.sum(hit_true & hit_pred))
        fp += int(np.sum(~hit_true & hit_pred))
        fn += int(np.sum(hit_true & ~hit_pred))
    return 2.0 * tp / (2 * tp + fp + fn)


def count_correct(y_true, y_pred) -> tuple[int, int]:
    """Streaming (total, correct) pair for batched evaluation."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).argmax(axis=-1).reshape(-1)
    return int(y_true.shape[0]), int((y_true == y_pred).sum())


METRICS = {"acc": eval_acc, "rocauc": eval_rocauc, "f1": eval_f1}
