"""Run logger: per-run metric history, model selection, run statistics.
A copy of ``sgformer_tpu/train/logger.py`` (plain Python, no JAX), which the
port may not import.

Stores (train, valid, test, valid_loss) per evaluation per run; model
selection picks the evaluation with the highest valid metric
(``mode='max_acc'``) or the lowest valid loss (``mode='min_loss'``);
``print_statistics`` reports mean ± std over runs of the Highest-Train /
Highest-Valid / Final-Train / Final-Test numbers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class RunLogger:
    runs: int
    mode: str = "max_acc"  # 'max_acc' | 'min_loss'
    results: list = field(default_factory=list)

    def __post_init__(self):
        self.results = [[] for _ in range(self.runs)]

    def add_result(self, run: int, result: tuple):
        """result = (train_metric, valid_metric, test_metric, valid_loss)."""
        if not 0 <= run < self.runs:
            raise ValueError(f"run {run} out of range for {self.runs} runs")
        self.results[run].append(tuple(float(x) for x in result))

    def best_epoch(self, run: int) -> int:
        rows = self.results[run]
        if self.mode == "min_loss":
            return min(range(len(rows)), key=lambda i: rows[i][3])
        return max(range(len(rows)), key=lambda i: rows[i][1])

    def run_summary(self, run: int) -> dict:
        rows = self.results[run]
        best = self.best_epoch(run)
        return {
            "highest_train": max(r[0] for r in rows),
            "highest_valid": max(r[1] for r in rows),
            "final_train": rows[best][0],
            "final_test": rows[best][2],
            "best_epoch": best,
        }

    @staticmethod
    def _mean_std(xs):
        m = sum(xs) / len(xs)
        v = sum((x - m) ** 2 for x in xs) / len(xs) if len(xs) > 1 else 0.0
        return m, math.sqrt(v)

    def statistics(self) -> dict:
        """Aggregate over completed runs; values in percent like the
        reference printout."""
        sums = [self.run_summary(r) for r in range(self.runs) if self.results[r]]
        out = {}
        for key in ("highest_train", "highest_valid", "final_train", "final_test"):
            mean, std = self._mean_std([100 * s[key] for s in sums])
            out[key] = (mean, std)
        return out

    def print_statistics(self, run: int | None = None):
        if run is not None:
            s = self.run_summary(run)
            print(
                f"Run {run + 1:02d}: "
                f"Highest Train: {100 * s['highest_train']:.2f}, "
                f"Highest Valid: {100 * s['highest_valid']:.2f}, "
                f"Final Train: {100 * s['final_train']:.2f}, "
                f"Final Test: {100 * s['final_test']:.2f}"
            )
            return
        stats = self.statistics()
        print("All runs:")
        for key, label in (
            ("highest_train", "Highest Train"),
            ("highest_valid", "Highest Valid"),
            ("final_train", "  Final Train"),
            ("final_test", "   Final Test"),
        ):
            mean, std = stats[key]
            print(f"{label}: {mean:.2f} ± {std:.2f}")
        return stats
