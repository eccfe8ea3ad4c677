"""The one generator of the benchmark's traffic, driven by a mix's data file
(``traffic/<name>.json``).

Every seed gets the same set of sizes and arrivals, in another order: a
request mix's sizes are a fixed grid over [``min_nodes``, ``max_nodes``],
permuted by the seed, and its requests are evenly spaced; the node ids a
request asks for are drawn from the seed. So the work of a run does not
depend on its seed, only its order does.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Request:
    due_s: float  # from the window's start
    node_ids: np.ndarray  # int64


def request_schedule(traffic: dict, seed: int, seconds: float, num_nodes: int) -> list:
    """The requests due in a window of ``seconds``: ``rate_per_s`` a second,
    evenly spaced, each asking for the classes of between ``min_nodes`` and
    ``max_nodes`` node ids."""
    k = max(1, int(round(float(traffic["rate_per_s"]) * seconds)))
    rng = np.random.default_rng([int(seed), 2])
    lo, hi = int(traffic["min_nodes"]), int(traffic["max_nodes"])
    sizes = lo + (np.arange(k) * (hi - lo + 1)) // k
    sizes = sizes[rng.permutation(k)]
    due = np.arange(k) / float(traffic["rate_per_s"])
    ids = rng.integers(0, num_nodes, int(sizes.sum()), dtype=np.int64)
    cuts = np.concatenate([[0], np.cumsum(sizes)])
    return [Request(float(due[i]), ids[cuts[i]:cuts[i + 1]]) for i in range(k)]

