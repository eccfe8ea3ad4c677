"""Serving: ``Predictor.predict(node_ids)`` for one client's requests,
offered open loop at the mix's fixed rate (``traffic.request_schedule``):
a request is issued when it is due or, if the predictor is still busy,
when the one before it is answered. A request's latency runs from when it
was due to when its answer is on the host: the time it waited (host
clock, 0 while the predictor keeps up) plus its service, from CUDA events
recorded at its issue and after its answer came back.

After the window every answered class is held to the reference's logits
of its node.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import harness as H
from portbench import traffic as T
from portbench.graphgen import planted_partition
from portbench.references.sgformer import gcn_csr, symmetric_edges

WARM_UP_REQUESTS = 8


class State:
    pass


def setup(run: H.Run) -> State:
    from sgformer_tpu_torch import Predictor, preprocess_graph

    s = State()
    inputs = planted_partition(run.graph, run.seed, run.device)
    n = inputs.num_nodes
    run.phase("inputs on the device")
    graph = preprocess_graph(inputs.edge_index, n, device=run.device)
    run.phase("preprocess_graph (walk order on the host)")
    model, _ = H.build_model(run)
    s.predictor = Predictor(model, graph, inputs.x, device=run.device).compile()
    del inputs, graph
    run.phase("model, weights and Predictor.compile")
    if "predictor" in run.hooks:
        run.hooks["predictor"](s.predictor)
    s.schedule = T.request_schedule(run.traffic, run.seed, run.seconds, n)
    s.nodes, s.edges = n, s.predictor.graph.num_edges
    run.phase(f"{len(s.schedule)} requests drawn")
    lo, hi = int(run.traffic["min_nodes"]), int(run.traffic["max_nodes"])
    warm = np.random.default_rng([run.seed, 3]).integers(0, n, hi)
    for i in range(WARM_UP_REQUESTS):
        s.predictor.predict(warm[: lo if i % 2 else hi])
    run.phase("warm-up requests")
    return s


def _serve(run: H.Run, s: State, schedule: list, records: list) -> int:
    """Offer ``schedule`` open loop; returns the requests that failed."""
    timer = H.Timer(run.device)
    failed = 0
    t0 = time.perf_counter()
    for req in schedule:
        due = t0 + req.due_s
        with H.span("wait_arrival"):
            while True:
                left = due - time.perf_counter()
                if left <= 0:
                    break
                if left > 2e-3:
                    time.sleep(left - 1e-3)
        late = time.perf_counter() - due
        a = timer.mark()
        try:
            with H.span("request"):
                answer = s.predictor.predict(req.node_ids)
        except RuntimeError as err:
            H.log(f"request failed: {err}")
            answer = None
        b = timer.mark()
        ok = answer is not None and np.shape(answer) == (req.node_ids.shape[0],)
        failed += not ok
        records.append({"nodes": int(req.node_ids.shape[0]), "late_ms": late * 1e3,
                        "graph_nodes": s.nodes, "graph_edges": s.edges,
                        "marks": (a, b), "ids": req.node_ids, "answer": answer if ok else None})
    run.sync()
    for r in records:
        a, b = r.pop("marks")
        r["service_ms"] = timer.ms(a, b)
        r["latency_ms"] = r["late_ms"] + r["service_ms"]
    return failed


def window(run: H.Run, s: State) -> H.Window:
    records = []
    run.window_starts()
    t0 = time.perf_counter()
    failed = _serve(run, s, s.schedule, records)
    secs = time.perf_counter() - t0
    s.answered = [(r.pop("ids"), r.pop("answer")) for r in records]
    return H.Window(secs, [], records, len(records), failed)


def traced(run: H.Run, s: State) -> tuple[list, int]:
    """The traced work: ``trace_requests`` more requests at the mix's rate,
    drawn from the run's seed for tracing."""
    count = int(run.traffic["trace_requests"])
    seconds = count / float(run.traffic["rate_per_s"])
    schedule = T.request_schedule(run.traffic, run.seed_for(H.SEED_TRACE), seconds, s.nodes)
    records = []
    failed = _serve(run, s, schedule, records)
    return [{"kind": "forward", "nodes": s.nodes, "edges": s.edges} for _ in records], failed


def release(run: H.Run, s: State) -> dict:
    answered = [(ids, ans) for ids, ans in s.answered if ans is not None]
    s.predictor = s.answered = None
    return {"answered": answered}


def reference_logits(run: H.Run, precision: str = "f32") -> torch.Tensor:
    """[N, C] eval-mode logits of the reference on the inputs and weights
    made again from the seed."""
    from portbench.references.sgformer import Reference, draw_weights

    inputs = planted_partition(run.graph, run.seed, run.device)
    n = inputs.num_nodes
    csr = gcn_csr(*symmetric_edges(inputs.edge_index, n), n)
    weights = draw_weights(run.model, run.in_channels, run.seed_for(H.SEED_WEIGHTS), run.device)
    with torch.no_grad():
        return Reference(run.model, weights, precision).forward(inputs.x, csr, train=False)


def answer_gap(ref: torch.Tensor, ids: torch.Tensor, classes: torch.Tensor) -> float:
    """The widest gap by which an answered class's reference logit lies
    below the reference's best logit of its node."""
    if ids.numel() == 0:
        return 0.0
    rows = ref[ids]
    return float((rows.max(dim=1).values - rows.gather(1, classes[:, None]).squeeze(1)).max())


def check(run: H.Run, kept: dict) -> tuple[dict, dict]:
    """The widest answer gap over every answered request, against the
    reference's logits."""
    ref = reference_logits(run)
    pairs = kept["answered"]

    def cat(k):
        return torch.from_numpy(np.concatenate([p[k] for p in pairs]) if pairs
                                else np.zeros(0, np.int64)).to(ref.device).long()

    ids, classes = cat(0), cat(1)
    return ({"answer_gap": answer_gap(ref, ids, classes)},
            {"answers": int(ids.numel()), "requests": len(pairs)})
