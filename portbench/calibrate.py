"""The readings a cell's correctness limits are set from, on the card at the
cell's own size, in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \
        [--controls 4] [--faults 3] [--seconds 3] [--out FILE]

- sound: the program's numbers, as a run compares them, on every seed
  (``--seconds`` of window each);
- control: the reference computed one step below the configuration's
  precision (``references.sgformer.control_precision``) in the program's
  place, on the first ``--controls`` seeds;
- faults: the program with a fault planted under the timed path, on the
  first ``--faults`` seeds: a step that leaves the state unchanged, half
  of the batch left out of the loss (its mean taken over the rest), a
  batch cut one node short, an answer altered where it is produced.

The benchmark's own runs run none of this. It prints one JSON line a
reading and a summary: the largest sound reading and the smallest control
and fault readings of each number.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

import torch

from portbench import harness as H
from portbench.manifest import find_cell, load_driver
from portbench.references.sgformer import control_precision
from portbench.run import run_cell


def _state_unchanged(trainer):
    trainer.optimizer.step = lambda *a, **k: None


def _half_batch_full(trainer):
    loss = trainer.loss
    trainer.loss = lambda idx: loss(idx[: idx.numel() // 2])


def _half_batch(trainer):
    import dataclasses

    loss = trainer.loss

    def half(batch):
        m = batch.train_mask.clone()
        m[m.numel() // 2:] = 0.0
        return loss(dataclasses.replace(batch, train_mask=m))

    trainer.loss = half


def _short_batch(trainer):
    batch_nodes = trainer.batch_nodes
    trainer.batch_nodes = lambda perm, i: batch_nodes(perm, i)[:-1]


def _answer_altered(predictor):
    predict = predictor.predict
    classes = int(predictor.model.fc.weight.shape[0])

    def altered(ids=None):  # the first answer of every request
        out = predict(ids)
        out[0] = (out[0] + 1) % classes
        return out

    predictor.predict = altered


FAULTS = {
    "full_graph_train": {"state_unchanged": ("trainer", _state_unchanged),
                         "half_batch": ("trainer", _half_batch_full)},
    "batch_train": {"state_unchanged": ("trainer", _state_unchanged),
                    "half_batch": ("trainer", _half_batch),
                    "short_batch": ("trainer", _short_batch)},
    "serve": {"answer_altered": ("predictor", _answer_altered)},
}


def control_reading(cell, seed: int, seconds: float, dry: bool) -> dict:
    """The control's numbers on ``seed``: the reference in the control
    precision in the program's place, against the f32 reference."""
    run = H.Run(cell, seed, seconds, dry, time.time())
    driver = load_driver(cell.traffic["kind"])
    precision = control_precision(run.dtype)
    if cell.traffic["kind"] == "serve":
        from portbench.drivers.serve import answer_gap, reference_logits

        ref = reference_logits(run)
        ctl = reference_logits(run, precision)
        ids = torch.arange(ref.shape[0], device=ref.device)
        return {"answer_gap": answer_gap(ref, ids, ctl.argmax(dim=1))}
    from portbench.references.sgformer import draw_weights

    weights = draw_weights(run.model, run.in_channels, run.seed_for(H.SEED_WEIGHTS), run.device)
    steps = driver.reference_inputs(run)
    ref = H.reference_steps(run, weights, steps, "f32")
    ctl = H.reference_steps(run, weights, steps, precision)
    return H.compare_steps(ctl, ref)[0]


def sweep(cell, seed: int, rates: list, seconds: float) -> list:
    """The serving cell's knee: one set-up, then ``seconds`` of the mix at
    each rate; each rate's median and 95th-percentile latency and how late
    its last request was issued."""
    from portbench import traffic as T
    from portbench.drivers import serve
    from portbench.yardstick import percentile

    run = H.Run(cell, seed, seconds, False, time.time())
    state = serve.setup(run)
    out = []
    for rate in rates:
        mix = dict(run.traffic, rate_per_s=rate)
        records = []
        serve._serve(run, state, T.request_schedule(mix, seed, seconds, state.nodes), records)
        lat = [r["latency_ms"] for r in records]
        out.append({"rate_per_s": rate, "requests": len(lat), "p50_ms": percentile(lat, 50),
                    "p95_ms": percentile(lat, 95), "last_late_ms": records[-1]["late_ms"],
                    "service_p50_ms": percentile([r["service_ms"] for r in records], 50)})
        print(json.dumps(out[-1]), flush=True)
    return out


# every number a kind of cell can compare; calibration reads them all
NUMBERS = {"full_graph_train": ("loss_gap", "grad_gap", "change_gap", "change_med_gap", "failed"),
           "batch_train": ("loss_gap", "grad_gap", "change_gap", "change_med_gap",
                           "batches_differ", "failed"),
           "serve": ("answer_gap", "failed")}


def _reading_all(cell):
    """The cell with every number of its kind compared against no limit."""
    return dataclasses.replace(cell, limits={k: math.inf for k in NUMBERS[cell.traffic["kind"]]})


def _numbers(result: dict, limits: dict) -> tuple[dict, bool]:
    """A run's numbers, and whether they meet the cell's own limits."""
    numbers = {k: (v["value"] if isinstance(v["value"], (int, float)) else math.inf)
               for k, v in result["checks"].items()}
    return numbers, all(numbers[k] <= lim for k, lim in limits.items())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--controls", type=int, default=4)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--dry", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--sweep", default=None,
                   help="comma-separated rates: find a serving cell's knee instead")
    args = p.parse_args(argv)
    cell = find_cell(args.workload)
    H.set_build_environment()
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.sweep:
        sweep(cell, seeds[0], [float(r) for r in args.sweep.split(",")], args.seconds)
        return 0
    readings = []

    def note(kind, seed, numbers, extra=None):
        rec = {"kind": kind, "seed": seed, "numbers": numbers, **(extra or {})}
        readings.append(rec)
        print(json.dumps(rec), flush=True)

    every = _reading_all(cell)
    for seed in seeds:
        res = run_cell(every, seed, args.seconds, False, args.dry, time.time())
        numbers, correct = _numbers(res, cell.limits)
        note("sound", seed, numbers, {"correct": correct})
    for seed in seeds[: args.controls]:
        note("control", seed, control_reading(cell, seed, args.seconds, args.dry))
    for fault, (target, plant) in FAULTS[cell.traffic["kind"]].items():
        for seed in seeds[: args.faults]:
            res = run_cell(every, seed, args.seconds, False, args.dry, time.time(),
                           hooks={target: plant})
            numbers, correct = _numbers(res, cell.limits)
            note(fault, seed, numbers, {"correct": correct})
    summary = {}
    for rec in readings:
        for k, v in rec["numbers"].items():
            s = summary.setdefault(k, {})
            pick = max if rec["kind"] == "sound" else min
            s[rec["kind"]] = pick(s.get(rec["kind"], v), v)
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": cell.name, "readings": readings, "summary": summary}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
