"""Run one cell of the port's benchmark once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port (``sgformer_tpu_torch``). Set-up builds or loads the port's
kernels (into ``build/`` inside the checkout), makes the cell's inputs and
weights on the card from the seed and warms up every shape the cell uses;
the window then measures for ``--seconds``. ``--trace 1`` adds a traced
window after it and prints the per-layer metrics in place of the
end-to-end ones. After the window the program's state is freed and what
it produced is held to the plain reference; the numbers compared are
printed beside their limits, last on standard error and last in the
result, the JSON object on the last line of standard output.

``--dry`` rehearses a cell on the CPU at the tiny sizes of its
configuration's ``dry`` section through the port's plain paths: it prints
the comparison and no device metric. Without ``--dry`` a run needs the
cell's CUDA cards and exits non-zero, printing no result, without them.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time

from portbench import harness as H
from portbench.manifest import find_cell, load_driver, load_reader


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--dry", action="store_true",
                   help="rehearse on the CPU at the configuration's tiny sizes")
    return p.parse_args(argv)


def _number(v):
    """A compared number for JSON: non-finite values as strings."""
    return v if math.isfinite(v) else str(v)


def _spread(win) -> str:
    """The window's step times or request times, in ms: median, 95th
    percentile and largest."""
    from portbench.yardstick import percentile

    def three(xs):
        return (f"{percentile(xs, 50):.3f} / {percentile(xs, 95):.3f} / {max(xs):.3f}"
                if xs else "none")

    if win.steps:
        return f"step ms p50 / p95 / max {three([s['ms'] for s in win.steps])}"
    return (f"service ms p50 / p95 / max {three([r['service_ms'] for r in win.requests])}, "
            f"late ms {three([r['late_ms'] for r in win.requests])}")


def _traced(run, driver, state):
    """The traced window under the profiler: (timeline, work, failed,
    launch counts over it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import timeline as TL
    from sgformer_tpu_torch.kernels import launch_counts

    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with H.span("traced"):
            work, failed = driver.traced(run, state)
    after = launch_counts()
    return TL.from_profiler(prof), work, failed, {k: after[k] - before[k] for k in after}


def run_cell(cell, seed: int, seconds: float, trace: bool, dry: bool, started: float,
             hooks: dict | None = None) -> dict:
    """Set up, measure and check one run of ``cell``; returns the result
    (``dry``: the comparison alone). ``hooks`` are for the benchmark's own
    tests and calibration, which plant faults with them: a hook sees the
    program's trainer or predictor after set-up."""
    import torch

    from portbench import timeline as TL

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = H.Run(cell, seed, seconds, dry, started)
    run.hooks = hooks or {}
    if not dry:
        torch.cuda.init()
        torch.empty(1, device="cuda")
        run.phase(f"CUDA init ({torch.cuda.get_device_name(0)})")
        from sgformer_tpu_torch.kernels import _build

        _build.build_all()
        run.phase("kernels built or loaded")
    driver = load_driver(cell.traffic["kind"])
    state = driver.setup(run)
    cuda = not dry
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    win = driver.window(run, state)
    if cuda:
        win.mem_peak_bytes = torch.cuda.max_memory_allocated()
    H.log(f"window: {win.seconds:.3f} s, {win.attempted} attempted, {win.failed} failed; "
          f"{_spread(win)}")
    tl, work, traced_failed, launches = None, [], 0, {}
    if trace and cuda:
        tl, work, traced_failed, launches = _traced(run, driver, state)
        H.log(f"traced window: {tl.window_s:.4f} s, {len(work)} steps or requests, "
              f"launches {launches}")
    elif trace:
        work, traced_failed = driver.traced(run, state)
    kept = driver.release(run, state)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers, info = driver.check(run, kept)
    numbers["failed"] = win.failed + traced_failed
    H.log(f"check: reference {time.perf_counter() - t:.3f} s; {info}")
    for k in sorted(set(numbers) - set(cell.limits)):
        H.log(f"reading {k} {numbers[k]} (not compared in this cell)")
    numbers = {k: numbers[k] for k in cell.limits}
    checks = {k: {"value": _number(v), "limit": cell.limits[k]} for k, v in numbers.items()}
    correct = all(math.isfinite(v) and v <= cell.limits[k] for k, v in numbers.items())
    result = {"correct": correct, "attempted": win.attempted + len(work),
              "failed": win.failed + traced_failed}
    if dry:
        result = {"dry": True, **result, "checks": checks}
        return result
    ctx = H.MetricContext(run, win, tl, work, launches)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = run.setup_s if m["name"] == "setup_s" else load_reader(m["name"])(ctx)
        if value is None:
            H.log(f"metric {m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": max(setup_peak, win.mem_peak_bytes)}
    result.update(metrics=metrics, device=device)
    if tl is not None:
        device.update(busy_s=TL.busy_seconds(tl), window_s=tl.window_s)
        result["breakdown"] = TL.breakdown(tl)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    started = H.process_start_time()
    cell = find_cell(args.workload)
    H.set_build_environment()
    import torch

    if not args.dry and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell.chips):
        H.log(f"{cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), args.dry, started)
    bad = H.forbidden_modules()
    if bad:
        H.log(f"the process holds modules it may not load: {bad}")
        return 3
    for name, c in result["checks"].items():
        H.log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    # the bytecode of PyTorch and of the port cached inside the checkout, at
    # a fixed path, before the first import of torch: the first run of a
    # checkout compiles and writes it, later runs read it (an environment
    # that writes no bytecode recompiles torch's modules, seconds a run)
    sys.pycache_prefix = str(H.ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
    sys.exit(main())
