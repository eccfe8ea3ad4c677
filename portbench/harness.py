"""What every cell's run shares: the run's context and its set-up clock, the
harness's spans and CUDA-event timers, the weights drawn from the seed,
the readings of the program's first checked steps, the comparison of
those with the reference's, and the check of what the process loaded.

Nothing here imports the program at module level: the program is imported
by :func:`program` once the run has set the environment it builds in.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# whole top-level module names the process may not hold once the window has
# closed: JAX and the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "sgformer_tpu")
# seed purposes (graphgen.derive_seed)
SEED_WEIGHTS, SEED_DROPOUT, SEED_EPOCHS, SEED_TRACE = 2, 3, 4, 5


def set_build_environment(root: Path = ROOT) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the program's kernel and host-library cache (``SGFORMER_CACHE_DIR``),
    and PyTorch's and Triton's, which the program does not use today. No
    library may load JAX on its own."""
    build = root / "build"
    os.environ["SGFORMER_CACHE_DIR"] = str(build)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (the part before the first
    dot) is one of :data:`FORBIDDEN_MODULES`, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN_MODULES)


def process_start_time() -> float:
    """The wall-clock time this process started (``/proc``), or now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + int(fields[19]) / ticks
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Window:
    """What a measured window did: its length, every train step (``nodes``,
    ``edges``, ``ms`` and, for batch steps, ``build_ms``) or request
    (``latency_ms``, ``service_ms``, ``late_ms``, ``nodes``), and the peak
    device memory over it."""

    seconds: float
    steps: list
    requests: list
    attempted: int
    failed: int
    mem_peak_bytes: int = 0


class Run:
    """One run of one cell: its seed, device, sizes and clocks."""

    def __init__(self, cell, seed: int, seconds: float, dry: bool, started: float):
        import torch

        self.seed = int(seed)
        self.seconds = float(seconds)
        self.started = started
        self.device = torch.device("cpu" if dry else "cuda")
        cfg = cell.config
        self.model = dict(cfg["model"])
        self.train = dict(cfg.get("train", {}))
        self.graph = dict(cfg["graph"])
        self.traffic = dict(cell.traffic)
        if dry:
            self.graph.update(cfg.get("dry", {}).get("graph", {}))
            self.train.update(cfg.get("dry", {}).get("train", {}))
            self.traffic.update(cfg.get("dry", {}).get("traffic", {}))
        self.dtype = self.model["compute_dtype"]
        self.in_channels = int(self.graph["num_features"])
        self.setup_s = None
        self._phase_t = time.perf_counter()
        log(f"setup: interpreter, torch and the harness imported "
            f"{time.time() - started:.3f} s (from process start)")
        # a hook the fault tests set: called with the program's trainer or
        # predictor once set-up has built it
        self.hooks: dict = {}

    # -- clocks ----------------------------------------------------------------

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize()

    def phase(self, what: str) -> None:
        """Close a set-up phase: print how long it took."""
        self.sync()
        now = time.perf_counter()
        log(f"setup: {what} {now - self._phase_t:.3f} s")
        self._phase_t = now

    def window_starts(self) -> None:
        """The first timed step is next: set-up ends here."""
        self.sync()
        self.setup_s = time.time() - self.started
        log(f"setup: total {self.setup_s:.3f} s (from process start)")

    def seed_for(self, purpose: int) -> int:
        from portbench.graphgen import derive_seed

        return derive_seed(self.seed, purpose)


@contextlib.contextmanager
def span(name: str):
    """A harness span around a call into the program (``pb:<name>``): a
    host range in the profiler's trace, free when it is off."""
    import torch

    with torch.profiler.record_function(f"pb:{name}"):
        yield


class Timer:
    """CUDA events recorded on the stream without waiting for it, read once
    the window has synchronised; on the CPU, the host clock."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


# -- the program -----------------------------------------------------------------


def sgformer_config(model: dict):
    """The program's ``SGFormerConfig`` of a configuration's ``model``
    section (its ``tier`` names the constructor)."""
    from sgformer_tpu_torch import SGFormerConfig

    kw = {k: v for k, v in model.items() if k not in ("tier", "hidden_channels", "out_channels")}
    return getattr(SGFormerConfig, model["tier"])(model["hidden_channels"],
                                                  model["out_channels"], **kw)


def build_model(run: Run):
    """The program's SGFormer with the benchmark's weights from the seed,
    and those weights (f32, by state-dict name)."""
    from portbench.references.sgformer import draw_weights
    from sgformer_tpu_torch import SGFormer

    weights = draw_weights(run.model, run.in_channels, run.seed_for(SEED_WEIGHTS), run.device)
    run.phase("weights drawn on the device")
    model = SGFormer(sgformer_config(run.model), run.in_channels, device=run.device)
    model.load_state_dict(weights, strict=True)
    run.phase("SGFormer built, weights loaded")
    return model, weights


def dropout_generator(run: Run):
    import torch

    return torch.Generator(device=run.device).manual_seed(run.seed_for(SEED_DROPOUT))


# -- the checked first steps --------------------------------------------------------


def norm(t) -> float:
    return float(t.detach().double().norm())


def first_gradients(model, optimizer) -> dict:
    """Each leaf's gradient as the optimizer got it in its first step,
    worked out from its state after that step: exp_avg / (1 - beta1). A
    leaf the optimizer holds no state for reads 0."""
    out = {}
    beta1 = {id(p): g["betas"][0] for g in optimizer.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        out[name] = norm(st["exp_avg"]) / (1.0 - beta1[id(p)]) if "exp_avg" in st else 0.0
    return out


def changes(model, weights: dict) -> dict:
    """Each leaf's change from the benchmark's weights."""
    return {name: norm(p.detach().float() - weights[name].to(p.device))
            for name, p in model.named_parameters()}


@dataclasses.dataclass
class StepReadings:
    """A training side's first three steps: each loss, each leaf's first
    gradient norm, and each leaf's change after the three."""

    losses: list
    grads: dict
    changes: dict


def reference_steps(run: Run, weights: dict, batches, precision: str) -> StepReadings:
    """The reference's three steps from the benchmark's weights: ``batches``
    yields (x, csr, label, mask, denominator) for each step; the dropout
    masks come from a twin of the program's generator."""
    from portbench.references.sgformer import Reference, branch_decay

    ref = Reference(run.model, weights, precision)
    gen = dropout_generator(run)
    decay = branch_decay(ref.leaves(), run.train)
    losses, first = [], None
    for x, csr, label, mask, den in batches:
        loss, grads = ref.grads(x, csr, label, mask, den, gen)
        got = ref.adam_step(grads, float(run.train["lr"]), decay)
        if first is None:
            first = {k: norm(g) for k, g in got.items()}
        losses.append(float(loss))
    delta = {k: norm(ref.p[k] - weights[k].float()) for k in ref.leaves()}
    return StepReadings(losses, first, delta)


# share of the median leaf's gradient under which a leaf counts as having
# none: its change is round-off under Adam and is not compared
NO_GRADIENT = 1e-3


def compare_steps(prog: StepReadings, ref: StepReadings) -> tuple[dict, list]:
    """The numbers a training cell may compare, and the leaves left out of
    the change: ``loss_gap``, the largest |loss - reference| / |reference|
    over the three steps; ``grad_gap``, the largest gap between the
    program's and the reference's first-gradient norm of a leaf, over the
    larger of that leaf's reference norm and the median leaf's;
    ``change_gap``, the same for each leaf's change after the three steps,
    over the leaves whose reference gradient is at least NO_GRADIENT of the
    median leaf's; ``change_med_gap``, the median of those leaves' change
    gaps, which the odd leaf moved by round-off under Adam's first steps
    does not swing."""

    def gap(a, b, scale):
        if not (math.isfinite(a) and math.isfinite(b)):
            return math.inf
        return abs(a - b) / scale if scale > 0 else (0.0 if a == b else math.inf)

    loss_gap = max(gap(a, b, abs(b)) for a, b in zip(prog.losses, ref.losses))
    med_g = statistics.median(ref.grads.values())
    grad_gap = max(gap(prog.grads[k], ref.grads[k], max(ref.grads[k], med_g)) for k in ref.grads)
    kept = [k for k in ref.grads if ref.grads[k] >= NO_GRADIENT * med_g]
    left_out = sorted(set(ref.grads) - set(kept))
    med_d = statistics.median(ref.changes[k] for k in kept)
    changes = [gap(prog.changes[k], ref.changes[k], max(ref.changes[k], med_d)) for k in kept]
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": max(changes),
            "change_med_gap": statistics.median(changes)}, left_out


@dataclasses.dataclass
class MetricContext:
    """What a metric's reader reads: the run (configuration, type, sizes),
    its measured window, and in a traced run the timeline of the traced
    window, the work done in it (``{"kind": "train" | "forward", "nodes",
    "edges"}`` a step or request) and the program's launch counters over
    it."""

    run: Run
    window: Window
    timeline: object = None
    traced: list = dataclasses.field(default_factory=list)
    launches: dict = dataclasses.field(default_factory=dict)
