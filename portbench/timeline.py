"""The traced window: a ``torch.profiler`` (CUPTI) trace of the card read
into device intervals and the harness's own host spans, and the arithmetic
on them: busy and idle time, time by kernel, idle gaps by the span the host
was in.

The harness opens a span (``torch.profiler.record_function``) named
``pb:<what>`` around each call into the program; the traced window is the
span ``pb:traced``, which starts and ends on a synchronised card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "pb:"
WINDOW_SPAN = "pb:traced"


@dataclasses.dataclass
class Interval:
    name: str
    start: float  # seconds, the profiler's clock
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Timeline:
    """Device operations and harness spans inside the traced window
    [start, end] (seconds)."""

    start: float
    end: float
    device: list  # Interval, clipped to the window
    spans: list  # Interval of the harness's spans

    @property
    def window_s(self) -> float:
        return self.end - self.start


def kernel_id(name: str) -> str:
    """A device operation's function name, without its return type,
    namespaces, template arguments and parameters: ``void (anonymous
    namespace)::csr_spmm_kernel<...>(...)`` gives ``csr_spmm_kernel``."""
    s = name.strip().replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    m = re.match(r"[\w:]+", s)
    return (m.group(0) if m else s).split("::")[-1]


def from_events(events: list) -> Timeline:
    """A timeline from chrome-trace events (``ph`` "X", ``ts``/``dur`` in
    microseconds): device operations by category, harness spans by name."""
    device, spans = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        start = float(ev["ts"]) * 1e-6
        iv = Interval(str(ev.get("name", "")), start, start + float(ev["dur"]) * 1e-6)
        cat = str(ev.get("cat", "")).lower()
        if cat in DEVICE_CATEGORIES:
            device.append(iv)
        elif cat == "user_annotation" and iv.name.startswith(SPAN_PREFIX):
            spans.append(iv)
    windows = [s for s in spans if s.name == WINDOW_SPAN]
    if len(windows) != 1:
        raise ValueError(f"the trace holds {len(windows)} '{WINDOW_SPAN}' spans, not one")
    w = windows[0]
    clipped = [Interval(d.name, max(d.start, w.start), min(d.end, w.end))
               for d in device if d.end > w.start and d.start < w.end]
    return Timeline(w.start, w.end, clipped,
                    [s for s in spans if s.name != WINDOW_SPAN])


def from_profiler(prof) -> Timeline:
    """Export ``prof``'s chrome trace to a temporary file, read it and
    delete it."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return from_events(events)


def union_seconds(intervals: list) -> float:
    """Seconds covered by at least one interval."""
    total, cur_s, cur_e = 0.0, None, None
    for iv in sorted(intervals, key=lambda i: i.start):
        if cur_e is None or iv.start > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = iv.start, iv.end
        else:
            cur_e = max(cur_e, iv.end)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_seconds(tl: Timeline) -> float:
    return union_seconds(tl.device)


def idle_share(tl: Timeline) -> float:
    """The share of the window in which no device operation ran."""
    return 1.0 - busy_seconds(tl) / tl.window_s


def idle_gaps(tl: Timeline) -> list:
    """The window's stretches with no device operation, split where a
    harness span opens or closes, each named by the innermost span open on
    the host over it (``harness`` where none is)."""
    gaps, cursor = [], tl.start
    for iv in sorted(tl.device, key=lambda i: i.start):
        if iv.start > cursor:
            gaps.append((cursor, iv.start))
        cursor = max(cursor, iv.end)
    if cursor < tl.end:
        gaps.append((cursor, tl.end))
    out = []
    for a, b in gaps:
        cuts = sorted({a, b, *(t for s in tl.spans for t in (s.start, s.end) if a < t < b)})
        for lo, hi in zip(cuts, cuts[1:]):
            mid = (lo + hi) / 2
            open_spans = [s for s in tl.spans if s.start <= mid < s.end]
            name = (min(open_spans, key=lambda s: s.seconds).name[len(SPAN_PREFIX):]
                    if open_spans else "harness")
            out.append(Interval(name, lo, hi))
    return out


def top(pairs: dict, k: int = 10) -> list:
    return [[name, secs] for name, secs in sorted(pairs.items(), key=lambda kv: -kv[1])[:k]]


def breakdown(tl: Timeline, k: int = 10) -> dict:
    """The device operations that took the most time, by function name,
    and the idle time by the harness span the host was in, seconds
    each."""
    ops: dict = {}
    for iv in tl.device:
        key = kernel_id(iv.name)
        ops[key] = ops.get(key, 0.0) + iv.seconds
    gaps: dict = {}
    for g in idle_gaps(tl):
        gaps[g.name] = gaps.get(g.name, 0.0) + g.seconds
    return {"device_ops": top(ops, k), "idle_gaps": top(gaps, k)}


def kernel_seconds(tl: Timeline, names) -> tuple[float, dict]:
    """Device seconds of the kernels whose function name is in ``names``,
    and the launches of each."""
    names = set(names)
    secs, counts = 0.0, {}
    for iv in tl.device:
        kid = kernel_id(iv.name)
        if kid in names:
            secs += iv.seconds
            counts[kid] = counts.get(kid, 0) + 1
    return secs, counts
