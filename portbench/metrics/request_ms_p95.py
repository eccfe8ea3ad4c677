"""request_ms_p95: the 95th percentile over every request of the window of
the time from when it was due to when its answer was on the host: its wait
(host clock) plus its service (CUDA events at its issue and after its
answer)."""

from portbench.yardstick import percentile


def read(ctx):
    reqs = ctx.window.requests
    return percentile([r["latency_ms"] for r in reqs], 95) if reqs else None
