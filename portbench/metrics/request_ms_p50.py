"""request_ms_p50: the median of the same request latency as
request_ms_p95."""

from portbench.yardstick import percentile


def read(ctx):
    reqs = ctx.window.requests
    return percentile([r["latency_ms"] for r in reqs], 50) if reqs else None
