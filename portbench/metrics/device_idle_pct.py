"""device_idle_pct.<suffix> (device trace): the share of the measured
window's working time in which no kernel, copy or memset ran on the card,
in percent. The card's busy time a node of work is read from the traced
window (the union of the profiler's device intervals over the nodes of its
steps or served graphs); the working time a node from the measured window,
which runs without the profiler's host cost: the window's length over its
steps' nodes in training, the requests' service time (issue to the answer
on the host, without the wait for a request's arrival) over their served
graphs' nodes in serving."""

from portbench.timeline import busy_seconds


def read(ctx):
    if ctx.timeline is None or not ctx.traced:
        return None
    w = ctx.window
    if w.steps:
        nodes, seconds = sum(s["nodes"] for s in w.steps), w.seconds
    elif w.requests:
        nodes = sum(r["graph_nodes"] for r in w.requests)
        seconds = sum(r["service_ms"] for r in w.requests) / 1e3
    else:
        return None
    busy_per_node = busy_seconds(ctx.timeline) / sum(t["nodes"] for t in ctx.traced)
    return 100.0 * (1.0 - busy_per_node * nodes / seconds)
