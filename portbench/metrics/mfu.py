"""mfu.<suffix>: the model's operations over the time they took, as a
share of the peak of the configuration's compute type, in percent.
Training (host clock): the forward and backward operations of every step
of the window (yardstick.sgformer_train_flops: the dense layers, the
attention's two products, 2 E F a GCN aggregation; the backward twice the
forward) over the window. Serving (device clock): the forward's operations
(yardstick.sgformer_forward_flops on the served graph) of every request
over the requests' service time (CUDA events at issue and after the
answer)."""

from portbench.yardstick import PEAK_FLOPS, sgformer_forward_flops, sgformer_train_flops


def read(ctx):
    run, w = ctx.run, ctx.window
    if w.steps:
        flops = sum(sgformer_train_flops(run.model, run.in_channels, s["nodes"], s["edges"])
                    for s in w.steps)
        seconds = w.seconds
    elif w.requests:
        flops = sum(sgformer_forward_flops(run.model, run.in_channels, r["graph_nodes"],
                                           r["graph_edges"]) for r in w.requests)
        seconds = sum(r["service_ms"] for r in w.requests) / 1e3
    else:
        return None
    return 100.0 * flops / (seconds * PEAK_FLOPS[run.dtype])
