"""spmm_roofline.<suffix> (device trace): the CSR SpMM kernels' share of
their roofline over the traced window: the least time of every aggregation
of each traced step or request: its GCN aggregations and, for a train
step, their gradients (A^T g), over the step's or the served graph's nodes
and edges, at the configuration's hidden width and compute type
(yardstick.spmm_least_s: x and the CSR read once, the output written
once), over the device time of the kernels below. Their launches are held
to the program's ``csr_spmm`` counter."""

from portbench.attribution import family_seconds, roofline_pct
from portbench.yardstick import spmm_least_s

KERNELS = ("csr_spmm_kernel", "csr_spmm_hub_kernel")
ANCHORS = {"csr_spmm": ("csr_spmm_kernel",)}


def read(ctx):
    if ctx.timeline is None or not ctx.traced:
        return None
    run = ctx.run
    h = run.model["hidden_channels"]
    least = sum(run.model["gnn_num_layers"] * (2 if w["kind"] == "train" else 1)
                * spmm_least_s(w["nodes"], w["edges"], h, run.dtype) for w in ctx.traced)
    return roofline_pct(least, family_seconds(ctx.timeline, KERNELS, ANCHORS, ctx.launches))
