"""attention_roofline.<suffix> (device trace): the linear-attention
kernels' share of their roofline over the traced window: the least time of
each traced step's or request's attention (yardstick.attention_least_s:
the reduce and the apply for each layer and head, at the hidden width and
the compute type, and for a train step their backward reduce and apply
too), over the device time of the kernels below. Their launches are held
to the program's four attention counters."""

from portbench.attribution import family_seconds, roofline_pct
from portbench.yardstick import attention_least_s

KERNELS = (
    "la_reduce_wgmma_kernel", "la_reduce_wg_kernel", "la_finish_kernel", "la_scalars_kernel",
    "split_kvs_kernel", "la_apply_kernel", "la_apply_wg_kernel", "la_apply_wgmma_kernel",
    "la_bwd_split_rows_kernel", "la_bwd_rows_kernel", "la_bwd_rows_ws_kernel",
    "la_bwd_rows_ws16_kernel", "la_bwd_reduce_kernel", "la_bwd_reduce_wg_kernel",
    "la_bwd_reduce_ws16_kernel", "la_bwd_finish_kernel", "la_bwd_dinv_kernel",
    "la_bwd_split_tiles_kernel", "la_bwd_split_atoms_kernel", "la_bwd_apply_kernel",
    "la_bwd_apply_ws_kernel", "la_bwd_apply_ws16_kernel", "la_bwd_apply_wgmma_kernel",
)
# one of these a counted call
ANCHORS = {
    "linear_attention_reduce": ("la_reduce_wgmma_kernel", "la_reduce_wg_kernel"),
    "linear_attention_apply": ("la_apply_kernel", "la_apply_wg_kernel", "la_apply_wgmma_kernel"),
    "linear_attention_bwd_reduce": ("la_bwd_rows_kernel", "la_bwd_rows_ws_kernel",
                                    "la_bwd_rows_ws16_kernel"),
    "linear_attention_bwd_apply": ("la_bwd_apply_kernel", "la_bwd_apply_ws_kernel",
                                   "la_bwd_apply_ws16_kernel", "la_bwd_apply_wgmma_kernel"),
}


def read(ctx):
    if ctx.timeline is None or not ctx.traced:
        return None
    run = ctx.run
    h = run.model["hidden_channels"]
    per_item = run.model["trans_num_layers"] * run.model.get("trans_num_heads", 1)
    least = sum(per_item * attention_least_s(w["nodes"], h, h, run.dtype, w["kind"] == "train")
                for w in ctx.traced)
    return roofline_pct(least, family_seconds(ctx.timeline, KERNELS, ANCHORS, ctx.launches))
