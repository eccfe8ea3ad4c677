"""train_step_ms_p95 and train_step_ms_p95.<suffix> (device clock): the
95th percentile over every step of the window of the time between CUDA events recorded on the
stream just before and just after it, without waiting for them; a batch's
step counts from just before its BatchTrainer.build_batch call."""

from portbench.yardstick import percentile


def read(ctx):
    steps = ctx.window.steps
    return percentile([s["ms"] for s in steps], 95) if steps else None
