"""batch_build_ms (device clock): the mean over the window's batches of
the time between CUDA events recorded around the harness's call of
BatchTrainer.build_batch."""

import statistics


def read(ctx):
    builds = [s["build_ms"] for s in ctx.window.steps if "build_ms" in s]
    return statistics.fmean(builds) if builds else None
