"""peak_mem_mib: torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats() at its start, in MiB."""


def read(ctx):
    return ctx.window.mem_peak_bytes / 2 ** 20 if ctx.window.mem_peak_bytes else None
