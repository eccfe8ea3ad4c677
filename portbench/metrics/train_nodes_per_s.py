"""train_nodes_per_s and train_nodes_per_s.<suffix> (host clock): the nodes of every train step
completed in the window (N a full-graph step; a batch's nodes, the
remainder batch included), over the window, which runs from a sync after
set-up to the sync after the last step."""


def read(ctx):
    steps = ctx.window.steps
    if not steps:
        return None
    return sum(s["nodes"] for s in steps) / ctx.window.seconds
