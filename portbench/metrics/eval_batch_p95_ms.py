"""`eval_batch_p95_ms`: the 95th percentile of every batch's host-clock
time in the window, each batch ending in a synchronize."""
from portbench.harness import p95


def read(ctx):
    if ctx.kind != "eval":
        return None
    return p95(ctx.window.call_ms)
