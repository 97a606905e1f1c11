"""`graph_replays_per_step.train`: the share of the traced window's steps
that replayed a captured CUDA graph (the counter `graph_replays` of the
span `train.step`: 1 for a replayed call, 0 for an eager or capturing
one); None for a program whose steps have no such counter."""
from portbench import spans


def read(ctx):
    return spans.step_counter(ctx, "graph_replays")
