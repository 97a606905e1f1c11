"""`launches_per_batch.eval`: kernel launches on the host a batch of the
traced window."""
from portbench import readers


def read(ctx):
    return readers.launches(ctx, "eval")
