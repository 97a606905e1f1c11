"""`launches_per_step.train`: kernel launches on the host a step of the
traced window."""
from portbench import readers


def read(ctx):
    return readers.launches(ctx, "train")
