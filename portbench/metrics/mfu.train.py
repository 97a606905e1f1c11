"""`mfu.train`: see `portbench/readers.py` `mfu`."""
from portbench import readers


def read(ctx):
    return readers.mfu(ctx, "train")
