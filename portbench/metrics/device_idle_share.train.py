"""`device_idle_share.train`: the share of the traced window in which
nothing runs on the card."""
from portbench import readers


def read(ctx):
    return readers.idle_share(ctx, "train")
