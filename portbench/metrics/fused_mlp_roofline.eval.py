"""`fused_mlp_roofline.eval`: see `portbench/readers.py` `fused_mlp_roofline`."""
from portbench import readers


def read(ctx):
    return readers.fused_mlp_roofline(ctx, "eval")
