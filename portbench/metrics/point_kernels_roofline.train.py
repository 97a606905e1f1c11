"""`point_kernels_roofline.train`: see `portbench/readers.py` `point_kernels_roofline`."""
from portbench import readers


def read(ctx):
    return readers.point_kernels_roofline(ctx, "train")
