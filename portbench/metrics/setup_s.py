"""`setup_s`: process start to the first timed call (the kernels' build
on a checkout's first run, the weights, the pool of rooms, the warm-up and,
in a train cell, the first steps the reference follows)."""


def read(ctx):
    return ctx.setup_s
