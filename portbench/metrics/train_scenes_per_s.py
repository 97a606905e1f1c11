"""`train_scenes_per_s`: every room trained in the window (a semi step
counts its labeled and its weak rooms) over the window's length."""


def read(ctx):
    if ctx.kind != "train":
        return None
    return ctx.window.scenes / ctx.window.seconds
