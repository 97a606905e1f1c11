"""`eval_scenes_per_s`: every room of every batch completed in the window
over the window's length."""


def read(ctx):
    if ctx.kind != "eval":
        return None
    return ctx.window.scenes / ctx.window.seconds
