"""`radius_attention_roofline.eval`: the encoder's radius-masked attention
kernels' least time (the model's `radius_attention_bound_s`: the bytes of
q, k, v, xyz and the output) over their profiler time; None where the
model has no such bound or no kernel matches."""
from portbench import readers

KERNELS = r"::radius_attention\w*_kernel\b"


def read(ctx):
    bound = getattr(ctx.cell.model.counts, "radius_attention_bound_s", None)
    if bound is None:
        return None
    return readers.roofline(ctx, "eval", lambda b: bound(ctx.cell.cfg, b),
                            KERNELS)
