"""`decoder_host_ms.eval`: host ms a batch inside the spans `model.decoder`
and `model.heads` of the traced window, over its `eval.forward` spans;
None where there are none (not a traced eval cell, a program without the
trace module, or a model without those spans)."""
from portbench import spans

NAMES = ("model.decoder", "model.heads")


def read(ctx):
    if ctx.kind != "eval" or ctx.trace is None:
        return None
    recs = spans.records()
    calls = sum(1 for r in recs if r.name == "eval.forward")
    inside = [r for r in recs if r.name in NAMES]
    if not calls or not inside:
        return None
    return sum(r.t1_ns - r.t0_ns for r in inside) / (1e6 * calls)
