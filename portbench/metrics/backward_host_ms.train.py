"""`backward_host_ms.train`: host ms a step in the backward (span
`step.backward`)."""
from portbench import spans


def read(ctx):
    return spans.host_ms_per_step(ctx, ("step.backward",))
