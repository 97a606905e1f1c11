"""`update_host_ms.train`: host ms a step in the update: gradient norm,
AdamW, EMA (span `step.update`)."""
from portbench import spans


def read(ctx):
    return spans.host_ms_per_step(ctx, ("step.update",))
