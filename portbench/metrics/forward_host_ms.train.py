"""`forward_host_ms.train`: host ms a step in the student's and the
teacher's forwards (spans `step.forward.student`, `step.forward.teacher`)."""
from portbench import spans


def read(ctx):
    return spans.host_ms_per_step(
        ctx, ("step.forward.student", "step.forward.teacher"))
