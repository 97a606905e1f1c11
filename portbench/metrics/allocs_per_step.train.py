"""`allocs_per_step.train`: the caching allocator's allocations a step
(the counter `allocations` of the span `train.step`)."""
from portbench import spans


def read(ctx):
    return spans.step_counter(ctx, "allocations")
