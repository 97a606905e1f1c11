"""The program's own spans of the traced window (`omni_pq_torch.utils.
trace`, recorded while the profiler runs), reduced to numbers a train step:
the host ms a step spent in spans of given names, and a counter of the
`train.step` spans. A step is one `train.step` span: the sums are divided
by their number, not by the traced calls, so a window traced again counts
its steps too. None where there is nothing to read: not a traced train
cell, a program without the trace module, or no `train.step` span."""
from __future__ import annotations

from typing import Iterable, List, Optional

STEP = "train.step"


def records() -> List:
    """The program's finished spans; [] for a program that has none."""
    try:
        from omni_pq_torch.utils import trace
    except ImportError:
        return []
    return trace.records()


def _steps(ctx, recs) -> int:
    if ctx.kind != "train" or ctx.trace is None:
        return 0
    return sum(1 for r in recs if r.name == STEP)


def host_ms_per_step(ctx, names: Iterable[str]) -> Optional[float]:
    """Host ms a step inside the spans named `names`."""
    recs = records()
    steps = _steps(ctx, recs)
    if not steps:
        return None
    names = set(names)
    return sum(r.t1_ns - r.t0_ns for r in recs if r.name in names) / (
        1e6 * steps)


def step_counter(ctx, counter: str) -> Optional[float]:
    """A `train.step` span's counter, a step; None where no step has it."""
    recs = records()
    steps = [r for r in recs if r.name == STEP and counter in r.counters]
    if not _steps(ctx, recs) or not steps:
        return None
    return sum(r.counters[counter] for r in steps) / len(steps)
