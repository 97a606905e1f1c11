"""Spans and counters of the port's hot paths, on the profiler's clock.

    with span("step.losses"):
        ...
    with span("train.step", device=torch.device("cuda")):  # + allocations
        ...

Spans are on exactly while a `torch.profiler` profile runs in the process
(a traced window, the train CLI's --profile): the gate is the process-wide
flag that torch's profiler sets (`torch.autograd.profiler.
_is_profiler_enabled`), so a thread that the profiler does not trace still
records its spans in the buffer. Off, `span` returns one shared no-op
object after a single check: no timestamp, no string, no
`record_function`. On, a span opens a profiler range under its name
(`torch._C._profiler._RecordFunctionFast`: `record_function` without an op
dispatch, so its ends lie within microseconds of the span's clock), so it
sits in the profiler's timeline beside the ops and kernels, and appends a
`Record` to an in-memory buffer when it closes: its name, id, the id of its
parent (0 for none) and of its top-level span (its own for a top-level
span, shared by every span of one call), the thread, `t0_ns` and `t1_ns` on
the clock of the profiler's events (`time.time_ns()`, which `start_ns()` of
a kineto event reads within microseconds), and its counters. With `device`
a CUDA device, the counter `allocations` is the change of that device's
caching-allocator `allocation.all.allocated` (the tensors it handed out)
over the span, read outside the span's own range and clock.

The parent stack is per thread; the buffer is shared, holds at most `CAP`
records and counts those it drops (`dropped()`). `records()` returns the
finished spans, `clear()` empties the buffer.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

CAP = 1_000_000


class Record(NamedTuple):
    name: str
    id: int
    parent: int       # 0: a top-level span
    top: int          # the top-level span's id (its own for a top-level)
    thread: int
    t0_ns: int
    t1_ns: int
    counters: Dict[str, int]


_records: List[Record] = []
_dropped = 0
_lock = threading.Lock()  # the buffer's cap and count of drops
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The span while no profiler runs: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


def _allocations(device: torch.device) -> int:
    stats = torch.cuda.memory_stats_as_nested_dict(device)
    # {} until the device's allocator has served a first tensor
    return stats["allocation"]["all"]["allocated"] if stats else 0


class _Span:
    __slots__ = ("name", "device", "id", "parent", "top", "t0", "a0", "rf",
                 "stack")

    def __init__(self, name: str, device: Optional[torch.device]):
        self.name = name
        self.device = (device if device is not None and device.type == "cuda"
                       else None)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        self.id = next(_ids)
        if stack:
            self.parent, self.top = stack[-1].id, stack[-1].top
        else:
            self.parent, self.top = 0, self.id
        stack.append(self)
        if self.device is not None:
            self.a0 = _allocations(self.device)
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.rf.__exit__(*exc)
        counters = {}
        if self.device is not None:
            counters["allocations"] = _allocations(self.device) - self.a0
        self.stack.pop()
        _append(Record(self.name, self.id, self.parent, self.top,
                       threading.get_ident(), self.t0, t1, counters))
        return False


def _append(rec: Record) -> None:
    global _dropped
    with _lock:
        if len(_records) < CAP:
            _records.append(rec)
        else:
            _dropped += 1


def span(name: str, device: Optional[torch.device] = None):
    """A context manager: the span `name` while a profiler runs, else the
    shared no-op `OFF`. `device`: the device whose allocations the span
    counts, if it is a CUDA device (None: no counter)."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _Span(name, device)


def records() -> List[Record]:
    """The finished spans, in the order they closed."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """Spans that closed while the buffer was full."""
    return _dropped


def clear() -> None:
    """Empty the buffer and reset the count of drops."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0
