"""One traced window of the program, reduced to what the per-layer readers
need: the device's busy time (the union of every kernel, copy and set on
the card), the window's length, the kernels' time by name, the launches
(the host's kernel-launch calls), the device operations that took most
time and the idle gaps labelled by the host op that spans them.

torch.profiler (CUPTI) with CPU and CUDA activities. It may drop a whole
window's device records now and then (seen on the H100): a window with no
device record is traced again after a pause, up to `TRIES` times, as
chip_smoke.py's `device_ms` does.
"""
from __future__ import annotations

import bisect
import re
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

TRIES = 8
LAUNCH = re.compile(r"^cu(da)?Launch\w*Kernel")
GAP_MIN_NS = 2_000  # gaps shorter than this are launch latency, not labelled
LOOK_BACK = 256     # host ops a gap's label is looked for among


@dataclass
class Trace:
    calls: int                      # calls of the timed entry traced
    window_s: float                 # host clock around them, to a sync
    busy_s: float                   # union of the device's activity
    launches: int                   # kernel-launch calls on the host
    kernel_ns: Dict[str, int] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(ns for name, ns in self.kernel_ns.items()
                   if rx.search(name)) / 1e9


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label_gaps(gaps, host_ops):
    """Sum each gap's length under the innermost host op spanning its
    middle (the latest-starting op that contains it, among the LOOK_BACK
    ops that started last before it)."""
    host_ops.sort()
    starts = [s for s, _, _ in host_ops]
    by = defaultdict(int)
    for s, e in gaps:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = "no torch op on the host"
        for i in range(i, max(i - LOOK_BACK, -1), -1):
            if host_ops[i][1] >= mid:
                label = host_ops[i][2]
                break
        by[label] += e - s
    return by


def reduce_events(events, calls: int, window_s: float) -> Trace:
    from torch.autograd import DeviceType
    events = list(events)
    host = [ev for ev in events if ev.device_type() != DeviceType.CUDA]
    # a record_function range shows on the device's timeline too, under
    # its host name: it is no device work
    host_names = {ev.name() for ev in host}
    device, host_ops = [], []
    kernel_ns: Dict[str, int] = defaultdict(int)
    launches = 0
    for ev in events:
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if name in host_names:
                continue
            s = ev.start_ns()
            device.append((s, s + ev.duration_ns()))
            kernel_ns[name] += ev.duration_ns()
        elif LAUNCH.match(name):
            launches += 1
        elif not name.startswith("cu"):  # an op, not a CUDA API call
            s = ev.start_ns()
            host_ops.append((s, s + ev.duration_ns(), name))
    merged = _union(device)
    busy_ns = sum(e - s for s, e in merged)
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])
            if b[0] - a[1] >= GAP_MIN_NS]
    by_gap = _label_gaps(gaps, host_ops)
    top = sorted(kernel_ns.items(), key=lambda kv: -kv[1])[:10]
    return Trace(calls=calls, window_s=window_s, busy_s=busy_ns / 1e9,
                 launches=launches, kernel_ns=dict(kernel_ns),
                 device_ops=[[n, ns / 1e9] for n, ns in top],
                 idle_gaps=[[n, ns / 1e9] for n, ns in
                            sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]])


def trace_calls(fn: Callable[[], None], calls: int, sync: Callable[[], None]
                ) -> Trace:
    """Trace `calls` calls of `fn` (warmed up before), ended by `sync`."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(TRIES):
        if attempt:
            time.sleep(0.2)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sync()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            sync()
            window_s = time.perf_counter() - t0
        tr = reduce_events(prof.profiler.kineto_results.events(), calls,
                           window_s)
        if tr.busy_s > 0:
            return tr
        print(f"[profiler] window {attempt + 1} of {TRIES} held no device "
              "record", file=sys.stderr)
    raise RuntimeError(f"torch.profiler recorded no device activity in "
                       f"{TRIES} windows: the trace is not measured")
