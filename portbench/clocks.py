"""Clocks of the benchmark: a frozen copy of `chip_smoke.py`'s `time_ms`,
`wall_ms_per_call`, `device_ms` (with its retry of windows that came back
empty, as seen on the H100) and `gpu_name_power`, at commit
4c1c1dacbb14fd55b2b315e6b58815882cf32f9c. The harness times its windows
with the host clock around work that ends in `torch.cuda.synchronize()`
and reads device time from one traced window (`trace.py`); these stay for
the tools and the tests."""
from __future__ import annotations

import re
import subprocess
import sys
import time


def gpu_name_power() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """CUDA events around `reps` calls, ms a call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms_per_call(fn, reps: int) -> float:
    """Host clock around `reps` calls that end in a synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_ms(fn, pattern: str, reps: int = 10, tries: int = 8):
    """The matching kernels' own time a call, from torch.profiler: each
    kernel's mean over its traced launches times its launches a call; a
    window with no matching record is traced again after a pause, up to
    `tries` times. None if every window came back empty."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        if attempt:
            time.sleep(0.2)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            if attempt:
                time.sleep(0.05)
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.count]
        kern = [e for e in events if re.search(pattern, e.key)]
        if kern:
            return sum(e.self_device_time_total / e.count
                       * max(1, round(e.count / reps)) for e in kern) / 1e3
        print(f"[profiler] window {attempt + 1} of {tries} held no kernel "
              f"matching {pattern!r}: {len(events)} device records",
              file=sys.stderr)
    return None
