#!/usr/bin/env python3
"""Times of the PyTorch port's ball query entry points (`ball_query_group`,
`ball_query`) at the eval forward's five shapes, read from three clocks:

- events: CUDA events around 10 back-to-back Python calls, divided by 10
  (what chip_smoke.py's phase 6 reports as a kernel's ms);
- device: the kernel's own time a launch, from a torch.profiler trace of
  the same 10 calls;
- host: the host clock around 100 calls that are not waited for, divided
  by 100 (the wrapper's cost a call, while the card keeps up).

Where events read more than device, the calls are host-bound and events
measure the wrapper. Run on a CUDA card from the root of a checkout:

    python3 scripts/torch_ball_query_times.py [--root DIR] [--out FILE]

`--root` names the checkout whose omni_pq_torch is measured (default: the
one holding this script), so that two commits can be compared in one run on
one card. The inputs are chip_smoke.py's phase 3: the full-width
ModelConfig() eval forward on 16 synthetic 40 000-point scenes from seed 0.
Prints one JSON line (also written to --out).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("torch sees no CUDA card", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from omni_pq_torch import ops
    from omni_pq_torch.config import ModelConfig
    from omni_pq_torch.data import make_batch
    from omni_pq_torch.infer import build_model, eval_forward
    pkg = os.path.dirname(os.path.abspath(ops.__file__))
    if not pkg.startswith(root + os.sep):
        raise RuntimeError(f"imported omni_pq_torch from {pkg}, not {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = ModelConfig()
    batch = make_batch(np.random.default_rng(0), 16, cfg.num_points)
    pc = torch.from_numpy(batch["point_clouds"]).to(dev)
    ep = eval_forward(build_model(cfg, dev, seed=0), pc)
    torch.cuda.synchronize()
    xyz = [pc[..., :3].contiguous(), ep["sa1_xyz"], ep["sa2_xyz"],
           ep["sa3_xyz"], ep["sa4_xyz"]]
    calls = [(f"sa{i + 1}", xyz[i], xyz[i + 1], cfg.backbone_radii[i],
              cfg.backbone_nsamples[i]) for i in range(4)]
    calls.append(("vote_aggregation", ep["vote_xyz"],
                  ep["aggregated_vote_xyz"], 0.3,
                  cfg.vote_aggregation_nsample))
    rows = []
    for entry in ("ball_query_group", "ball_query"):
        fn = getattr(ops, entry)
        for name, x, ctr, r, k in calls:
            def run():
                fn(r, k, x, ctr)
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                run()
            end.record()
            end.synchronize()
            events_ms = start.elapsed_time(end) / 10
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    run()
                torch.cuda.synchronize()
            kern = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and re.search(r"::ball_query_kernel\b", e.key)]
            launches = sum(e.count for e in kern)
            device_ms = (sum(e.self_device_time_total for e in kern) / 1e3
                         / launches if launches else None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                run()
            host_us = (time.perf_counter() - t0) * 1e4
            torch.cuda.synchronize()
            rows.append(dict(entry=entry, call=name,
                             shape=f"B{x.shape[0]} N{x.shape[1]} "
                                   f"S{ctr.shape[1]} K{k} r{r}",
                             events_ms=events_ms, device_ms=device_ms,
                             traced_launches=launches, host_us=host_us))
            print(f"{entry:16s} {name:16s} events {events_ms:.4f} ms  "
                  f"device {device_ms} ms ({launches} launches traced)  "
                  f"host {host_us:.1f} us/call  [{card}]", file=sys.stderr)
    line = json.dumps(dict(card=card, root=root, torch=torch.__version__,
                           rows=rows))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
