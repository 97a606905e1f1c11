#!/usr/bin/env python3
"""Times of the PyTorch port's FPS and ball query entry points (`fps`,
`ball_query_group`, `ball_query`) at the eval forward's shapes (six FPS
calls, five ball queries), read from three clocks:

- events: CUDA events around 10 back-to-back Python calls, divided by 10
  (what chip_smoke.py's phase 6 reports as a kernel's ms);
- device: the kernels' own time a call, from a torch.profiler trace of 10
  more calls: each kernel's mean over its traced launches (the profiler may
  drop some records, now and then a whole trace's, which is then taken
  again, up to 3 times), summed over the kernels (a ball query call on rows
  above 2048 points is two kernels, the chunk-box pre-pass and the query);
- host: the host clock around 100 calls (FPS: 10) that are not waited for,
  divided by their number (the wrapper's cost a call, while the card keeps
  up).

Where events read more than device, the calls are host-bound and events
measure the wrapper. FPS rows add the device time a step (device / (npoint
- 1)) and, where the checkout's wrapper reports it, the cluster size the
kernel ran with. Run on a CUDA card from the root of a checkout:

    python3 scripts/torch_kernel_times.py [--root DIR] [--out FILE]

`--root` names the checkout whose omni_pq_torch is measured (default: the
one holding this script), so that two commits can be compared in one run on
one card. The inputs are chip_smoke.py's phase 3: the full-width
ModelConfig() eval forward on 16 synthetic 40 000-point scenes from seed 0.
Prints one JSON line (also written to --out).
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the kernels of each entry point, as torch.profiler names them
KERNELS = {"fps": r"::fps_kernel\b",
           "ball_query_group": r"::(ball_query|chunk_box)_kernel\b",
           "ball_query": r"::(ball_query|chunk_box)_kernel\b"}


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
    cluster_plan = getattr(importlib.import_module("omni_pq_torch.ops.fps"),
                           "cluster_plan", None)
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
    npts = cfg.backbone_npoints
    calls = {"fps": [(f"sa{i + 1}", (xyz[i], npts[i])) for i in range(4)] + [
        ("quad_queries", (ep["seed_xyz"], cfg.num_quad_proposal)),
        ("vote_aggregation", (ep["vote_xyz"], cfg.num_proposal))]}
    bq = [(f"sa{i + 1}", (cfg.backbone_radii[i], cfg.backbone_nsamples[i],
                          xyz[i], xyz[i + 1])) for i in range(4)]
    bq.append(("vote_aggregation", (0.3, cfg.vote_aggregation_nsample,
                                    ep["vote_xyz"], ep["aggregated_vote_xyz"])))
    calls["ball_query_group"] = calls["ball_query"] = bq
    rows = []
    for entry, entry_calls in calls.items():
        fn = getattr(ops, entry)
        for name, fargs in entry_calls:
            def run():
                fn(*fargs)
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
            for _ in range(3):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        run()
                    torch.cuda.synchronize()
                kern = [e for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA and e.count
                        and re.search(KERNELS[entry], e.key)]
                if kern:
                    break
            launches = sum(e.count for e in kern
                           if "chunk_box" not in e.key)
            by_kernel = {}  # device ms a call, by kernel name
            for e in kern:
                short = re.search(KERNELS[entry], e.key).group(0)[2:]
                by_kernel[short] = (by_kernel.get(short, 0.0)
                                    + e.self_device_time_total / 1e3 / e.count)
            device_ms = sum(by_kernel.values()) if kern else None
            n_host = 10 if entry == "fps" else 100
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_host):
                run()
            host_us = (time.perf_counter() - t0) * 1e6 / n_host
            torch.cuda.synchronize()
            x = fargs[0] if entry == "fps" else fargs[2]
            row = dict(entry=entry, call=name, events_ms=events_ms,
                       device_ms=device_ms, by_kernel=by_kernel,
                       traced_launches=launches, host_us=host_us)
            if entry == "fps":
                npoint = fargs[1]
                row.update(shape=f"B{x.shape[0]} N{x.shape[1]} -> {npoint}",
                           device_us_per_step=(device_ms * 1e3 / (npoint - 1)
                                               if device_ms else None),
                           cluster=(cluster_plan(x.shape[1])
                                    if cluster_plan else None))
            else:
                row["shape"] = (f"B{x.shape[0]} N{x.shape[1]} "
                                f"S{fargs[3].shape[1]} K{fargs[1]} "
                                f"r{fargs[0]}")
            rows.append(row)
            print(f"{entry:16s} {name:16s} {row['shape']:28s} events "
                  f"{events_ms:.4f} ms  device {device_ms} ms ({launches} "
                  f"launches traced, {by_kernel})  host {host_us:.1f} us/call"
                  + (f"  cluster {row['cluster']}  "
                     f"{row['device_us_per_step']} us/step"
                     if entry == "fps" else "") + f"  [{card}]",
                  file=sys.stderr)
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
