#!/usr/bin/env python3
"""Times of the PyTorch port's FPS and ball query entry points (`fps`,
`ball_query_group`, `ball_query`) at the eval forward's shapes (six FPS
calls, five ball queries), and of the fused SA-MLP kernels
(`ops.fused_mlp.kernel_mlp_pool`) on the four calls of a `fused_sa=True`
eval forward (B=16) and of a train-mode forward (B=3), in float32 and, where
the checkout has `ModelConfig.compute_dtype`, in bfloat16, read from three
clocks:

- events: CUDA events around 10 back-to-back Python calls, divided by 10
  (what chip_smoke.py's phases 6 and 10 report as a kernel's ms);
- device: the kernels' own time a call, from a torch.profiler trace of 10
  more calls: each kernel's mean over its traced launches times its
  launches a call (the traced count over 10, rounded; the profiler may
  drop some records, now and then a whole trace's, which is then taken
  again, up to 8 times), summed over the kernels (a ball query call on rows
  above 2048 points is two kernels, the chunk-box pre-pass and the query; a
  fused train-mode call is its GEMM passes, stats and pool launches);
- host: the host clock around 100 calls (FPS and the fused kernels: 10)
  that are not waited for, divided by their number (the wrapper's cost a
  call, while the card keeps up).

Fused rows add the plain version's time (events; the cuBLAS GEMM +
elementwise chain that fused_sa=False runs).

`--semi` adds the 8 fused calls of one bfloat16 semi-supervised step
(TrainFlags(teacher_bf16=True), student then teacher, B=6: 3 labeled + 3
weak scenes from seeds 0 and 1), chip_smoke.py's phase 15 calls;
`--entries` keeps only the named entry points (e.g. `--entries fused_mlp`).

Where events read more than device, the calls are host-bound and events
measure the wrapper. FPS rows add the device time a step (device / (npoint
- 1)) and, where the checkout's wrapper reports it, the cluster size the
kernel ran with. Run on a CUDA card from the root of a checkout:

    python3 scripts/torch_kernel_times.py [--root DIR] [--out FILE]
        [--entries NAME ...] [--semi]

`--root` names the checkout whose omni_pq_torch is measured (default: the
one holding this script), so that two commits can be compared in one run on
one card. The inputs are chip_smoke.py's phase 3: the full-width
ModelConfig() eval forward on 16 synthetic 40 000-point scenes from seed 0;
the fused train-mode calls come from the first 3 of those scenes, weights
from seed 0 and dropout from a generator seeded 0. Prints one JSON line
(also written to --out).
"""
from __future__ import annotations

import argparse
import dataclasses
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
           "ball_query": r"::(ball_query|chunk_box)_kernel\b",
           # the pass plan's kernels (float32 and bfloat16), and the stats
           # kernel of the train mode's earlier chained design, for A/B runs
           # against it
           "fused_mlp": r"::(fused_mlp(_bf16)?|fused_mlp_stats"
                        r"|mlp_pass(_bf16)?|mlp_stats|mlp_pool)_kernel\b"}
TRAIN_B = 3


def recorded_fused_calls(ops, run):
    """The (args of kernel_mlp_pool) of each fused_mlp_pool call that
    run() makes."""
    import torch
    calls = []
    real = ops.fused_mlp_pool

    def recorder(grouped, weights, scales, biases, ra_means=(), ra_vars=(),
                 *, train, eps=1e-5, dtype=torch.float32):
        calls.append(tuple(t.detach() if torch.is_tensor(t) else
                           [x.detach().clone() for x in t]
                           for t in (grouped, weights, scales, biases,
                                     ra_means, ra_vars)) + (train, eps, dtype))
        return real(grouped, weights, scales, biases, ra_means, ra_vars,
                    train=train, eps=eps, dtype=dtype)
    ops.fused_mlp_pool = recorder
    try:
        run()
    finally:
        ops.fused_mlp_pool = real
    return calls


def fused_calls(ops, model, pc, train, generator=None):
    """The (args of kernel_mlp_pool) of each fused_mlp_pool call of one
    forward of `model`."""
    import torch

    def run():
        with torch.no_grad():
            model.train(train)
            model(pc, generator=generator) if train else model(pc)
    return recorded_fused_calls(ops, run)


def semi_step_calls(ops, cfg, dev):
    """The 8 fused calls (student sa1-sa4, then the teacher's; B=6) of one
    bfloat16 semi-supervised step, TrainFlags(teacher_bf16=True), 3 labeled
    + 3 weak scenes (seeds 0 and 1), as chip_smoke.py's phase 15 runs it."""
    import torch
    from omni_pq_torch.config import SCANNET_MEAN_SIZES
    from omni_pq_torch.data import make_batch
    from omni_pq_torch.infer import build_model
    from omni_pq_torch.train import (OptimizerConfig, TrainFlags, TrainState,
                                     batch_to_tensors, make_train_step)
    labeled, weak = (batch_to_tensors(make_batch(
        np.random.default_rng(i), TRAIN_B, cfg.num_points), dev)
        for i in (0, 1))
    model = build_model(dataclasses.replace(
        cfg, compute_dtype="bfloat16", fused_sa=True), dev, seed=0)
    state = TrainState(model, OptimizerConfig(), ema=True)
    step = make_train_step(model, model.cfg, SCANNET_MEAN_SIZES,
                           TrainFlags(teacher_bf16=True))
    gen = torch.Generator(dev).manual_seed(0)
    return recorded_fused_calls(ops, lambda: step(
        state, labeled, weak, generator=gen, consistency_weight=0.05))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out", default=None)
    ap.add_argument("--entries", nargs="+", default=[
        "fps", "ball_query_group", "ball_query", "fused_mlp"],
        help="the entry points to time")
    ap.add_argument("--semi", action="store_true",
                    help="also the fused calls of a bfloat16 semi-supervised "
                         "step (B=6, student and teacher)")
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
    from omni_pq_torch.ops.fused_mlp import kernel_mlp_pool, plain_mlp_pool
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
    dtypes = (["float32", "bfloat16"] if "compute_dtype" in {
        f.name for f in dataclasses.fields(ModelConfig)} else ["float32"])
    calls["fused_mlp"] = []
    for dt in dtypes:
        fused = build_model(dataclasses.replace(cfg, fused_sa=True, **(
            {"compute_dtype": dt} if dt != "float32" else {})), dev, seed=0)
        calls["fused_mlp"] += [
            (f"sa{i + 1} {'train' if train else 'eval'}"
             + ("" if dt == "float32" else " bf16"), fargs)
            for train, x, gen in (
                (False, pc, None),
                (True, pc[:TRAIN_B], torch.Generator(dev).manual_seed(0)))
            for i, fargs in enumerate(fused_calls(ops, fused, x, train,
                                                  gen))]
        if dt == "bfloat16" and args.semi:
            calls["fused_mlp"] += [
                (f"{who} sa{i % 4 + 1} semi bf16", fargs)
                for i, (who, fargs) in enumerate(zip(
                    ["student"] * 4 + ["teacher"] * 4,
                    semi_step_calls(ops, cfg, dev)))]
    calls = {k: v for k, v in calls.items() if k in args.entries}
    rows = []
    for entry, entry_calls in calls.items():
        fn = kernel_mlp_pool if entry == "fused_mlp" else getattr(ops, entry)
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
            for attempt in range(8):  # a window with none is traced again
                if attempt:
                    time.sleep(0.2)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        run()
                    torch.cuda.synchronize()
                    if attempt:
                        time.sleep(0.05)
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
                                    + e.self_device_time_total / 1e3 / e.count
                                    * max(1, round(e.count / 10)))
            device_ms = sum(by_kernel.values()) if kern else None
            n_host = 100 if entry.startswith("ball_query") else 10
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
            if entry == "fused_mlp":
                g = fargs[0]
                chans = [g.shape[3]] + [w.shape[1] for w in fargs[1]]
                row["shape"] = (f"B{g.shape[0]} S{g.shape[1]} K{g.shape[2]} "
                                f"C{'/'.join(map(str, chans))}")
                with torch.no_grad():
                    plain = lambda: plain_mlp_pool(*fargs)  # noqa: E731
                    plain()
                    torch.cuda.synchronize()
                    start.record()
                    for _ in range(3):
                        plain()
                    end.record()
                    end.synchronize()
                row["plain_ms"] = start.elapsed_time(end) / 3
            elif entry == "fps":
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
