#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (omni_pq_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases; any failed check exits non-zero, and the result lines print only
when every phase passed:
  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions; TF32 is switched off for matmuls and cuDNN.
  2. build: every CUDA kernel of the path from omni_pq_torch/csrc, one nvcc
     per source, all started together; prints ptxas' register, shared
     memory and spill report.
  3. main path: the full-width ModelConfig() eval forward on B=16 synthetic
     40 000-point scenes (omni_pq_torch.data.make_batch) with random weights
     from a seeded torch.Generator. The launch counts are set to 0 just
     before the forward and read just after: 6 FPS and 5 ball-query-group
     launches. Every end_points key is finite and every index in range. The
     same forward through the plain versions gives identical end_points.
  4. decode: quad NMS + corner-F1 and the object decode on those scenes.
  5. every kernel against its plain version at each main-path shape, on the
     forward's own inputs: indices bitwise, grouped xyz exact.
  6. times, warmed up: each kernel and its plain version at each shape
     (CUDA events), with the bound (the larger of bytes over 3.35 TB/s and
     operations over 67 TFLOP/s float32); the forward in ms per batch and
     scenes/s (host clock around synchronised calls); peak memory; a
     torch.profiler breakdown of one forward.
The second-last line is the kernels JSON, the last the device JSON. Details
go to chiprun_out/chip_smoke.json and chiprun_out/chip_smoke_profile.txt.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

B = 16                 # the reference's eval batch
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
FPS_OPS_PER_POINT = 10      # 3 sub, 3 mul, 2 add, 1 min, 1 compare
BQ_OPS_PER_POINT = 9        # 3 sub, 3 mul, 2 add, 1 compare
OUT_DIR = os.path.join(ROOT, "chiprun_out")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def gpu_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
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
    """Host clock around `reps` calls that end in a synchronize (the work
    was warmed up before)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def bound_ms(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 2
    from omni_pq_torch import ops
    from omni_pq_torch.config import ModelConfig
    from omni_pq_torch.data import make_batch
    from omni_pq_torch.evals import parse_predictions
    from omni_pq_torch.infer import (EVAL_CONFIG, build_model, eval_forward,
                                     evaluate_quad_f1)
    from omni_pq_torch.models import decoder_prefixes
    from omni_pq_torch.ops import cuda as kernels

    # -- 1. environment
    card = gpu_name_power()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] {card}")
    print(f"[env] torch {torch.__version__} CUDA {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"[env] TF32 off: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "batch": B}

    # -- 2. build
    t0 = time.time()
    kernels.build()
    report["build_s"] = time.time() - t0
    print(f"[build] {len(kernels.build_logs)} kernels in "
          f"{report['build_s']:.1f} s")
    for name, log in kernels.build_logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # -- 3. main path
    cfg = ModelConfig()
    batch = make_batch(np.random.default_rng(SEED), B, cfg.num_points)
    pc = torch.from_numpy(batch["point_clouds"]).to(dev)
    model = build_model(cfg, dev, seed=SEED)
    eval_forward(model, pc)  # warm-up (cuBLAS handles, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.fps.launches = 0
    ops.ball_query_group.launches = 0
    ep = eval_forward(model, pc)
    torch.cuda.synchronize()
    launches = {"fps": ops.fps.launches,
                "ball_query_group": ops.ball_query_group.launches}
    report["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    print(f"[main] launches in one forward: {launches}")
    check(launches == {"fps": 6, "ball_query_group": 5},
          f"expected 6 fps + 5 ball_query_group launches, got {launches}")
    n_keys = 21 + 14 * len(decoder_prefixes(cfg.num_decoder_layers))
    check(len(ep) == n_keys, f"{len(ep)} end_points keys, expected {n_keys}")
    index_range = {"sa1_inds": cfg.num_points,
                   "sa2_inds": cfg.backbone_npoints[0],
                   "fp2_inds": cfg.num_points, "seed_inds": cfg.num_points}
    for k, v in ep.items():
        if v.dtype.is_floating_point:
            check(bool(torch.isfinite(v).all()), f"{k} has non-finite values")
        else:
            check(v.dtype == torch.int32 and k in index_range
                  and int(v.min()) >= 0 and int(v.max()) < index_range[k],
                  f"{k}: indices out of range or unexpected int key")
    print(f"[main] {len(ep)} end_points keys finite, indices in range")
    with ops.plain_versions():
        ep_plain = eval_forward(model, pc)
    torch.cuda.synchronize()
    check(ops.fps.launches == 6 and ops.ball_query_group.launches == 5,
          "the plain-path forward launched a kernel")
    diffs = {k: float((ep[k].double() - ep_plain[k].double()).abs().max())
             for k in ep}
    worst = max(diffs.items(), key=lambda kv: kv[1])
    print(f"[main] kernel vs plain forward: {sum(v > 0 for v in diffs.values())}"
          f" keys differ, largest |diff| {worst[1]} ({worst[0]})")
    report["forward_max_abs_diff"] = diffs
    check(worst[1] == 0.0, "kernel-path forward != plain-path forward: "
          + ", ".join(f"{k} {v}" for k, v in diffs.items() if v > 0))

    # -- 4. decode + corner-F1
    t0 = time.time()
    f1 = evaluate_quad_f1(ep, batch)
    ep_np = {k: v.cpu().numpy() for k, v in ep.items()}
    obj_pred, _ = parse_predictions(ep_np, EVAL_CONFIG, "last_")
    report["decode_s"] = time.time() - t0
    report["quad_f1_random_weights"] = f1["f1"]
    print(f"[decode] quad corner-F1 {f1['f1']} (random weights), "
          f"{int(f1['pred_mask'].sum())} quads kept by NMS, "
          f"{sum(map(len, obj_pred))} object boxes, {report['decode_s']:.2f} s")
    check(np.isfinite(f1["f1"]) and f1["pred_mask"].sum() > 0,
          "decode produced no quads")

    # -- 5. kernels vs plain at the main path's shapes, on its own inputs
    npts, radii, nsamp = (cfg.backbone_npoints, cfg.backbone_radii,
                          cfg.backbone_nsamples)
    xyz = [pc[..., :3].contiguous(), ep["sa1_xyz"], ep["sa2_xyz"],
           ep["sa3_xyz"], ep["sa4_xyz"]]
    fps_calls = [(f"sa{i + 1}", xyz[i], npts[i]) for i in range(4)] + [
        ("quad_queries", ep["seed_xyz"], cfg.num_quad_proposal),
        ("vote_aggregation", ep["vote_xyz"], cfg.num_proposal)]
    bq_calls = [(f"sa{i + 1}", xyz[i], xyz[i + 1], radii[i], nsamp[i])
                for i in range(4)] + [
        ("vote_aggregation", ep["vote_xyz"], ep["aggregated_vote_xyz"], 0.3,
         cfg.vote_aggregation_nsample)]
    rows = {"fps": [], "ball_query_group": []}
    for name, x, npoint in fps_calls:
        got = ops.fps(x, npoint)
        want = ops.fps_plain(x, npoint)
        err = int((got - want).abs().max())
        check(torch.equal(got, want), f"fps {name}: {int((got != want).sum())}"
              " indices differ from the plain version")
        Bx, N, _ = x.shape
        bnd, by = bound_ms(Bx * N * 12 + Bx * npoint * 4,
                           Bx * (npoint - 1) * N * FPS_OPS_PER_POINT)
        rows["fps"].append({"call": name, "shape": f"B{Bx} N{N} -> {npoint}",
                            "max_abs_err": err, "bound_ms": bnd,
                            "bound_by": by, "args": (x, npoint)})
    for name, x, ctr, r, k in bq_calls:
        idx, grouped = ops.ball_query_group(r, k, x, ctr)
        idx_p, grouped_p = ops.ball_query_group_plain(r, k, x, ctr)
        check(torch.equal(idx, idx_p), f"ball_query_group {name}: "
              f"{int((idx != idx_p).sum())} indices differ")
        check(torch.equal(grouped, grouped_p),
              f"ball_query_group {name}: grouped differs")
        check(torch.equal(ops.ball_query(r, k, x, ctr), idx_p),
              f"ball_query (idx only) {name}: indices differ")
        Bx, N, _ = x.shape
        S = ctr.shape[1]
        # data-dependent work: a centre with K hits stops after its K-th
        # hit (its slots are strictly increasing), any other scans all N
        full = (idx_p[..., 1:] > idx_p[..., :-1]).all(-1)
        scanned = torch.where(full, idx_p[..., -1].long() + 1, N).sum()
        bnd, by = bound_ms(Bx * N * 12 + Bx * S * 12 + Bx * S * k * 16,
                           int(scanned) * BQ_OPS_PER_POINT)
        rows["ball_query_group"].append({
            "call": name, "shape": f"B{Bx} N{N} S{S} K{k} r{r}",
            "max_abs_err": max(int((idx - idx_p).abs().max()),
                               float((grouped - grouped_p).abs().max())),
            "scanned_share": int(scanned) / (Bx * S * N),
            "bound_ms": bnd, "bound_by": by, "args": (r, k, x, ctr)})
    print("[check] every kernel equal to its plain version at "
          f"{len(fps_calls)} fps and {len(bq_calls)} ball-query shapes "
          "(tolerance 0: indices and grouped xyz bitwise)")

    # -- 6. times
    for row in rows["fps"]:
        x, npoint = row.pop("args")
        row["ms"] = time_ms(lambda: ops.fps(x, npoint), reps=10)
        row["plain_ms"] = time_ms(lambda: ops.fps_plain(x, npoint), reps=2)
    for row in rows["ball_query_group"]:
        r, k, x, ctr = row.pop("args")
        row["ms"] = time_ms(lambda: ops.ball_query_group(r, k, x, ctr),
                            reps=10)
        row["plain_ms"] = time_ms(
            lambda: ops.ball_query_group_plain(r, k, x, ctr), reps=2)
    for kname, krows in rows.items():
        for row in krows:
            print(f"[time] {kname:16s} {row['call']:16s} {row['shape']:28s} "
                  f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.3f} ms"
                  f"  bound {row['bound_ms']:.4f} ms ({row['bound_by']})  "
                  f"[{card}]")
    fwd_ms = wall_ms_per_call(lambda: eval_forward(model, pc), reps=5)
    with ops.plain_versions():
        plain_fwd_ms = wall_ms_per_call(lambda: eval_forward(model, pc),
                                        reps=1)
    report.update(forward_ms=fwd_ms, scenes_per_s=B / fwd_ms * 1e3,
                  plain_forward_ms=plain_fwd_ms, kernel_rows=rows)
    print(f"[time] forward B={B} N={cfg.num_points}: {fwd_ms:.3f} ms/batch = "
          f"{B / fwd_ms * 1e3:.2f} scenes/s (plain-path forward "
          f"{plain_fwd_ms:.1f} ms), peak memory "
          f"{report['peak_mem_bytes'] / 2**30:.2f} GiB [{card}]")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eval_forward(model, pc)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # kernels (device events) sum to the busy time; the ops that launched
    # them (host events) group that time by layer. The hand-written kernels
    # have no launching op, so they appear as themselves in both lists.
    dev_ms = {e.key: e.self_device_time_total / 1e3 for e in events
              if e.device_type == DeviceType.CUDA}
    op_ms = {e.key: e.self_device_time_total / 1e3 for e in events
             if e.device_type == DeviceType.CPU and e.self_device_time_total > 0}
    op_ms.update({k: v for k, v in dev_ms.items() if "ball_query" in k
                  or "fps_kernel" in k})
    busy_ms = sum(dev_ms.values())
    table = events.table(sort_by="self_device_time_total", row_limit=25)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_profile.txt"), "w") as f:
        f.write(f"{card}\nprofiled forward wall {wall_ms:.3f} ms, device "
                f"kernel time {busy_ms:.3f} ms\n{table}\n")
    report["profile"] = {
        "wall_ms": wall_ms, "device_ms": busy_ms,
        "by_op": sorted(op_ms.items(), key=lambda kv: -kv[1]),
        "by_kernel": sorted(dev_ms.items(), key=lambda kv: -kv[1])[:25]}
    if busy_ms > 0:
        print(f"[profile] one forward: wall {wall_ms:.3f} ms, device kernel "
              f"time {busy_ms:.3f} ms (busy share {busy_ms / wall_ms:.3f})")
        for key, ms in report["profile"]["by_op"][:12]:
            print(f"[profile] {ms:10.3f} ms  {key[:90]}")
    else:
        print("[profile] torch.profiler recorded no device time: not measured")

    summary = []
    for kname, source, replaces in (
            ("fps", "omni_pq_torch/csrc/fps.cu", "omni_pq_tpu/ops/fps.py:50"),
            ("ball_query_group", "omni_pq_torch/csrc/ball_query.cu",
             "omni_pq_tpu/ops/ball_query.py:87")):
        krows = rows[kname]
        bound = sum(r["bound_ms"] for r in krows)
        summary.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in krows),
            "ms": sum(r["ms"] for r in krows),
            "plain_ms": sum(r["plain_ms"] for r in krows),
            "bound_ms": bound,
            "bound_by": max(krows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": None, "matched": True})
    report["kernels"] = summary
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)

    print(gpu_name_power())
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
