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
     memory and spill report of each kernel (template arguments mangled:
     the bfloat16 pass kernel's <A source bfloat16, columns an item>), and
     fails where ptxas serialises the bfloat16 kernels' wgmma products.
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
     (CUDA events), and the FPS and ball-query kernels' profiler device time
     beside it (below ~0.1 ms the events time the wrapper's dispatch); each
     FPS row's cluster size and device time a step; the bound (the larger
     of bytes over 3.35 TB/s and operations over 67 TFLOP/s float32; the
     ball query's counts the work of the chunk-skipping design: one box test
     a centre and 32-point chunk, and the points of the chunks the box test
     admits up to the K-th hit; rows of up to 2048 points, scanned whole,
     only the points up to the K-th hit); the forward in ms per batch and
     scenes/s (host clock around synchronised calls); peak memory; a
     torch.profiler breakdown of one forward. No kernel's time may read
     below its bound.
  7. fused eval forward: ModelConfig(fused_sa=True), the same seed, weights
     and scenes: 4 fused_mlp_pool calls (sa1-sa4; vote_aggregation's 288
     wide chain stays unfused), sa1-4 and fp2 features within tolerance of
     phase 3's forward, every key finite, vote_aggregation FPS picks that
     moved counted; ms/batch and peak memory of both routes in turns.
  8. train step: the supervised step (omni_pq_torch.train) at full width on
     B=3 labeled scenes, the same initial weights through fused_sa=False and
     fused_sa=True, 3 steps each: finite losses, the first step's total_loss
     and grad_norm of the two routes within tolerance, every fps and
     ball_query_group call of the first step bitwise equal to its plain
     version on the call's own inputs, the ball-query-group backward's
     gradient into vote_xyz non-zero, 4 train-mode fused calls a fused step
     (each L GEMM passes, L stats launches and one pool launch, all seen by
     the profile); warmed ms/step, peak memory and a torch.profiler top-ops
     line of one step for each route.
  9. the fused kernels against their plain version on phases 7 and 8's own
     inputs at every fused shape: eval mode at B=16, train mode at B=3
     (pooled output and batch statistics); the train mode's chains of
     products and scratch from its pass plan.
 10. times of the fused kernels and their plain version (the cuBLAS GEMM +
     elementwise chain that fused_sa=False runs) per shape and mode: CUDA
     events and the profiler's device time of the call's launches, with
     the bound (one chain's operations), and the idx-only ball_query at
     phase 5's five shapes.
 11. ball_query_group_feats (on no model path) at the sa2-sa4 and vote
     aggregation shapes, B=16, on phase 3's points, centres and input
     features: bitwise equal to its plain version (float32 everywhere,
     bfloat16 at sa3), its backward within 1e-6 of the gradient norm of the
     CPU's at sa3 and vote aggregation; kernel (events and profiler device
     time), plain and bound times beside the composition it would replace
     (ball_query_group + group_points).
 12. the semi-supervised step (TrainFlags(): EMA teacher + gamma mixture)
     at full width on 3 labeled + 3 weak scenes, both routes from the same
     weights, 3 steps each: finite stats with the JAX step's names, 12 FPS,
     10 ball-query-group and (fused) 8 fused-MLP launches a step, every fps
     and ball_query_group call of the first step (student and teacher)
     bitwise equal to its plain version on its own inputs, the teacher on
     the EMA rule with its BN stats moved, the fused step's 8 train-mode
     calls (24 passes, 24 stats and 8 pool launches) against their plain
     version; one step each with the fitted
     mixture and the ARKit loss; warmed ms/step in turns, peak memory, a
     profile of one step per route; one step with the last quad head rigged
     so that the gamma criterion engages (gamma_engaged_frac > 0).
 13. bfloat16 serving path: ModelConfig(compute_dtype="bfloat16",
     fused_sa=True) eval forward, B=16, same weights and scenes: 6 FPS, 5
     ball-query and 4 bfloat16 fused launches (counters, and 4
     fused_mlp_bf16_kernel launches in a profile); indices and the quad
     queries bitwise phase 3's (they depend on xyz only); sa1-4/fp2
     features within BF16_ROUTE_NORM_REL of their norm and
     BF16_ROUTE_ELEMENT_OF_MAX of their largest value of the unfused
     bfloat16 forward, while a control (the same forward with each fused
     call the float32 chain, rounded to bfloat16 at its output) falls
     outside the norm bound at every feature; their gap to float32 printed;
     every key finite; vote-aggregation FPS picks that moved counted;
     ms/batch, scenes/s and peak memory in turns against phase 3's float32
     forward.
 14. the bfloat16 eval kernel against its plain bfloat16 version (the
     cuBLAS chain with float32 sums) on phase 13's calls (B=16): pooled
     output within BF16_NORM_REL of its norm and BF16_ELEMENT_OF_MAX of its
     largest value, while the float32 chain rounded at its output falls
     outside the norm bound; CUDA events, profiler device time, the plain
     chain's time and the bound (bytes over 3.35 TB/s, operations over 989
     TFLOP/s dense bfloat16); each call's achieved TFLOP/s and share of
     the bound by device time, and the four calls' sum.
 15. the CLIs' default training configuration: the semi-supervised step
     with a bfloat16 student and TrainFlags(teacher_bf16=True), 3 + 3
     scenes, both routes, 2 steps each: finite stats with the JAX step's
     names, 12 FPS, 10 ball-query and (fused) 8 bfloat16 fused launches;
     the fused step's 8 train-mode calls (student and bfloat16 teacher,
     B=6) held against their plain bfloat16 version as in phase 14 (batch
     statistics too) and timed likewise, beside the pass plan's byte
     floor (the function's bytes and every stored a_j written and read
     back once); warmed ms/step in turns, peak
     memory, a profile of one step per route (kernel time, busy share,
     every bfloat16 pass, stats and pool launch seen).
 16. the float32 fused eval mode at K = 128 and 200 with sa2's widths,
     where a chained tile does not fit in shared memory (the pass plan with
     the running statistics): within 1e-4 of the plain version.
 17. the entry points a user runs, at full ModelConfig() width, on a fake
     ScanNet tree (tests/torch_fake_data.py: 6 train and 3 val scans of
     50 000 vertices) written under build/: the ScanNet loader's host ms a
     batch; `python -m omni_pq_torch.cli.train`'s main() with --ema
     --gamma_mixture (bfloat16, the default), B=3, 2 epochs, in-loop eval
     and checkpoints every epoch, one step profiled; every semi step 12 FPS
     and 10 ball-query-group launches and every eval forward 6 and 5
     (record_group_calls, the kernels' counters set to 0 before each CLI
     and read after), the checkpoints the policy calls for, every metric
     finite; the CLI step's wall and loader-wait ms, the profiled step's
     busy share beside phases 12 and 15, the eval pass's seconds, peak
     memory; cli.eval on ema_best (the policy's, else the epoch-2 file
     tagged so) equal to the in-loop teacher's F1 and loss; a resume from
     epoch 1 (epoch 2 again, within CLI_RESUME_REL, counts carried on);
     cli.infer on a .ply of one scan.
The second-last line is the kernels JSON, the last the device JSON. Details
go to chiprun_out/chip_smoke.json, chiprun_out/chip_smoke_profile.txt,
chiprun_out/chip_smoke_train_profile.txt,
chiprun_out/chip_smoke_semi_profile.txt and
chiprun_out/chip_smoke_bf16_semi_profile.txt.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

B = 16                 # the reference's eval batch
TRAIN_B = 3            # the reference's train batch (--batch_size 3)
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bfloat16 on the tensor cores, dense
FPS_OPS_PER_POINT = 10      # 3 sub, 3 mul, 2 add, 1 min, 1 compare
BQ_OPS_PER_POINT = 9        # 3 sub, 3 mul, 2 add, 1 compare
BQ_BOX_OPS = 18             # a box test: 6 sub, 6 max, 3 mul, 2 add, 1 compare
# the kernels of each timed entry point, as torch.profiler names them (a
# ball query call is the chunk-box pre-pass and the query)
KERNEL_NAMES = {"fps": r"::fps_kernel\b",
                "ball_query": r"::(ball_query|chunk_box)_kernel\b",
                "fused_mlp": r"::(fused_mlp(_bf16)?|mlp_pass(_bf16)?|mlp_stats"
                             r"|mlp_pool)_kernel\b"}
# fused SA-MLP vs its plain version: products summed in another order
FUSED_TOL = dict(rtol=1e-4, atol=1e-4)       # pooled output, batch means
FUSED_VAR_TOL = dict(rtol=1e-4, atol=1e-5)   # batch variances
# the bfloat16 fused kernels against their plain bfloat16 version (cuBLAS,
# float32 sums): each product summed in another order flips a rounding of
# af to bfloat16 by one ulp now and then, and a flip's trace through the
# next layers stays a few ulps on a small share of the values. The bounds
# sit between what the kernels read and what a control reads: the float32
# chain rounded to bfloat16 only at its output, on the same inputs (checked
# to fall outside the norm bound in every run). Measured (H100 80GB HBM3,
# 700 W), at the main path's 12 bf16 calls (eval B=16, the semi step's
# train calls B=6): the pooled output's norm-relative gap 0-8.2e-4, the
# control's 3.8e-3-8.3e-3: bound 2^-9. Batch means within 2^-12 (1 + max
# |mean|), variances 2^-11 relative + 2^-12: the kernels' largest gaps take
# 3.8 % and 6.0 % of these, the control's 3.1-5.9 times them (checked too).
# The largest gap over the largest magnitude reads 0-1.1e-2 and the
# control's 4.6e-3-1.7e-2: it cannot tell the two apart, and is a gross
# bound (a wrong element), 2^-5.
BF16_NORM_REL = 2.0 ** -9
BF16_ELEMENT_OF_MAX = 2.0 ** -5
BF16_MEAN_REL = 2.0 ** -12
BF16_VAR_TOL = dict(rtol=2.0 ** -11, atol=2.0 ** -12)
# the fused bfloat16 forward against the unfused bfloat16 one, end to end
# (sa1-4, fp2 features), against the same control in every fused call:
# measured 0-2.04e-3 of the norm (the flips cascade: sa4 1.4e-3, fp2 2.0e-3)
# and the control 3.76e-3 (sa1)-6.8e-3: bound 2.8e-3; the largest gap over
# the largest magnitude 0-5.9e-3 (control 8.2e-3-1.2e-2), a gross bound 2^-4
BF16_ROUTE_NORM_REL = 2.8e-3
BF16_ROUTE_ELEMENT_OF_MAX = 2.0 ** -4
# the fused eval mode at K where a chained tile does not fit in shared
# memory (it runs the pass plan): sa2's widths at B=2, S=1024
REPAIR_CASES = {"k128_sa2": (2, 1024, 128, 259, (256, 256, 512)),
                "k200_sa2": (2, 1024, 200, 259, (256, 256, 512))}
# the fused route against the unfused one, end to end
ROUTE_FEATURE_TOL = dict(rtol=1e-4, atol=1e-4)  # sa1-4, fp2 (eval forward)
# train mode, the backbone alone (no discrete decision downstream):
# features, and gradients relative to the global gradient norm
ROUTE_TRAIN_FEATURE_TOL = dict(rtol=1e-3, atol=1e-3)
ROUTE_TRAIN_GRAD_TOL = 1e-3
# the whole first step: train-mode BatchNorm amplifies the routes' float32
# noise in vote_xyz to ~1.6e-4, which moves some of vote_aggregation's FPS
# picks (counted and printed), and a moved cluster changes the loss terms
# it feeds. Measured on the H100, the same in every run: 21 picks moved,
# total_loss 0.17 % and grad_norm 6.6 % apart. These bounds only catch a
# gross fault (a lost or doubled loss term); the backbone probe above is
# what holds the fused route's gradients.
ROUTE_STEP_RTOL = {"total_loss": 2e-2, "grad_norm": 0.3}
# ball_query_group_feats' backward on the card against the CPU's, relative
# to the gradient norm (index_add_ adds in no fixed order on the card)
FEATS_BWD_TOL = 1e-6
CONSISTENCY_WEIGHT = 0.05   # the JAX CLI's default --consistency_weight
# the stats the semi-supervised step adds to the supervised step's (the JAX
# step's names, which tests/test_torch_port_semi.py holds the port to)
SEMI_STATS = {
    "metric_normal", "metric_vertical", "metric_size", "metric_score",
    "gamma_mixture_filter_loss", "gamma_engaged_frac",
    "center_consistency_loss", "class_consistency_loss",
    "size_consistency_loss", "consistency_loss",
    "quad_center_consistency_loss_sum", "quad_class_consistency_loss_sum",
    "quad_normal_consistency_loss_sum", "quad_size_consistency_loss_sum",
    "quad_consistency_loss_sum", "weighted_consistency_loss"}
OUT_DIR = os.path.join(ROOT, "chiprun_out")
# phase 17: the fake ScanNet tree (ScanNet's preprocessing cap of 50 000
# vertices a scan, above the 40 000 points the loader samples)
CLI_TRAIN, CLI_VAL, CLI_VERTS = 6, 3, 50000
# the eval CLI on ema_best against the in-loop pass of its epoch: the same
# weights and the same val clouds, so equal but for the order of a
# floating-point reduction, should the card's libraries pick another
CLI_EVAL_REL = 1e-5
# the resumed epoch 2 against the first run's: the loaders draw the scenes'
# 40 000 points and the weak batches again, and dropout and the gamma
# criterion draw from a generator in another state, so only a gross bound
# (a lost or doubled loss term); the resume itself is held by the step and
# optimiser counts of its last checkpoint
CLI_RESUME_REL = 0.25


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


def bound_ms(nbytes: float, nops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def device_ms(fn, pattern: str, reps: int = 10, tries: int = 8):
    """The matching kernels' own time a call: for each kernel whose
    torch.profiler name matches `pattern`, its mean over the launches traced
    in `reps` warmed calls times its launches a call (the traced count over
    `reps`, rounded), summed over the kernels. The profiler may drop some
    launches' records, now and then whole windows' (seen on the H100, up to
    three in a row late in a long run): a window with none is reported on
    stderr and traced again after a pause, up to `tries` times, the later
    windows held open a moment after their synchronize. None if every
    window came back empty."""
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
              f"matching {pattern!r}: {len(events)} device records "
              f"{[e.key[:60] for e in events[:4]]}", file=sys.stderr)
    return None


def bq_work(radius, k, x, ctr, idx):
    """The work of the ball query kernel on these inputs, as (box tests,
    points tested). Rows the kernel does not scan whole (above
    ops.ball_query.scan_max_points()): one box test a centre and
    32-point chunk, and 32 points for each chunk whose box passes the test
    against r2 itself, up to the chunk of the centre's K-th hit (the whole
    row with fewer hits). Smaller rows: no box test, and every chunk up to
    that of the K-th hit. `idx` is the plain version's result."""
    import torch
    from omni_pq_torch.ops.reference import radius_sq
    Bx, N, _ = x.shape
    nch = -(-N // 32)
    scan_max = importlib.import_module(
        "omni_pq_torch.ops.ball_query").scan_max_points()
    # a centre with K hits has strictly increasing slots
    full = (idx[..., 1:] > idx[..., :-1]).all(-1)
    last = torch.where(full, idx[..., -1].long() // 32, nch - 1)
    if N <= scan_max:
        return 0, 32 * int((last + 1).sum())
    # the partial last chunk repeats its last point: its box stays
    rows = torch.cat([x, x[:, -1:].expand(Bx, nch * 32 - N, 3)], 1)
    lo, hi = rows.view(Bx, nch, 32, 3).amin(2), rows.view(Bx, nch, 32, 3).amax(2)
    cols = torch.arange(nch, device=x.device)
    r2 = radius_sq(radius)
    points = 0
    for b in range(Bx):
        c = ctr[b][:, None, :]
        gap = torch.clamp(torch.maximum(lo[b][None] - c, c - hi[b][None]),
                          min=0)
        d2 = (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]
              + gap[..., 2] * gap[..., 2])
        points += 32 * int(((d2 < r2) & (cols[None] <= last[b][:, None]))
                           .sum())
    return Bx * ctr.shape[1] * nch, points


def bq_bound(radius, k, x, ctr, idx, out_bytes_per_slot, read_bytes=0):
    """bound_ms() of a ball query call: the points, the box table, the
    centres and `read_bytes` more read once, the (B,S,K) outputs written
    once; bq_work's operations. Returns (ms, by, box tests, points)."""
    Bx, N, _ = x.shape
    S = ctr.shape[1]
    tests, points = bq_work(radius, k, x, ctr, idx)
    table = Bx * -(-N // 32) * 24 if tests else 0  # only rows with boxes
    nbytes = (Bx * N * 12 + table + Bx * S * 12 + read_bytes
              + Bx * S * k * out_bytes_per_slot)
    return bound_ms(nbytes, tests * BQ_BOX_OPS + points * BQ_OPS_PER_POINT) + (
        tests, points)


def max_violation(got, want, rtol, atol):
    """(largest |got - want|, whether every element is within
    atol + rtol * |want|)."""
    d = (got.double() - want.double()).abs()
    ok = bool((d <= atol + rtol * want.double().abs()).all())
    return float(d.max()) if d.numel() else 0.0, ok


def chain_flops(rows: int, chans) -> int:
    """Operations of one Dense chain over `rows` rows (2 a multiply-add)."""
    return 2 * rows * sum(a * b for a, b in zip(chans[:-1], chans[1:]))


def fused_train_launches(layers, bf16: bool = False) -> dict:
    """The fused kernels' launches of train-mode calls of `layers` layers
    each, by profiler name: each call L GEMM passes (the bfloat16 ones
    where `bf16`), L stats launches and one pool launch; the eval mode's
    chained kernels none."""
    b = "_bf16" if bf16 else ""
    return {"fused_mlp_kernel": 0, "fused_mlp_bf16_kernel": 0,
            f"mlp_pass{b}_kernel": sum(layers),
            "mlp_stats_kernel": sum(layers), "mlp_pool_kernel": len(layers)}


def fused_launch_counts(counted) -> dict:
    return {name: fn.launches for name, fn in counted.items()}


def reset_launch_counts(counted) -> None:
    for fn in counted.values():
        fn.launches = 0


def record_fused_calls(ops, records):
    """Route the models' ops.fused_mlp_pool through a recorder that keeps
    each call's inputs (detached) and calls the real op; returns a function
    that puts the real op back."""
    real = ops.fused_mlp_pool

    def recorder(grouped, weights, scales, biases, ra_means=(), ra_vars=(),
                 *, train, eps=1e-5, dtype=None):
        # clones: the optimiser updates the parameters in place afterwards
        records.append(dict(
            grouped=grouped.detach(),
            weights=[w.detach().clone() for w in weights],
            scales=[t.detach().clone() for t in scales],
            biases=[t.detach().clone() for t in biases],
            ra_means=[t.detach().clone() for t in ra_means],
            ra_vars=[t.detach().clone() for t in ra_vars], train=train,
            eps=eps, dtype=dtype or grouped.dtype))
        return real(grouped, weights, scales, biases, ra_means, ra_vars,
                    train=train, eps=eps, dtype=dtype or grouped.dtype)

    ops.fused_mlp_pool = recorder

    def restore():
        ops.fused_mlp_pool = real
    return restore


def record_group_calls(ops, records):
    """Route the models' ops.fps and ops.ball_query_group through recorders
    that keep each call's inputs and outputs (cloned: the step goes on) and
    return the real op's outputs; returns a function that puts the real ops
    back."""
    real_fps, real_bqg = ops.fps, ops.ball_query_group

    def fps(xyz, npoint):
        inds = real_fps(xyz, npoint)
        records.append(("fps", (xyz.detach().clone(), npoint),
                        (inds.clone(),)))
        return inds

    def ball_query_group(radius, nsample, xyz, new_xyz):
        idx, grouped = real_bqg(radius, nsample, xyz, new_xyz)
        records.append(("ball_query_group",
                        (radius, nsample, xyz.detach().clone(),
                         new_xyz.detach().clone()),
                        (idx.clone(), grouped.detach().clone())))
        return idx, grouped

    ops.fps, ops.ball_query_group = fps, ball_query_group

    def restore():
        ops.fps, ops.ball_query_group = real_fps, real_bqg
    return restore


def check_group_calls(ops, records, where, want):
    """Each recorded fps / ball_query_group call of a main-path step against
    its plain version on the same inputs, on the card: bitwise (indices and
    grouped xyz). `want` is the launch count of each kernel in that step,
    which the number of recorded calls must equal."""
    import torch
    plain = {"fps": ops.fps_plain, "ball_query_group": ops.ball_query_group_plain}
    calls = {name: sum(r[0] == name for r in records) for name in plain}
    check(calls == want, f"{where}: recorded calls {calls}, launches {want}")
    for i, (name, args, outs) in enumerate(records):
        with torch.no_grad():
            ref = plain[name](*args)
        ref = ref if isinstance(ref, tuple) else (ref,)
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        for what, a, b in zip(("indices", "grouped"), outs, ref):
            check(torch.equal(a, b), f"{where}: {name} call {i} {shapes}: "
                  f"{what} differ from the plain version")
    return calls


def fused_forward_phase(cfg, pc, model, ep, counted, card):
    """Phase 7: the fused_sa=True eval forward beside phase 3's."""
    import torch
    from omni_pq_torch import ops
    from omni_pq_torch.infer import build_model, eval_forward
    dev = pc.device
    model_f = build_model(dataclasses.replace(cfg, fused_sa=True), dev,
                          seed=SEED)
    fused_layers = [n for n, m in model_f.named_modules()
                    if getattr(m, "fused", False)]
    check(fused_layers == [f"backbone.sa{i}" for i in range(1, 5)],
          f"fused SA layers {fused_layers}, expected backbone.sa1-sa4")
    eval_forward(model_f, pc)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts(counted)
    ep_f = eval_forward(model_f, pc)
    torch.cuda.synchronize()
    launches = fused_launch_counts(counted)
    peak_f = torch.cuda.max_memory_allocated(dev)
    print(f"[fused] launches in one fused forward: {launches}")
    check(launches == {"fps": 6, "ball_query_group": 5, "fused_mlp_pool": 4},
          f"expected 6 fps + 5 ball_query_group + 4 fused_mlp_pool "
          f"launches, got {launches}")
    check(set(ep_f) == set(ep), "fused forward: other end_points keys")
    feats = ["sa1_features", "sa2_features", "sa3_features", "sa4_features",
             "fp2_features"]
    diffs = {}
    for k, v in ep_f.items():
        if v.dtype.is_floating_point:
            check(bool(torch.isfinite(v).all()), f"fused {k} not finite")
        diffs[k] = float((v.double() - ep[k].double()).abs().max())
    for k in feats:
        worst, ok = max_violation(ep_f[k], ep[k], **ROUTE_FEATURE_TOL)
        check(ok, f"fused forward {k}: |diff| {worst} outside "
                  f"{ROUTE_FEATURE_TOL} of the unfused forward")
    rest = max(((v, k) for k, v in diffs.items() if k not in feats))
    picks = ops.fps(ep["vote_xyz"], cfg.num_proposal)
    picks_f = ops.fps(ep_f["vote_xyz"], cfg.num_proposal)
    moved = int((picks != picks_f).sum())
    print(f"[fused] sa1-4/fp2 features within {ROUTE_FEATURE_TOL} of the "
          f"unfused forward (largest |diff| "
          f"{max(diffs[k] for k in feats):.3e}); all {len(ep_f)} keys "
          f"finite, largest |diff| elsewhere {rest[0]:.3e} ({rest[1]}); "
          f"vote_aggregation FPS picks that moved: {moved} of "
          f"{picks.numel()}")
    # ms/batch of both routes in turns: unfused, fused, fused, unfused
    times = {"unfused": [], "fused": []}
    for route in ("unfused", "fused", "fused", "unfused"):
        m = model if route == "unfused" else model_f
        times[route].append(wall_ms_per_call(lambda: eval_forward(m, pc),
                                             reps=5))
    print(f"[fused] forward B={B}: unfused {times['unfused']} ms, fused "
          f"{times['fused']} ms per batch; peak memory fused "
          f"{peak_f / 2**30:.2f} GiB [{card}]")
    records = []
    restore = record_fused_calls(ops, records)
    try:
        eval_forward(model_f, pc)
    finally:
        restore()
    return dict(launches=launches, feature_max_abs_diff={
        k: diffs[k] for k in feats}, other_max_abs_diff=rest,
        vote_aggregation_fps_moved=moved, forward_ms=times,
        peak_mem_bytes=peak_f), records


def profile_step(run, expect, step_ms):
    """torch.profiler over one call of `run` (after one warm-up call): the
    kernel time of the call, its busy share against `step_ms` (the same
    work's unprofiled wall time: the profiler slows the host, not the
    kernels), the top ops and the hand-written kernels' launches seen, which
    make the profile complete if they equal `expect` ({kernel: launches}).
    Returns (summary dict, the profiler's table)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traced.append(
                     p.key_averages())) as prof:
        for _ in range(2):
            run()
            torch.cuda.synchronize()
            prof.step()
    check(len(traced) == 1, "the profiler traced no step")
    # kernels only: a user annotation (the optimizer's step range, the
    # profiler's step range) also shows as a device event spanning its
    # kernels
    events = [e for e in traced[0] if not e.is_user_annotation
              and not e.key.startswith("ProfilerStep")]
    dev_ms = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA) / 1e3
    ops_ms = sorted(((e.self_device_time_total / 1e3, e.key)
                     for e in events if e.device_type == DeviceType.CPU
                     and e.self_device_time_total > 0), reverse=True)
    kern = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in events if e.device_type == DeviceType.CUDA
                   and re.search(r"::(fused_mlp(_bf16)?|mlp_pass(_bf16)?"
                                 r"|mlp_stats|mlp_pool|ball_query|fps)"
                                 r"_kernel\b", e.key)),
                  reverse=True)
    seen = {name: sum(c for _, c, k in kern
                      if re.search(rf"::{name}\b", k)) for name in expect}
    complete = seen == expect
    line = (f"device kernel time {dev_ms:.3f} ms against {step_ms:.3f} "
            f"ms/step unprofiled (busy share {dev_ms / step_ms:.3f}); "
            f"hand-written kernel launches seen {seen} ("
            f"{'complete' if complete else 'INCOMPLETE: events lost'}); "
            f"top ops " + "; ".join(
                [f"{k[:40]} {v:.2f}" for v, k in ops_ms[:6]]
                + [f"{k[:40]} {v:.2f} x{c}" for v, c, k in kern[:3]]))
    return (dict(device_ms=dev_ms, step_ms=step_ms,
                 busy_share=dev_ms / step_ms, by_op=ops_ms[:12],
                 kernels=kern, kernel_launches_seen=seen, complete=complete,
                 line=line),
            traced[0].table(sort_by="self_device_time_total", row_limit=25))


def route_probe(cfg, labeled, fused: bool):
    """A train-mode forward of fresh seeded weights with the step's dropout
    generator, and the gradients of a fixed linear functional of the
    backbone's features (sa1-4, fp2) w.r.t. the backbone's parameters."""
    import torch
    from omni_pq_torch.infer import build_model
    dev = labeled["point_clouds"].device
    model = build_model(dataclasses.replace(cfg, fused_sa=fused), dev,
                        seed=SEED).train()
    ep = model(labeled["point_clouds"],
               generator=torch.Generator(dev).manual_seed(SEED))
    feats = ["sa1_features", "sa2_features", "sa3_features", "sa4_features",
             "fp2_features"]
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    probe = sum((ep[k] * torch.randn(ep[k].shape, generator=gen,
                                     device=dev)).sum() for k in feats)
    probe.backward()
    return ({k: ep[k].detach() for k in feats + ["vote_xyz"]},
            {n: p.grad.detach() for n, p in model.backbone.named_parameters()})


def train_phase(cfg, dev, counted, card):
    """Phase 8: the supervised train step on both routes."""
    import torch
    from omni_pq_torch import ops
    from omni_pq_torch.config import SCANNET_MEAN_SIZES
    from omni_pq_torch.data import make_batch
    from omni_pq_torch.infer import build_model
    # the module (the package's `ball_query` name is the function)
    bq_module = importlib.import_module("omni_pq_torch.ops.ball_query")
    from omni_pq_torch.train import (OptimizerConfig, batch_to_tensors,
                                     TrainState, make_train_step)
    labeled = batch_to_tensors(
        make_batch(np.random.default_rng(SEED), TRAIN_B, cfg.num_points), dev)
    real_bwd = bq_module.ball_query_group_backward
    routes, records = {}, []
    for route in ("unfused", "fused"):
        model = build_model(dataclasses.replace(cfg, fused_sa=route == "fused"),
                            dev, seed=SEED)
        state = TrainState(model, OptimizerConfig())
        step = make_train_step(model, model.cfg, SCANNET_MEAN_SIZES)
        gen = torch.Generator(dev).manual_seed(SEED)
        bwd_norms = []

        def spy(idx, g, n):
            dxyz, dnew = real_bwd(idx, g, n)
            bwd_norms.append(dxyz.norm())
            return dxyz, dnew
        stats, peak, group_records = [], 0, []
        for i in range(3):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            if i == 0:
                reset_launch_counts(counted)
                bq_module.ball_query_group_backward = spy
                restores = [record_group_calls(ops, group_records)] + (
                    [record_fused_calls(ops, records)]
                    if route == "fused" else [])
            try:
                st = step(state, labeled, generator=gen)
                torch.cuda.synchronize()
            finally:
                if i == 0:
                    bq_module.ball_query_group_backward = real_bwd
                    for restore in reversed(restores):
                        restore()
            if i == 0:
                launches = fused_launch_counts(counted)
                check_group_calls(ops, group_records, f"train {route} step",
                                  {k: launches[k]
                                   for k in ("fps", "ball_query_group")})
                del group_records
            else:
                peak = max(peak, torch.cuda.max_memory_allocated(dev))
            stats.append({k: float(v) for k, v in st.items()})
            check(all(np.isfinite(v) for v in stats[-1].values()),
                  f"{route} step {i + 1}: non-finite stats")
        want = {"fps": 6, "ball_query_group": 5,
                "fused_mlp_pool": 4 if route == "fused" else 0}
        check(launches == want, f"{route} train step launches {launches}, "
                                f"expected {want}")
        check(len(bwd_norms) > 0 and all(float(v) > 0 for v in bwd_norms),
              f"{route}: the ball-query-group backward did not run or gave "
              f"no gradient into vote_xyz ({bwd_norms})")
        routes[route] = dict(model=model, state=state, step=step, gen=gen,
                             stats=stats, launches=launches, peak=peak,
                             bqg_backward_dxyz_norm=[float(v)
                                                     for v in bwd_norms])
        print(f"[train] {route}: step launches {launches}, every fps and "
              f"ball_query_group call of the first step equal to its plain "
              f"version bitwise; "
              f"total_loss {[round(s['total_loss'], 4) for s in stats]} "
              f"grad_norm {[round(s['grad_norm'], 3) for s in stats]}; "
              f"ball-query-group backward |d vote_xyz| "
              f"{routes[route]['bqg_backward_dxyz_norm']}")
    # the two routes' train-mode backbone, forward and backward
    (ep_u, g_u), (ep_f, g_f) = (route_probe(cfg, labeled, False),
                                route_probe(cfg, labeled, True))
    probe = {}
    for k in ep_u:
        if k == "vote_xyz":
            continue
        worst, ok = max_violation(ep_f[k], ep_u[k], **ROUTE_TRAIN_FEATURE_TOL)
        check(ok, f"train-mode {k}: fused vs unfused |diff| {worst}")
        probe[k] = worst
    norm = float(torch.sqrt(sum((g * g).sum() for g in g_u.values())))
    grad_gap = max(float((g_f[n] - g_u[n]).abs().max()) for n in g_u) / norm
    check(grad_gap <= ROUTE_TRAIN_GRAD_TOL,
          f"train-mode backbone gradients: fused vs unfused "
          f"{grad_gap:.2e} of the gradient norm")
    picks = ops.fps(ep_u["vote_xyz"], cfg.num_proposal)
    moved = int((picks != ops.fps(ep_f["vote_xyz"], cfg.num_proposal)).sum())
    vote_gap = float((ep_f["vote_xyz"] - ep_u["vote_xyz"]).abs().max())
    print(f"[train] train-mode backbone, fused vs unfused: features within "
          f"{ROUTE_TRAIN_FEATURE_TOL} (largest |diff| {max(probe.values()):.3e}"
          f"), backbone gradients {grad_gap:.2e} of their norm; vote_xyz "
          f"|diff| {vote_gap:.2e}, vote_aggregation FPS picks that moved: "
          f"{moved} of {picks.numel()}")
    del ep_u, ep_f, g_u, g_f
    first = {k: (routes["unfused"]["stats"][0][k],
                 routes["fused"]["stats"][0][k])
             for k in ("total_loss", "grad_norm")}
    for k, (a, b) in first.items():
        check(abs(a - b) <= ROUTE_STEP_RTOL[k] * abs(a),
              f"first step {k}: unfused {a} vs fused {b}, more than "
              f"{ROUTE_STEP_RTOL[k]} apart")
    print(f"[train] first step, unfused vs fused: " + ", ".join(
        f"{k} {a} vs {b} (rel {abs(a - b) / abs(a):.2e}, tolerance "
        f"{ROUTE_STEP_RTOL[k]})" for k, (a, b) in first.items()))
    # warmed ms/step in turns: unfused, fused, fused, unfused
    times = {"unfused": [], "fused": []}
    for route in ("unfused", "fused", "fused", "unfused"):
        r = routes[route]
        times[route].append(wall_ms_per_call(
            lambda: r["step"](r["state"], labeled, generator=r["gen"]),
            reps=5))
    lines = [card]
    top = {}
    fused_layers = [len(rec["weights"]) for rec in records]
    for route, r in routes.items():
        expect = {"fps_kernel": r["launches"]["fps"],
                  "ball_query_kernel": r["launches"]["ball_query_group"],
                  **fused_train_launches(fused_layers if route == "fused"
                                         else [])}
        top[route], table = profile_step(
            lambda: r["step"](r["state"], labeled, generator=r["gen"]),
            expect, float(np.mean(times[route])))
        print(f"[train] {route} profile of one step: " + top[route]["line"])
        lines.append(f"--- {route} step\n" + table)
        print(f"[train] {route}: {np.mean(times[route]):.3f} ms/step "
              f"({times[route]}), peak memory "
              f"{r['peak'] / 2**30:.2f} GiB [{card}]")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_train_profile.txt"),
              "w") as f:
        f.write("\n".join(lines) + "\n")
    return dict(batch=TRAIN_B, first_step=first, step_ms=times, profile=top,
                backbone_probe=dict(feature_max_abs_diff=probe,
                                    grad_gap_of_norm=grad_gap,
                                    vote_xyz_max_abs_diff=vote_gap,
                                    vote_aggregation_fps_moved=moved),
                routes={k: {kk: v[kk] for kk in ("stats", "launches", "peak",
                                                 "bqg_backward_dxyz_norm")}
                        for k, v in routes.items()}), records


def bf16_gaps(got, want):
    """(norm-relative gap, largest gap over the largest |want|) of a
    bfloat16 result against its reference."""
    g, w = got.double(), want.double()
    return (float((g - w).norm() / w.norm().clamp_min(1e-30)),
            float((g - w).abs().max() / w.abs().max().clamp_min(1e-30)))


def bf16_readings(got, want) -> dict:
    """A bfloat16 fused call's result (pooled, means, variances) against its
    plain version: the pooled output's gaps (bf16_gaps), and the largest
    share of its bound that an element of a batch mean or variance takes
    (1 at the bound)."""
    rel, of_max = bf16_gaps(got[0], want[0])
    mean = [float((a - b).abs().max()) / (BF16_MEAN_REL
                                          * (1 + float(b.abs().max())))
            for a, b in zip(got[1], want[1])]
    var = [float(((a.double() - b.double()).abs()
                  / (BF16_VAR_TOL["atol"]
                     + BF16_VAR_TOL["rtol"] * b.double().abs())).max())
           for a, b in zip(got[2], want[2])]
    return dict(pooled_norm_rel=rel, pooled_of_max=of_max,
                mean_share=max(mean, default=0.0),
                var_share=max(var, default=0.0))


def within_bf16_bounds(r) -> bool:
    return (r["pooled_norm_rel"] <= BF16_NORM_REL
            and r["pooled_of_max"] <= BF16_ELEMENT_OF_MAX
            and r["mean_share"] <= 1 and r["var_share"] <= 1)


def fused_kernel_rows(records, mode, names=None):
    """Phases 9, 12, 14 and 15: the kernel against its plain version on
    recorded inputs (one record per fused SA layer call, named sa1..sa4 in
    call order unless `names` are given), in the call's compute dtype."""
    import torch
    from omni_pq_torch.ops.fused_mlp import (kernel_mlp_pool, pass_plan,
                                            plain_mlp_pool, plan_costs)
    names = names or [f"sa{i + 1}" for i in range(len(records))]
    rows = []
    for name, rec in zip(names, records):
        dt = rec["dtype"]
        args = (rec["grouped"], rec["weights"], rec["scales"],
                rec["biases"], rec["ra_means"], rec["ra_vars"], rec["train"],
                rec["eps"], dt)
        with torch.no_grad():
            got = kernel_mlp_pool(*args)
            torch.cuda.synchronize()
            want = plain_mlp_pool(*args)
        where = f"fused_mlp {mode} {name} ({dt})"
        errs = {"pooled": float((got[0].double()
                                 - want[0].double()).abs().max())}
        for j, (a, b) in enumerate(zip(got[1], want[1])):
            errs[f"mean{j}"] = float((a - b).abs().max())
        for j, (a, b) in enumerate(zip(got[2], want[2])):
            errs[f"var{j}"] = float((a - b).abs().max())
        readings = control = None
        if dt == torch.float32:
            for what, (a, b), tol in (
                    [("pooled", (got[0], want[0]), FUSED_TOL)]
                    + [(f"mean {j}", ab, FUSED_TOL)
                       for j, ab in enumerate(zip(got[1], want[1]))]
                    + [(f"var {j}", ab, FUSED_VAR_TOL)
                       for j, ab in enumerate(zip(got[2], want[2]))]):
                worst, ok = max_violation(a, b, **tol)
                check(ok, f"{where}: {what} |diff| {worst}")
        else:
            check(got[0].dtype == want[0].dtype == dt
                  and bool(torch.isfinite(got[0].float()).all()),
                  f"{where}: pooled dtype {got[0].dtype} or not finite")
            readings = bf16_readings(got, want)
            check(within_bf16_bounds(readings),
                  f"{where}: {readings} outside the bounds {BF16_NORM_REL} "
                  f"/ {BF16_ELEMENT_OF_MAX} (stats: share 1)")
            # the control: the float32 chain, rounded to bfloat16 only at
            # its output, must fall outside the bounds on the pooled norm
            # and (train) the batch statistics
            with torch.no_grad():
                ctrl = plain_mlp_pool(*args[:-1], torch.float32)
            control = bf16_readings((ctrl[0].to(dt), *ctrl[1:]), want)
            del ctrl
            check(control["pooled_norm_rel"] > BF16_NORM_REL and (
                not rec["train"] or min(control["mean_share"],
                                        control["var_share"]) > 1),
                  f"{where}: the float32 chain reads {control} against the "
                  f"plain bfloat16 chain, within the bounds: the check "
                  "cannot tell them apart")
        Bx, S, K, C0 = rec["grouped"].shape
        chans = [C0] + [w.shape[1] for w in rec["weights"]]
        L = len(rec["weights"])
        rows_n = Bx * S * K
        one = chain_flops(rows_n, chans)
        # the kernels' own work: the eval kernel runs the chain once; a
        # train call runs its pass plan (one chain, plus the recompute of
        # a_1 where C0 is tiny), writing and reading back the stored
        # pre-activations (scratch_bytes: the most alive at once)
        ran, scratch = (plan_costs(chans, rows_n, dt) if rec["train"]
                        else (one, 0))
        # the bound counts the function's own bytes: its inputs read once
        # (float32 grouped rows and weights), its outputs (pooled, in the
        # compute dtype; train: float32 batch means and variances) written
        # once; operations at the compute dtype's peak
        nbytes = (4 * (rec["grouped"].numel()
                       + sum(w.numel() for w in rec["weights"])
                       + (2 * sum(chans[1:]) if rec["train"] else 0))
                  + got[0].element_size() * Bx * S * chans[-1])
        bnd, by = bound_ms(nbytes, one, F32_OPS_PER_S if dt == torch.float32
                           else BF16_OPS_PER_S)
        # the pass plan's own floor: it also writes every stored a_j once
        # and reads it back once, so its bytes cannot go below these
        size = torch.finfo(dt).bits // 8
        stored = (sum(size * rows_n * chans[p.layer + 1]
                      for p in pass_plan(chans, dt) if p.store)
                  if rec["train"] else 0)
        floor_ms = (nbytes + 2 * stored) / HBM_BYTES_PER_S * 1e3
        rows.append(dict(call=name, mode=mode, dtype=str(dt),
                         shape=f"B{Bx} S{S} K{K} C{'/'.join(map(str, chans))}",
                         max_abs_err=max(errs.values()), errs=errs,
                         readings=readings, control=control,
                         chain_flops=one, kernel_flops=ran,
                         chains_run=ran / one, scratch_bytes=scratch,
                         stored_bytes=stored, pass_floor_ms=floor_ms,
                         bound_ms=bnd, bound_by=by, args=args))
    return rows


def time_fused_rows(frows, card):
    """Phases 10, 14 and 15: each recorded fused call's kernels (CUDA events,
    and the profiler's device time of the call's launches) beside its plain
    version (the cuBLAS GEMM + elementwise chain that fused_sa=False runs,
    in the call's compute dtype) and its bound."""
    import torch
    from omni_pq_torch.ops.fused_mlp import kernel_mlp_pool, plain_mlp_pool
    for row in frows:
        args = row.pop("args")
        with torch.no_grad():
            row["ms"] = time_ms(lambda: kernel_mlp_pool(*args), reps=5)
            row["device_ms"] = device_ms(lambda: kernel_mlp_pool(*args),
                                         KERNEL_NAMES["fused_mlp"])
            row["plain_ms"] = time_ms(lambda: plain_mlp_pool(*args), reps=3)
        check(row["device_ms"] is not None, f"fused_mlp_pool {row['call']} "
              f"{row['mode']}: the profiler recorded none of its kernels")
        print(f"[time] fused_mlp_pool   {row['call']} {row['mode']:5s} "
              f"{row['dtype'].removeprefix('torch.'):8s} "
              f"{row['shape']:30s} kernel {row['ms']:.3f} ms (device "
              f"{row['device_ms']:.4f})  plain (cuBLAS chain) "
              f"{row['plain_ms']:.3f} ms  bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']}, one chain; the kernels run "
              f"{row['chains_run']:.4f} chains, scratch "
              f"{row['scratch_bytes']} bytes)  [{card}]")
        # achieved rate and share of the bound, by device time; train
        # passes beside their stored-a_j byte floor
        row["tflops"] = row["chain_flops"] / row["device_ms"] / 1e9
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        print(f"[time]   {row['call']} {row['mode']}: {row['tflops']:.1f} "
              f"TFLOP/s of one chain by device time, {row['bound_share']:.3f}"
              f" of its bound" + (
                  f"; the pass plan's byte floor {row['pass_floor_ms']:.4f} "
                  f"ms (stored a_j {row['stored_bytes']} bytes written and "
                  f"read back) beside the bound {row['bound_ms']:.4f} ms"
                  if row["stored_bytes"] else ""))


def print_fused_total(frows, what, card):
    """The summed device time of a phase's fused calls beside their summed
    bound (and, for train calls, the pass plan's byte floor)."""
    dev_ms = sum(r["device_ms"] for r in frows)
    bnd = sum(r["bound_ms"] for r in frows)
    floor = sum(r["pass_floor_ms"] for r in frows)
    print(f"[time] {what}: {len(frows)} calls, device {dev_ms:.4f} ms, bound "
          f"{bnd:.4f} ms ({bnd / dev_ms:.3f} of it), "
          f"{sum(r['chain_flops'] for r in frows) / dev_ms / 1e9:.1f} TFLOP/s"
          + (f"; the pass plan's byte floor {floor:.4f} ms"
             if any(r["stored_bytes"] for r in frows) else "")
          + f"  [{card}]")


def bf16_forward_phase(cfg, pc, model, ep, counted, card):
    """Phase 13: the bfloat16 serving path, ModelConfig(compute_dtype=
    "bfloat16", fused_sa=True), beside the unfused bfloat16 forward and
    phase 3's float32 one."""
    import torch
    from omni_pq_torch import ops
    from omni_pq_torch.infer import build_model, eval_forward
    dev = pc.device
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    model_f = build_model(dataclasses.replace(cfg16, fused_sa=True), dev,
                          seed=SEED)
    model_u = build_model(cfg16, dev, seed=SEED)
    fused_layers = [n for n, m in model_f.named_modules()
                    if getattr(m, "fused", False)]
    check(fused_layers == [f"backbone.sa{i}" for i in range(1, 5)],
          f"bf16 fused SA layers {fused_layers}, expected backbone.sa1-sa4")
    eval_forward(model_f, pc)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts(counted)
    ep_f = eval_forward(model_f, pc)
    torch.cuda.synchronize()
    launches = fused_launch_counts(counted)
    peak_f = torch.cuda.max_memory_allocated(dev)
    print(f"[bf16] launches in one bfloat16 fused forward: {launches}")
    want = {"fps": 6, "ball_query_group": 5, "fused_mlp_pool": 4}
    check({k: launches[k] for k in want} == want,
          f"expected {want} launches, got {launches}")
    kern = fused_eval_kernels(lambda: eval_forward(model_f, pc))
    check(kern == {"fused_mlp_bf16_kernel": 4},
          f"the profile of a bf16 forward saw fused kernels {kern}, "
          "expected 4 fused_mlp_bf16_kernel launches")
    ep_u = eval_forward(model_u, pc)
    torch.cuda.synchronize()
    check(set(ep_f) == set(ep) == set(ep_u), "bf16 forward: other keys")
    for k in ("sa1_inds", "sa2_inds", "fp2_inds", "seed_inds",
              "aggregated_sample_xyz"):
        check(torch.equal(ep_f[k], ep[k]) and torch.equal(ep_u[k], ep[k]),
              f"bf16 forward {k}: not bitwise phase 3's (it depends on xyz "
              "only)")
    for k, v in ep_f.items():
        if v.dtype.is_floating_point:
            check(bool(torch.isfinite(v.float()).all()),
                  f"bf16 fused {k} not finite")
    feats = ["sa1_features", "sa2_features", "sa3_features", "sa4_features",
             "fp2_features"]
    gaps = {}
    for k in feats:
        check(ep_f[k].dtype == torch.bfloat16, f"bf16 {k}: {ep_f[k].dtype}")
        rel, of_max = bf16_gaps(ep_f[k], ep_u[k])
        gaps[k] = (rel, of_max)
        check(rel <= BF16_ROUTE_NORM_REL and of_max
              <= BF16_ROUTE_ELEMENT_OF_MAX,
              f"bf16 fused {k}: {rel:.3e} of its norm, {of_max:.3e} of its "
              f"max from the unfused bf16 forward, outside "
              f"{BF16_ROUTE_NORM_REL} / {BF16_ROUTE_ELEMENT_OF_MAX}")
    # the control: the same forward with each fused call the float32 chain,
    # rounded to bfloat16 only at its output, must fall outside the bound
    real = ops.fused_mlp_pool

    def float32_chain(grouped, weights, scales, biases, ra_means=(),
                      ra_vars=(), *, train, eps=1e-5, dtype=None):
        pooled, means, variances = ops.fused_mlp_pool_plain(
            grouped, weights, scales, biases, ra_means, ra_vars, train=train,
            eps=eps, dtype=torch.float32)
        return pooled.to(dtype), means, variances
    ops.fused_mlp_pool = float32_chain
    try:
        ep_c = eval_forward(model_f, pc)
    finally:
        ops.fused_mlp_pool = real
    control = {k: bf16_gaps(ep_c[k], ep_u[k]) for k in feats}
    del ep_c
    check(all(control[k][0] > BF16_ROUTE_NORM_REL for k in feats),
          f"bf16 forward: with the float32 chain in each fused call the "
          f"features read {control} against the unfused bf16 forward, within "
          f"the bound {BF16_ROUTE_NORM_REL}: the check cannot tell them apart")
    to_f32 = {k: bf16_gaps(ep_u[k].float(), ep[k]) for k in feats}
    picks = ops.fps(ep_u["vote_xyz"], cfg.num_proposal)
    moved = int((picks != ops.fps(ep_f["vote_xyz"], cfg.num_proposal)).sum())
    moved32 = int((ops.fps(ep["vote_xyz"], cfg.num_proposal) != picks).sum())
    print(f"[bf16] indices and quad queries bitwise phase 3's; sa1-4/fp2 "
          f"features of the fused bf16 forward against the unfused bf16 one"
          f" (norm-relative, of the max): "
          + ", ".join(f"{k[:3]} {a:.2e}/{b:.2e}" for k, (a, b) in gaps.items())
          + f" (bounds {BF16_ROUTE_NORM_REL}/{BF16_ROUTE_ELEMENT_OF_MAX}); "
          f"the control (the float32 chain in each fused call) against the "
          f"unfused bf16 one: "
          + ", ".join(f"{k[:3]} {a:.2e}/{b:.2e}"
                      for k, (a, b) in control.items())
          + f"; the unfused bf16 against phase 3's float32: "
          + ", ".join(f"{k[:3]} {a:.2e}/{b:.2e}"
                      for k, (a, b) in to_f32.items())
          + f"; all {len(ep_f)} keys finite; vote_aggregation FPS picks that"
          f" moved: {moved} of {picks.numel()} (fused vs unfused bf16), "
          f"{moved32} (unfused bf16 vs float32)")
    # ms/batch in turns: float32 (phase 3), bf16 fused, bf16 fused, float32
    times = {"float32": [], "bf16_fused": []}
    peaks = {"float32": None, "bf16_fused": peak_f}
    for route in ("float32", "bf16_fused", "bf16_fused", "float32"):
        m = model if route == "float32" else model_f
        times[route].append(wall_ms_per_call(lambda: eval_forward(m, pc),
                                             reps=5))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    eval_forward(model, pc)
    torch.cuda.synchronize()
    peaks["float32"] = torch.cuda.max_memory_allocated(dev)
    unfused_ms = wall_ms_per_call(lambda: eval_forward(model_u, pc), reps=3)
    print(f"[bf16] forward B={B}: float32 {times['float32']} ms, bf16 fused "
          f"{times['bf16_fused']} ms per batch = "
          f"{B / np.mean(times['bf16_fused']) * 1e3:.2f} scenes/s (float32 "
          f"{B / np.mean(times['float32']) * 1e3:.2f}); bf16 unfused "
          f"{unfused_ms:.3f} ms; peak memory bf16 fused "
          f"{peak_f / 2**30:.2f} GiB, float32 {peaks['float32'] / 2**30:.2f}"
          f" GiB [{card}]")
    records = []
    restore = record_fused_calls(ops, records)
    try:
        eval_forward(model_f, pc)
    finally:
        restore()
    return dict(launches=launches, profile_fused_kernels=kern,
                feature_gaps_fused_vs_unfused=gaps,
                feature_gaps_control_vs_unfused=control,
                feature_gaps_bf16_vs_f32=to_f32,
                vote_aggregation_fps_moved=moved,
                vote_aggregation_fps_moved_vs_f32=moved32,
                forward_ms=times, unfused_forward_ms=unfused_ms,
                peak_mem_bytes=peaks), records


def fused_eval_kernels(fn) -> dict:
    """{fused chained-kernel name: launches} of one call of fn, from the
    profiler (counted over 3 calls, rounded)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.key_averages():
        m = re.search(r"::(fused_mlp(_bf16)?_kernel)\b", e.key)
        if m and e.device_type == DeviceType.CUDA:
            counts[m.group(1)] = counts.get(m.group(1), 0) + e.count
    return {k: round(v / 3) for k, v in counts.items()}


def repair_phase(card):
    """Phase 16: the float32 eval mode at K = 128 and 200 with sa2's widths,
    where one centre's chained tile does not fit in shared memory: the pass
    plan with the running statistics, against the plain version."""
    import torch
    from omni_pq_torch import ops
    from omni_pq_torch.ops.fused_mlp import (eval_chained, kernel_mlp_pool,
                                            pass_plan, plain_mlp_pool)
    dev = torch.device("cuda", 0)
    rows = []
    for name, (Bx, S, K, C0, widths) in REPAIR_CASES.items():
        gen = torch.Generator(dev).manual_seed(SEED)
        rnd = lambda *shape: torch.randn(*shape, generator=gen,  # noqa: E731
                                         device=dev)
        chans = [C0, *widths]
        args = (rnd(Bx, S, K, C0),
                [rnd(a, b) / a ** 0.5 for a, b in zip(chans[:-1], chans[1:])],
                [torch.rand(c, generator=gen, device=dev) + 0.5
                 for c in widths],
                [0.1 * rnd(c) for c in widths], [0.2 * rnd(c) for c in widths],
                [torch.rand(c, generator=gen, device=dev) + 0.5
                 for c in widths])
        check(not eval_chained(chans, K), f"repair {name}: the chained "
              "kernel would take it")
        before = ops.fused_mlp_pool.launches
        with torch.no_grad():
            got = ops.fused_mlp_pool(*args, train=False)[0]
            torch.cuda.synchronize()
            want = plain_mlp_pool(*args, False, 1e-5)[0]
        check(ops.fused_mlp_pool.launches == before + 1,
              f"repair {name}: the kernels were not launched")
        worst, ok = max_violation(got, want, **FUSED_TOL)
        check(ok, f"repair {name}: |diff| {worst} outside {FUSED_TOL}")
        ms = time_ms(lambda: kernel_mlp_pool(*args, False, 1e-5), reps=3)
        dms = device_ms(lambda: kernel_mlp_pool(*args, False, 1e-5),
                        KERNEL_NAMES["fused_mlp"], reps=3)
        rows.append(dict(call=name, shape=f"B{Bx} S{S} K{K} "
                         f"C{'/'.join(map(str, chans))}", max_abs_err=worst,
                         passes=len(pass_plan(chans, train=False)), ms=ms,
                         device_ms=dms))
        print(f"[repair] eval K={K} {rows[-1]['shape']}: pass plan "
              f"({rows[-1]['passes']} passes + pool) within {FUSED_TOL} of the"
              f" plain version (largest |diff| {worst:.3e}); {ms:.3f} ms "
              f"(device {dms})  [{card}]")
    return rows


def feats_phase(cfg, ep, card):
    """Phase 11: ball_query_group_feats on the card at the shapes where it
    would replace the SA layers' grouping (sa2-sa4, vote aggregation), on
    phase 3's own points, centres and input features."""
    import torch
    from omni_pq_torch import ops
    radii, nsamp = cfg.backbone_radii, cfg.backbone_nsamples
    calls = [(f"sa{i + 1}", ep[f"sa{i}_xyz"], ep[f"sa{i + 1}_xyz"],
              ep[f"sa{i}_features"], radii[i], nsamp[i]) for i in (1, 2, 3)]
    calls.append(("vote_aggregation", ep["vote_xyz"],
                  ep["aggregated_vote_xyz"], ep["vote_features"], 0.3,
                  cfg.vote_aggregation_nsample))
    gen = torch.Generator(ep["vote_xyz"].device).manual_seed(SEED)
    rows = []
    for name, x, ctr, f, r, k in calls:
        x, ctr, f = x.contiguous(), ctr.contiguous(), f.contiguous()
        variants = [("float32", f)] + ([("bfloat16", f.bfloat16())]
                                       if name == "sa3" else [])
        for dtype, feats in variants:
            got = ops.ball_query_group_feats(r, k, x, ctr, feats)
            torch.cuda.synchronize()
            want = ops.ball_query_group_feats_plain(r, k, x, ctr, feats)
            for what, a, b in zip(("idx", "grouped", "features"), got, want):
                check(torch.equal(a, b), f"ball_query_group_feats {name} "
                      f"{dtype}: {what} differs from the plain version")
            del got, want
        bwd_gap = None
        if name in ("sa3", "vote_aggregation"):
            # the backward on the card against the plain backward on a CPU
            # copy; index_add_ adds in no fixed order on the card
            leaves = [t.detach().clone().requires_grad_()
                      for t in (x, ctr, f)]
            _, grouped, gfeat = ops.ball_query_group_feats(r, k, *leaves)
            cots = [torch.randn(t.shape, generator=gen, device=t.device)
                    for t in (grouped, gfeat)]
            torch.autograd.backward([grouped, gfeat], cots)
            cpu = [t.detach().cpu().clone().requires_grad_()
                   for t in (x, ctr, f)]
            _, grouped, gfeat = ops.ball_query_group_feats(r, k, *cpu)
            torch.autograd.backward([grouped, gfeat],
                                    [c.cpu() for c in cots])
            bwd_gap = max(float((a.grad.cpu() - b.grad).abs().max())
                          / float(b.grad.norm())
                          for a, b in zip(leaves, cpu))
            check(bwd_gap <= FEATS_BWD_TOL, f"ball_query_group_feats {name}"
                  f" backward: {bwd_gap:.2e} of the gradient norm")
            del leaves, cpu, grouped, gfeat, cots
        Bx, N, _ = x.shape
        S, C = ctr.shape[1], f.shape[2]
        idx, _ = ops.ball_query_group_plain(r, k, x, ctr)
        # the query's bound plus the feature bytes: the distinct rows idx
        # names, read once, and the (B,S,K,C) output written once
        row_bytes = C * f.element_size()
        rows_read = torch.unique(idx.long() + N * torch.arange(
            Bx, device=idx.device)[:, None, None]).numel()
        bnd, by, _, _ = bq_bound(r, k, x, ctr, idx, 4 + 12 + row_bytes,
                                 rows_read * row_bytes)

        def composition():
            i, g = ops.ball_query_group(r, k, x, ctr)
            return g, ops.group_points(f, i)
        row = dict(call=name, shape=f"B{Bx} N{N} S{S} K{k} C{C} r{r}",
                   max_abs_err=0, bound_ms=bnd, bound_by=by,
                   feature_rows_read=rows_read, feature_rows=Bx * N,
                   backward_gap_of_norm=bwd_gap,
                   ms=time_ms(lambda: ops.ball_query_group_feats(
                       r, k, x, ctr, f), reps=10),
                   device_ms=device_ms(lambda: ops.ball_query_group_feats(
                       r, k, x, ctr, f), KERNEL_NAMES["ball_query"]),
                   plain_ms=time_ms(lambda: ops.ball_query_group_feats_plain(
                       r, k, x, ctr, f), reps=2),
                   composition_ms=time_ms(composition, reps=10))
        rows.append(row)
        check(row["device_ms"] is not None, f"ball_query_group_feats {name}: "
              "the profiler recorded none of its kernels")
        print(f"[feats] {name:16s} {row['shape']:32s} kernel "
              f"{row['ms']:.4f} ms (device {row['device_ms']:.4f})  plain "
              f"{row['plain_ms']:.3f} ms  "
              f"ball_query_group + group_points {row['composition_ms']:.4f} "
              f"ms  bound {bnd:.4f} ms ({by})  [{card}]")
    print(f"[feats] ball_query_group_feats equal to its plain version "
          f"bitwise at {len(rows)} shapes (float32) and sa3 (bfloat16); "
          f"backward within {FEATS_BWD_TOL} of the gradient norm at sa3 and "
          f"vote_aggregation")
    return rows


def semi_phase(cfg, dev, card, sup_stat_names):
    """Phase 12: the semi-supervised step (TrainFlags(): EMA teacher +
    gamma mixture, fixed criterion) at full width on 3 labeled + 3 weak
    scenes, both routes, then one step with the fitted mixture and one with
    the ARKit loss."""
    import torch
    from omni_pq_torch import ops
    from omni_pq_torch.config import SCANNET_MEAN_SIZES
    from omni_pq_torch.data import make_batch
    from omni_pq_torch.infer import build_model
    from omni_pq_torch.train import (OptimizerConfig, TrainFlags, TrainState,
                                     batch_to_tensors, make_train_step)
    labeled, weak = (batch_to_tensors(make_batch(
        np.random.default_rng(SEED + i), TRAIN_B, cfg.num_points), dev)
        for i in (0, 1))
    counted = {"fps": ops.fps, "ball_query_group": ops.ball_query_group,
               "fused_mlp_pool": ops.fused_mlp_pool,
               "ball_query_group_feats": ops.ball_query_group_feats}
    want_names = set(sup_stat_names) | SEMI_STATS
    flags = TrainFlags()

    def stepper(model, state, step_flags, gen):
        step = make_train_step(model, model.cfg, SCANNET_MEAN_SIZES,
                               step_flags)
        return lambda: step(state, labeled, weak, generator=gen,
                            consistency_weight=CONSISTENCY_WEIGHT)
    routes, records = {}, []
    for route in ("unfused", "fused"):
        model = build_model(dataclasses.replace(cfg, fused_sa=route == "fused"),
                            dev, seed=SEED)
        state = TrainState(model, OptimizerConfig(), ema=True)
        gen = torch.Generator(dev).manual_seed(SEED)
        run = stepper(model, state, flags, gen)
        teacher = state.ema_model
        stats, peak, group_records = [], 0, []
        for i in range(3):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            if i == 0:
                before = {n: t.detach().clone()
                          for n, t in teacher.state_dict().items()}
                reset_launch_counts(counted)
                restores = [record_group_calls(ops, group_records)] + (
                    [record_fused_calls(ops, records)]
                    if route == "fused" else [])
            try:
                st = run()
                torch.cuda.synchronize()
            finally:
                if i == 0:
                    for restore in reversed(restores):
                        restore()
            if i == 0:
                launches = fused_launch_counts(counted)
                # student (B=6, train) and teacher (B=6, train, no grad)
                check_group_calls(ops, group_records, f"semi {route} step",
                                  {k: launches[k]
                                   for k in ("fps", "ball_query_group")})
                del group_records
                # the EMA rule of step 1 (alpha = min(1 - 1/2, decay))
                alpha = float(min(np.float32(1.0) - np.float32(1.0)
                                  / (np.float32(state.step) + 1),
                                  np.float32(flags.ema_decay)))
                student = dict(model.named_parameters())
                with torch.no_grad():
                    ema_gap = max(float((e - (alpha * before[n] + (1 - alpha)
                                              * student[n])).abs().max())
                                  for n, e in teacher.named_parameters())
                ema_moved = sum(not torch.equal(e, before[n])
                                for n, e in teacher.named_parameters())
                bn_moved = sum(not torch.equal(b, before[n])
                               for n, b in teacher.named_buffers()
                               if n.endswith(("running_mean",
                                              "running_var")))
                check(ema_gap <= 1e-6 and ema_moved > 0,
                      f"{route}: teacher parameters off the EMA rule by "
                      f"{ema_gap:.2e} ({ema_moved} tensors moved)")
                check(bn_moved > 0 and not teacher.training,
                      f"{route}: the teacher's BN running stats did not "
                      "move, or it stayed in train mode")
                del before, student
            else:
                peak = max(peak, torch.cuda.max_memory_allocated(dev))
            stats.append({k: float(v) for k, v in st.items()})
            check(all(np.isfinite(v) for v in stats[-1].values()),
                  f"semi {route} step {i + 1}: non-finite stats")
        check(set(stats[0]) == want_names,
              f"semi {route}: stats {sorted(set(stats[0]) ^ want_names)} "
              "differ from the JAX step's set")
        want = {"fps": 12, "ball_query_group": 10,
                "fused_mlp_pool": 8 if route == "fused" else 0,
                "ball_query_group_feats": 0}
        check(launches == want, f"semi {route} step launches {launches}, "
                                f"expected {want}")
        routes[route] = dict(model=model, state=state, gen=gen, run=run,
                             stats=stats, launches=launches, peak=peak,
                             ema_rule_gap=ema_gap, teacher_bn_moved=bn_moved)
        print(f"[semi] {route}: step launches {launches}, every fps and "
              f"ball_query_group call of the first step (student and "
              f"teacher) equal to its plain version bitwise; total_loss "
              f"{[round(x['total_loss'], 4) for x in stats]} grad_norm "
              f"{[round(x['grad_norm'], 3) for x in stats]} "
              f"weighted_consistency_loss "
              f"{[round(x['weighted_consistency_loss'], 5) for x in stats]}"
              f" gamma_engaged_frac "
              f"{[x['gamma_engaged_frac'] for x in stats]}; teacher on the "
              f"EMA rule within {ema_gap:.1e}, {bn_moved} BN stats moved")
    names = ([f"student sa{i}" for i in range(1, 5)]
             + [f"teacher sa{i}" for i in range(1, 5)])
    check(len(records) == 8, f"recorded {len(records)} fused calls in the "
                             "fused semi step, expected 8")
    frows = fused_kernel_rows(records, "train", names)
    for row in frows:
        row.pop("args")
    fused_layers = [len(rec["weights"]) for rec in records]
    del records
    print(f"[semi] the fused step's 8 train-mode calls (student and "
          f"teacher, B={2 * TRAIN_B}) equal to their plain version within "
          f"{FUSED_TOL} (batch variances {FUSED_VAR_TOL}); largest |diff| "
          f"{max(r['max_abs_err'] for r in frows):.3e}")
    # one step each with the fitted mixture and with the ARKit loss
    u = routes["unfused"]
    extra = {}
    for tag, kw in (("use_fitted_mixture", dict(use_fitted_mixture=True)),
                    ("arkit", dict(arkit=True, lambda_arkit_pc_loss=0.1))):
        st = stepper(u["model"], u["state"], TrainFlags(**kw), u["gen"])()
        extra[tag] = {k: float(v) for k, v in st.items()}
        check(all(np.isfinite(v) for v in extra[tag].values()),
              f"semi step with {tag}: non-finite stats")
    check({"arkit_pc_loss", "arkit_collisions"} <= set(extra["arkit"]),
          "the ARKit step has no arkit_pc_loss / arkit_collisions")
    print(f"[semi] use_fitted_mixture step: metric_* "
          f"{[round(extra['use_fitted_mixture'][k], 5) for k in ('metric_normal', 'metric_vertical', 'metric_size', 'metric_score')]}"
          f", engaged {extra['use_fitted_mixture']['gamma_engaged_frac']}; "
          f"arkit step: arkit_pc_loss {extra['arkit']['arkit_pc_loss']:.5f},"
          f" arkit_collisions {extra['arkit']['arkit_collisions']}; all "
          f"stats finite")
    # warmed ms/step in turns: unfused, fused, fused, unfused
    times = {"unfused": [], "fused": []}
    for route in ("unfused", "fused", "fused", "unfused"):
        times[route].append(wall_ms_per_call(routes[route]["run"], reps=3))
    lines = [card]
    top = {}
    for route, r in routes.items():
        expect = {"fps_kernel": 12, "ball_query_kernel": 10,
                  **fused_train_launches(fused_layers if route == "fused"
                                         else [])}
        top[route], table = profile_step(r["run"], expect,
                                         float(np.mean(times[route])))
        lines.append(f"--- semi-supervised {route} step\n" + table)
        print(f"[semi] {route} profile of one step: " + top[route]["line"])
        print(f"[semi] {route}: {np.mean(times[route]):.3f} ms/step "
              f"({times[route]}), peak memory {r['peak'] / 2**30:.2f} GiB "
              f"[{card}]")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_semi_profile.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    # random weights leave the gamma criterion idle (no quad passes its
    # gates): one more default step with the student's last quad head made
    # near-constant (every quad confident, normals along +x, wide and tall,
    # centred on its query point), which engages it on the synthetic rooms'
    # x walls, as tests/test_torch_port_semi.py rigs the small model
    head = u["model"].prediction_quad_heads[-1]
    with torch.no_grad():
        for name, bias in (("quad_scores_head", [0.0, 3.0]),
                           ("normal_vector_head", [1.0, 0.0, 0.0]),
                           ("size_head", [10.0, 10.0]),
                           ("center_head", [0.0, 0.0, 0.0])):
            conv = getattr(head, name)
            conv.weight.mul_(0.01)
            conv.bias.copy_(torch.tensor(bias))
    extra["rigged_quad_head"] = {k: float(v) for k, v in u["run"]().items()}
    rigged = extra["rigged_quad_head"]
    check(all(np.isfinite(v) for v in rigged.values())
          and rigged["gamma_engaged_frac"] > 0,
          f"semi step with the rigged quad head: gamma_engaged_frac "
          f"{rigged['gamma_engaged_frac']}, stats finite: "
          f"{all(np.isfinite(v) for v in rigged.values())}")
    print(f"[semi] rigged quad head step: gamma_engaged_frac "
          f"{rigged['gamma_engaged_frac']}, gamma_mixture_filter_loss "
          f"{rigged['gamma_mixture_filter_loss']:.5f}, metric_* "
          f"{[round(rigged[k], 5) for k in ('metric_normal', 'metric_vertical', 'metric_size', 'metric_score')]}"
          f"; all stats finite")
    return dict(batch=f"{TRAIN_B}+{TRAIN_B}", step_ms=times, profile=top,
                fused_calls=frows, extra_steps=extra,
                routes={k: {kk: v[kk] for kk in (
                    "stats", "launches", "peak", "ema_rule_gap",
                    "teacher_bn_moved")} for k, v in routes.items()})


def bf16_semi_kernel_rows(records, card):
    """Phase 15: the bf16 fused step's 8 calls (student, then the bf16
    teacher; B=6) against their plain bfloat16 version, and their times."""
    check(len(records) == 8, f"recorded {len(records)} fused calls in the "
                             "bf16 fused semi step, expected 8")
    frows = fused_kernel_rows(
        records, "train", [f"{who} sa{i}" for who in ("student", "teacher")
                           for i in range(1, 5)])
    print(f"[bf16 semi] the fused step's 8 train-mode calls (B="
          f"{2 * TRAIN_B}) within {BF16_NORM_REL} of the norm and "
          f"{BF16_ELEMENT_OF_MAX} of the largest value of their plain bf16 "
          f"version (stats within their bounds); norm-relative gaps "
          + ", ".join(f"{r['call']} {r['readings']['pooled_norm_rel']:.2e} "
                      f"(float32 chain {r['control']['pooled_norm_rel']:.2e})"
                      for r in frows))
    time_fused_rows(frows, card)
    print_fused_total(frows, "bf16 pass kernel, the bf16 semi step's calls",
                      card)
    return frows


def bf16_semi_phase(cfg, dev, card, sup_stat_names):
    """Phase 15: the CLIs' default training configuration, the
    semi-supervised step (TrainFlags(teacher_bf16=True): EMA teacher and
    gamma mixture) with a bfloat16 student and a bfloat16 teacher, at full
    width on 3 labeled + 3 weak scenes, both routes from the same weights,
    2 steps each."""
    import torch
    from omni_pq_torch import ops
    from omni_pq_torch.config import SCANNET_MEAN_SIZES
    from omni_pq_torch.data import make_batch
    from omni_pq_torch.infer import build_model
    from omni_pq_torch.train import (OptimizerConfig, TrainFlags, TrainState,
                                     batch_to_tensors, make_train_step)
    labeled, weak = (batch_to_tensors(make_batch(
        np.random.default_rng(SEED + i), TRAIN_B, cfg.num_points), dev)
        for i in (0, 1))
    counted = {"fps": ops.fps, "ball_query_group": ops.ball_query_group,
               "fused_mlp_pool": ops.fused_mlp_pool}
    flags = TrainFlags(teacher_bf16=True)
    want_names = set(sup_stat_names) | SEMI_STATS
    routes, records, frows = {}, [], []
    for route in ("unfused", "fused"):
        model = build_model(dataclasses.replace(
            cfg, compute_dtype="bfloat16", fused_sa=route == "fused"), dev,
            seed=SEED)
        state = TrainState(model, OptimizerConfig(), ema=True)
        gen = torch.Generator(dev).manual_seed(SEED)
        step = make_train_step(model, model.cfg, SCANNET_MEAN_SIZES, flags)

        def run(step=step, state=state, gen=gen):
            return step(state, labeled, weak, generator=gen,
                        consistency_weight=CONSISTENCY_WEIGHT)
        stats, peak = [], 0
        for i in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            if i == 0:
                reset_launch_counts(counted)
                restore = (record_fused_calls(ops, records)
                           if route == "fused" else lambda: None)
            try:
                st = run()
                torch.cuda.synchronize()
            finally:
                if i == 0:
                    restore()
            if i == 0:
                launches = fused_launch_counts(counted)
                if route == "fused":  # before step 2, which reads the peak
                    frows = bf16_semi_kernel_rows(records, card)
                    del records
            else:
                peak = torch.cuda.max_memory_allocated(dev)
            stats.append({k: float(v) for k, v in st.items()})
            check(all(np.isfinite(v) for v in stats[-1].values()),
                  f"bf16 semi {route} step {i + 1}: non-finite stats")
        check(set(stats[0]) == want_names, f"bf16 semi {route}: stats "
              f"{sorted(set(stats[0]) ^ want_names)} differ from the JAX "
              "step's set")
        want = {"fps": 12, "ball_query_group": 10,
                "fused_mlp_pool": 8 if route == "fused" else 0}
        check(launches == want, f"bf16 semi {route} step launches "
                                f"{launches}, expected {want}")
        routes[route] = dict(run=run, stats=stats, launches=launches,
                             peak=peak)
        print(f"[bf16 semi] {route}: step launches {launches}; total_loss "
              f"{[round(x['total_loss'], 4) for x in stats]} grad_norm "
              f"{[round(x['grad_norm'], 3) for x in stats]} "
              f"weighted_consistency_loss "
              f"{[round(x['weighted_consistency_loss'], 5) for x in stats]}"
              f"; all stats finite")
    times = {"unfused": [], "fused": []}
    for route in ("unfused", "fused", "fused", "unfused"):
        times[route].append(wall_ms_per_call(routes[route]["run"], reps=2))
    lines = [card]
    top = {}
    for route, r in routes.items():
        expect = {"fps_kernel": 12, "ball_query_kernel": 10,
                  **fused_train_launches([3] * 8 if route == "fused" else [],
                                         bf16=True)}
        top[route], table = profile_step(r["run"], expect,
                                         float(np.mean(times[route])))
        lines.append(f"--- bfloat16 semi-supervised {route} step\n" + table)
        print(f"[bf16 semi] {route} profile of one step: "
              + top[route]["line"])
        print(f"[bf16 semi] {route}: {np.mean(times[route]):.3f} ms/step "
              f"({times[route]}), peak memory {r['peak'] / 2**30:.2f} GiB "
              f"[{card}]")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_bf16_semi_profile.txt"),
              "w") as f:
        f.write("\n".join(lines) + "\n")
    return dict(batch=f"{TRAIN_B}+{TRAIN_B}", flags="TrainFlags("
                "teacher_bf16=True), compute_dtype bfloat16", step_ms=times,
                profile=top, routes={k: {kk: v[kk] for kk in (
                    "stats", "launches", "peak")} for k, v in routes.items()}
                ), frows


def load_fake_data():
    """tests/torch_fake_data.py (numpy only), by its path: a `tests`
    package installed elsewhere cannot shadow it."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_fake_data", os.path.join(ROOT, "tests", "torch_fake_data.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cli_phase(card, report):
    """Phase 17: the user's path through the entry points on a fake ScanNet
    tree: the train CLI (semi-supervised, bf16 default, in-loop eval,
    checkpoints), the eval CLI on ema_best, a resume, and the infer CLI on
    a .ply."""
    import shutil
    import torch
    from omni_pq_torch import native, ops
    from omni_pq_torch import train as train_pkg
    from omni_pq_torch.cli import eval as eval_cli
    from omni_pq_torch.cli import infer as infer_cli
    from omni_pq_torch.cli import train as train_cli
    from omni_pq_torch.cli.args import parse_option
    from omni_pq_torch.data import Loader, ScannetDetectionDataset
    from omni_pq_torch.infer import build_model
    from omni_pq_torch.train import (OptimizerConfig, TrainState,
                                     load_checkpoint, save_checkpoint)
    from omni_pq_torch.utils.viz import write_ply_points

    dev = torch.device("cuda", 0)
    work = os.path.join(ROOT, "build", "chip_smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    data = os.path.join(work, "scannet")
    scans = [f"scene{i:04d}_00" for i in range(CLI_TRAIN + CLI_VAL)]
    t0 = time.perf_counter()
    load_fake_data().write_fake_scannet(data, scans,
                                        np.random.default_rng(SEED),
                                        n_verts=CLI_VERTS)
    with open(os.path.join(data, "meta_data/scannetv2_train.txt"), "w") as f:
        f.write("\n".join(scans[:CLI_TRAIN]))
    with open(os.path.join(data, "meta_data/scannetv2_val.txt"), "w") as f:
        f.write("\n".join(scans[CLI_TRAIN:]))
    print(f"[cli] fake ScanNet tree: {CLI_TRAIN} train + {CLI_VAL} val scans "
          f"of {CLI_VERTS} vertices, written in "
          f"{time.perf_counter() - t0:.2f} s")

    # the native loader core is built at first use (g++): not a batch's time
    t0 = time.perf_counter()
    native.get_lib()
    print(f"[cli] native loader core ready in {time.perf_counter() - t0:.2f}"
          " s (g++ at first use, or the checkout's earlier build)")
    # the loader alone, on the host: a batch of the train split, no prefetch
    loader = Loader(ScannetDetectionDataset(data, "train", seed=SEED),
                    TRAIN_B, seed=SEED)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    loader_ms = (time.perf_counter() - t0) * 1e3 / n
    print(f"[cli] ScanNet loader: {loader_ms:.1f} ms of host time a batch of "
          f"{TRAIN_B} (40 000 of {CLI_VERTS} points, two views, votes, "
          f"quads; one thread, no prefetch)")

    # every fps / ball_query_group call is counted by the train step or
    # the eval forward that made it (record_group_calls), and the kernels'
    # own counters must add up to those calls
    counted = {"fps": ops.fps, "ball_query_group": ops.ball_query_group,
               "fused_mlp_pool": ops.fused_mlp_pool}
    records, calls = [], {"train_step": [], "eval_forward": []}
    real = {"make_train_step": train_pkg.make_train_step,
            "make_eval_step": train_pkg.make_eval_step,
            "evaluate": train_cli.evaluate}
    eval_s = []

    def counting(kind, fn):
        def call(*a, **kw):
            n0 = len(records)
            out = fn(*a, **kw)
            calls[kind].append({k: sum(r[0] == k for r in records[n0:])
                                for k in ("fps", "ball_query_group")})
            del records[n0:]  # counts only: free the recorded tensors
            return out
        return call

    def timed_evaluate(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        f1 = real["evaluate"](*a, **kw)
        torch.cuda.synchronize()
        eval_s.append(time.perf_counter() - t)
        return f1

    train_pkg.make_train_step = lambda *a, **kw: counting(
        "train_step", real["make_train_step"](*a, **kw))
    train_pkg.make_eval_step = lambda: counting(
        "eval_forward", real["make_eval_step"]())
    train_cli.evaluate = eval_cli.evaluate = timed_evaluate
    restore_ops = record_group_calls(ops, records)

    def drive(what, fn):
        """fn() with the counters at 0 just before, read just after; every
        launch made inside a counted train step or eval forward."""
        for kind in calls:
            calls[kind].clear()
        reset_launch_counts(counted)
        out = fn()
        torch.cuda.synchronize()
        launches = fused_launch_counts(counted)
        seen = {k: sum(c[k] for kind in calls for c in calls[kind])
                for k in ("fps", "ball_query_group")}
        check(launches["fused_mlp_pool"] == 0 and all(
            launches[k] == seen[k] for k in seen), f"{what}: launches "
            f"{launches}, counted in steps and eval forwards {seen}")
        for kind, want in (("train_step", {"fps": 12, "ball_query_group": 10}),
                           ("eval_forward", {"fps": 6,
                                             "ball_query_group": 5})):
            check(all(c == want for c in calls[kind]), f"{what}: {kind} "
                  f"launches {calls[kind]}, expected {want} each")
        return out, launches, {k: len(v) for k, v in calls.items()}

    run = os.path.join(work, "run")
    model_argv = ["--data_root", data]
    train_argv = model_argv + [
        "--ema", "--gamma_mixture", "--batch_size", str(TRAIN_B),
        "--max_epoch", "2", "--end_proportion", "1.0", "--val_freq", "1",
        "--save_freq", "1", "--print_freq", "1"]
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        (max_f1, max_ema_f1), launches, n_calls = drive(
            "train CLI", lambda: train_cli.main(
                train_argv + ["--log_dir", run, "--profile", "1"]))
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        steps = 2 * (CLI_TRAIN // TRAIN_B)
        check(n_calls == {"train_step": steps, "eval_forward": 4},
              f"train CLI: {n_calls}, expected {steps} semi steps and 4 "
              "eval forwards (student and teacher, 2 epochs, one val batch)")
        with open(os.path.join(run, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        bad = [(r["step"], k) for r in recs for k, v in r.items()
               if not np.isfinite(v)]
        check(not bad, f"train CLI: non-finite metrics {bad[:5]}")
        train_recs = [r for r in recs if "train/total_loss" in r]
        evals = [r for r in recs if "eval/quad_f1" in r]
        check([r["eval/epoch"] for r in evals] == [1, 2], "train CLI: "
              f"in-loop evals at epochs {[r['eval/epoch'] for r in evals]}")
        for tag in ("student", "ema"):
            got = [r["step"] for r in recs if f"eval_{tag}/loss" in r]
            check(got == [1, 2], f"train CLI: eval_{tag}/ loss means at "
                  f"epochs {got}, expected [1, 2]")
        # the checkpoint policy: periodic 1 and 2, last, best when the
        # student's F1 rose above 0, ema_best when the teacher's above 0.2
        want = {"1", "2", "last"}
        if max(r["eval/quad_f1"] for r in evals) > 0:
            want.add("best")
        if max(r["eval/ema_quad_f1"] for r in evals) > 0.2:
            want.add("ema_best")
        got = {f[len("ckpt_epoch_"):-len(".pth")] for f in os.listdir(run)
               if f.endswith(".pth")}
        check(got == want, f"train CLI: checkpoints {sorted(got)}, the "
              f"policy calls for {sorted(want)}")
        with open(os.path.join(run, "profile", "summary.json")) as f:
            prof = json.load(f)
        step_ms = [r["train/step_ms"] for r in train_recs]
        data_ms = [r["train/data_ms"] for r in train_recs]
        # the profiler slows the host: its device time over the wall of
        # the steps that were neither warm-up nor profiled, too
        steady_ms = float(np.mean(step_ms[2:]))
        phase12 = report["semi"]["profile"]["unfused"]
        phase15 = report["bf16_semi"]["profile"]["unfused"]
        print(f"[cli] train CLI: {steps} semi steps (bf16, --ema "
              f"--gamma_mixture, B={TRAIN_B}+{TRAIN_B}) and 4 eval forwards "
              f"in {train_s:.1f} s; launches {launches}: every semi step 12 "
              f"FPS and 10 ball-query-group, every eval forward 6 and 5; "
              f"checkpoints {sorted(got)}; in-loop quad F1 "
              f"{[r['eval/quad_f1'] for r in evals]}, teacher "
              f"{[r['eval/ema_quad_f1'] for r in evals]}; total_loss "
              f"{[round(r['train/total_loss'], 4) for r in train_recs]}")
        print(f"[cli] CLI step wall ms {[round(x, 1) for x in step_ms]} "
              f"(step 1 warms up; step 2 is profiled), of which waiting for "
              f"the loaders {[round(x, 1) for x in data_ms]} ms [{card}]")
        print(f"[cli] profiled CLI step (PrefetchLoader feeding, wait "
              f"included): device kernel time {prof['device_ms']:.3f} ms in "
              f"{prof['wall_ms']:.3f} ms profiled, busy share "
              f"{prof['busy_share']:.3f}; over the unprofiled steps' "
              f"{steady_ms:.1f} ms {prof['device_ms'] / steady_ms:.3f}, "
              f"beside phase 12's float32 step {phase12['busy_share']:.3f} "
              f"and phase 15's bf16 step {phase15['busy_share']:.3f} "
              f"(unprofiled wall) [{card}]")
        train_eval_s = list(eval_s)
        print(f"[cli] in-loop eval pass: "
              f"{[round(s, 3) for s in train_eval_s]} s, "
              f"one val batch of {CLI_VAL} each; peak memory "
              f"{peak / 2**30:.2f} GiB [{card}]")

        # the eval CLI on ema_best: the teacher of its epoch, the same val
        # clouds as the in-loop pass (each pass draws them from the seed)
        ema_path = os.path.join(run, "ckpt_epoch_ema_best.pth")
        ema_epoch = next((r["eval/epoch"] for r in evals
                          if r["eval/ema_quad_f1"] == max_ema_f1), None)
        if "ema_best" not in got:
            # the policy wrote none (the teacher's F1 stayed at or below
            # 0.2): the epoch-2 file, tagged ema_best
            ema_epoch = 2
            state = TrainState(build_model(train_cli.make_model_config(
                parse_option(train_argv)), dev), OptimizerConfig(), ema=True)
            load_checkpoint(os.path.join(run, "ckpt_epoch_2.pth"), state)
            ema_path = save_checkpoint(os.path.join(work, "ema_best"),
                                       "ema_best", state, 2)
            del state
        eval_dir = os.path.join(work, "eval")
        f1, _, n_calls = drive("eval CLI", lambda: eval_cli.main(
            model_argv + ["--log_dir", eval_dir, "--checkpoint_path",
                          ema_path]))
        check(n_calls == {"train_step": 0, "eval_forward": 1},
              f"eval CLI: {n_calls}")
        with open(os.path.join(eval_dir, "metrics.jsonl")) as f:
            erecs = [json.loads(line) for line in f]
        got_loss = next(r["eval_ema/loss"] for r in erecs
                        if "eval_ema/loss" in r)
        in_loop = next(r for r in recs if r["step"] == ema_epoch
                       and "eval_ema/loss" in r)["eval_ema/loss"]
        want_f1 = next(r["eval/ema_quad_f1"] for r in evals
                       if r["eval/epoch"] == ema_epoch)
        loss_gap = abs(got_loss - in_loop) / abs(in_loop)
        check(np.isfinite(f1) and f1 == want_f1 and loss_gap <= CLI_EVAL_REL,
              f"eval CLI on ema_best: F1 {f1} (in-loop teacher of epoch "
              f"{ema_epoch}: {want_f1}), eval_ema/loss {got_loss} vs "
              f"{in_loop} (relative {loss_gap:.2e}, bound {CLI_EVAL_REL})")
        print(f"[cli] eval CLI on ema_best ("
              f"{'the policy' if 'ema_best' in got else 'epoch 2 tagged'}"
              f", the teacher of epoch {ema_epoch}): F1 {f1} equal to the "
              f"in-loop teacher's; eval_ema/loss {got_loss:.6f} vs in-loop "
              f"{in_loop:.6f}, relative {loss_gap:.2e} (bound "
              f"{CLI_EVAL_REL})")

        # resume from epoch 1: epoch 2 runs again, the counts carry on
        rerun = os.path.join(work, "resumed")
        _, _, n_calls = drive("resumed train CLI", lambda: train_cli.main(
            train_argv + ["--log_dir", rerun, "--checkpoint_path",
                          os.path.join(run, "ckpt_epoch_1.pth")]))
        half = steps // 2
        check(n_calls == {"train_step": half, "eval_forward": 2},
              f"resumed train CLI: {n_calls}")
        with open(os.path.join(rerun, "metrics.jsonl")) as f:
            rrecs = [json.loads(line) for line in f]
        resumed = [r["train/total_loss"] for r in rrecs
                   if "train/total_loss" in r]
        first = [r["train/total_loss"] for r in train_recs][half:]
        gap = abs(np.mean(resumed) - np.mean(first)) / abs(np.mean(first))
        last = torch.load(os.path.join(rerun, "ckpt_epoch_last.pth"),
                          map_location="cpu", weights_only=True)
        check(len(resumed) == half and gap <= CLI_RESUME_REL
              and last["step"] == steps
              and last["optimizer"]["count"] == steps,
              f"resume: epoch-2 total_loss {resumed} vs {first} (relative "
              f"{gap:.3f}, bound {CLI_RESUME_REL}), last step "
              f"{last['step']}, optimiser count "
              f"{last['optimizer']['count']}, expected {steps}")
        print(f"[cli] resume from ckpt_epoch_1.pth: epoch 2 again, "
              f"total_loss {[round(x, 4) for x in resumed]} against the "
              f"first run's {[round(x, 4) for x in first]} (mean relative "
              f"gap {gap:.3f}, bound {CLI_RESUME_REL}: the scenes are drawn "
              f"again, and the card's steps are not bitwise repeatable); "
              f"the last checkpoint's step and optimiser count {steps}")
        del last

        # infer on a .ply written from one scan
        verts = np.load(os.path.join(
            data, "scannet_train_detection_data", f"{scans[0]}_vert.npy"))
        ply = os.path.join(work, "scene.ply")
        write_ply_points(verts[:, :3], ply, verts[:, 3:6])
        reset_launch_counts(counted)  # one forward, outside the counted
        quads, objects = infer_cli.main([
            "--checkpoint_path", os.path.join(run, "ckpt_epoch_last.pth"),
            "--input", ply, "--output", os.path.join(work, "det.json"),
            "--dump_ply", os.path.join(work, "ply")])
        torch.cuda.synchronize()
        launches = fused_launch_counts(counted)
        check(launches == {"fps": 6, "ball_query_group": 5,
                           "fused_mlp_pool": 0},
              f"infer CLI: launches {launches}")
        with open(os.path.join(work, "det.json")) as f:
            det = json.load(f)
        check(det == {"quads": quads, "objects": objects} and all(
            np.isfinite(q["center"] + q["normal"] + q["size"]).all()
            for q in quads), "infer CLI: detections not as returned, or "
            "not finite")
        print(f"[cli] infer CLI on a .ply of {len(verts)} points: "
              f"{len(quads)} quads, {len(objects)} objects above 0.5, "
              f"launches {launches}")
    finally:
        restore_ops()
        train_pkg.make_train_step = real["make_train_step"]
        train_pkg.make_eval_step = real["make_eval_step"]
        train_cli.evaluate = eval_cli.evaluate = real["evaluate"]
        shutil.rmtree(work, ignore_errors=True)
    return dict(loader_host_ms=loader_ms, step_ms=step_ms, data_ms=data_ms,
                busy_share_unprofiled=prof["device_ms"] / steady_ms,
                profile=prof, eval_pass_s=train_eval_s, peak_mem_bytes=peak,
                train_s=train_s, checkpoints=sorted(got),
                eval_cli_f1=f1, eval_cli_loss_gap=loss_gap,
                resume_gap=gap, quads=len(quads))


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
        entry = "?"
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:  # the kernel's name and template arguments, mangled
                k = re.search(r"(\w+_kernel)(I\w*E)?", m.group(1))
                entry = (k.group(1) + (k.group(2) or "")) if k else m.group(1)
            if "Used" in line or "spill" in line:
                print(f"[build] {name} {entry}: {line.strip()}")
    # ptxas serialises a kernel's wgmma products (runs each to its end
    # before the next) where it cannot keep them in flight: C7510-C7519
    serialised = [line.strip() for line in
                  kernels.build_logs["fused_mlp_bf16"].splitlines()
                  if "Potential Performance Loss" in line]
    print(f"[build] fused_mlp_bf16 wgmma serialisation warnings: "
          f"{serialised or 'none'}")
    check(not serialised, "ptxas serialises the bfloat16 kernels' wgmma "
          "products")

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
        # data-dependent work of the chunk-skipping design (bq_work)
        bnd, by, tests, points = bq_bound(r, k, x, ctr, idx_p, 4 + 12)
        rows["ball_query_group"].append({
            "call": name, "shape": f"B{Bx} N{N} S{S} K{k} r{r}",
            "max_abs_err": max(int((idx - idx_p).abs().max()),
                               float((grouped - grouped_p).abs().max())),
            "box_tests": tests, "points_tested": points,
            "tested_share": points / (Bx * S * N),
            "bound_ms": bnd, "bound_by": by, "args": (r, k, x, ctr),
            "idx": idx_p})
    print("[check] every kernel equal to its plain version at "
          f"{len(fps_calls)} fps and {len(bq_calls)} ball-query shapes "
          "(tolerance 0: indices and grouped xyz bitwise)")

    # -- 6. times
    fps_module = importlib.import_module("omni_pq_torch.ops.fps")
    for row in rows["fps"]:
        x, npoint = row.pop("args")
        row["ms"] = time_ms(lambda: ops.fps(x, npoint), reps=10)
        row["device_ms"] = device_ms(lambda: ops.fps(x, npoint),
                                     KERNEL_NAMES["fps"])
        check(row["device_ms"] is not None, f"fps {row['call']}: the "
              "profiler recorded no fps kernel: device time not measured")
        row["plain_ms"] = time_ms(lambda: ops.fps_plain(x, npoint), reps=2)
        row["cluster"], row["threads"], _ = fps_module.cluster_plan(
            x.shape[1])
        row["device_us_per_step"] = row["device_ms"] * 1e3 / (npoint - 1)
    rows["ball_query"] = []  # the idx-only entry point of the same kernel
    for row in rows["ball_query_group"]:
        r, k, x, ctr = row.pop("args")
        idx_p = row.pop("idx")
        row["ms"] = time_ms(lambda: ops.ball_query_group(r, k, x, ctr),
                            reps=10)
        row["device_ms"] = device_ms(
            lambda: ops.ball_query_group(r, k, x, ctr),
            KERNEL_NAMES["ball_query"])
        row["plain_ms"] = time_ms(
            lambda: ops.ball_query_group_plain(r, k, x, ctr), reps=2)
        bnd, by, _, _ = bq_bound(r, k, x, ctr, idx_p, 4)
        rows["ball_query"].append({
            "call": row["call"], "shape": row["shape"], "max_abs_err": 0,
            "ms": time_ms(lambda: ops.ball_query(r, k, x, ctr), reps=10),
            "device_ms": device_ms(lambda: ops.ball_query(r, k, x, ctr),
                                   KERNEL_NAMES["ball_query"]),
            "plain_ms": time_ms(lambda: ops.ball_query_ref(r, k, x, ctr),
                                reps=2),
            "bound_ms": bnd, "bound_by": by})
    for kname, krows in rows.items():
        for row in krows:
            check(row["device_ms"] is not None, f"{kname} {row['call']}: "
                  "the profiler recorded none of its kernels: device time "
                  "not measured")
            extra = (f"  cluster P={row['cluster']} x {row['threads']} "
                     f"threads, {row['device_us_per_step']:.3f} us/step"
                     if kname == "fps" else "")
            print(f"[time] {kname:16s} {row['call']:16s} {row['shape']:28s} "
                  f"kernel {row['ms']:.4f} ms (device {row['device_ms']})"
                  f"  plain {row['plain_ms']:.3f} ms  bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}){extra}  "
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
    op_ms.update({k: v for k, v in dev_ms.items()
                  if re.search(r"::(ball_query|chunk_box|fps)_kernel\b", k)})
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

    # -- 7. fused eval forward
    counted = {"fps": ops.fps, "ball_query_group": ops.ball_query_group,
               "fused_mlp_pool": ops.fused_mlp_pool}
    report["fused_forward"], eval_records = fused_forward_phase(
        cfg, pc, model, ep, counted, card)
    fused_launches = report["fused_forward"]["launches"]["fused_mlp_pool"]

    # -- 8. train step
    report["train"], train_records = train_phase(cfg, dev, counted, card)

    # -- 9. the fused kernel against its plain version, both modes
    check(len(eval_records) == 4 and len(train_records) == 4,
          f"recorded {len(eval_records)} eval and {len(train_records)} "
          "train fused calls, expected 4 each")
    frows = (fused_kernel_rows(eval_records, "eval")
             + fused_kernel_rows(train_records, "train"))
    del eval_records, train_records
    print(f"[check] fused_mlp_pool equal to its plain version within "
          f"{FUSED_TOL} (batch variances {FUSED_VAR_TOL}) at 4 eval (B={B})"
          f" and 4 train (B={TRAIN_B}) shapes; largest |diff| "
          f"{max(r['max_abs_err'] for r in frows):.3e}")

    # -- 10. times of the fused kernel and its plain version
    time_fused_rows(frows, card)
    rows["fused_mlp_pool"] = frows

    # -- 11. ball_query_group_feats at the SA and vote-aggregation shapes
    rows["ball_query_group_feats"] = feats_phase(cfg, ep, card)

    # -- 12. the semi-supervised step
    del ep_plain
    report["semi"] = semi_phase(
        cfg, dev, card, report["train"]["routes"]["unfused"]["stats"][0])
    feats_launches = report["semi"]["routes"]["unfused"]["launches"][
        "ball_query_group_feats"]

    # -- 13. the bfloat16 serving path
    report["bf16_forward"], bf16_eval_records = bf16_forward_phase(
        cfg, pc, model, ep, counted, card)
    bf16_eval_launches = report["bf16_forward"]["launches"]["fused_mlp_pool"]

    # -- 14. the bfloat16 eval kernel against its plain version
    check(len(bf16_eval_records) == 4, f"recorded {len(bf16_eval_records)} "
          "eval bf16 fused calls, expected 4")
    brows = fused_kernel_rows(bf16_eval_records, "eval")
    del bf16_eval_records
    print(f"[check] bfloat16 fused_mlp_pool eval within {BF16_NORM_REL} of "
          f"the norm and {BF16_ELEMENT_OF_MAX} of the largest value of its "
          f"plain bfloat16 version at 4 shapes (B={B}); norm-relative gaps "
          + ", ".join(f"{r['call']} {r['readings']['pooled_norm_rel']:.2e} "
                      f"(float32 chain {r['control']['pooled_norm_rel']:.2e})"
                      for r in brows))
    time_fused_rows(brows, card)
    print_fused_total(brows, "bf16 eval kernel, the bf16 forward's calls",
                      card)

    # -- 15. the CLIs' default training configuration: bf16 student and
    # teacher; its fused calls against their plain version, and their times
    report["bf16_semi"], bf16_train_rows = bf16_semi_phase(
        cfg, dev, card, report["train"]["routes"]["unfused"]["stats"][0])
    rows["fused_mlp_pool_bf16"] = brows + bf16_train_rows
    bf16_train_launches = report["bf16_semi"]["routes"]["fused"]["launches"][
        "fused_mlp_pool"]

    # -- 16. the fused eval mode at K = 128 and 200 (sa2's widths)
    report["repair"] = repair_phase(card)

    # -- 17. the entry points: train CLI, eval CLI, resume, infer on a .ply
    report["cli"] = cli_phase(card, report)
    report["kernel_rows"] = rows
    # a time below its bound means a miscounted bound or a broken timer
    for kname, krows in rows.items():
        for row in krows:
            for clock in ("ms", "device_ms"):
                if clock not in row:  # rows with no profiler time
                    continue
                t = row[clock]
                check(t is not None and t >= row["bound_ms"],
                      f"{kname} {row['call']}: {clock} {t} below its bound "
                      f"{row['bound_ms']}")
    print("[check] no kernel time (events or device) below its bound")

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
            "device_ms": sum(r["device_ms"] for r in krows),
            "plain_ms": sum(r["plain_ms"] for r in krows),
            "bound_ms": bound,
            "bound_by": max(krows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": None, "matched": True})
    # the fused kernels, one entry a mode: eval's main path is phase 7's
    # fused eval forward (one chained-kernel call a fused SA layer), train's
    # phase 8's fused supervised step (one pass-plan call a fused SA layer:
    # L passes, L stats launches, one pool launch); times and bounds are
    # those calls' (phase 10)
    for mode, launched in (
            ("eval", fused_launches),
            ("train", report["train"]["routes"]["fused"]["launches"][
                "fused_mlp_pool"])):
        mrows = [r for r in frows if r["mode"] == mode]
        summary.append({
            "name": "fused_mlp_pool" + ("" if mode == "eval" else "_train"),
            "route": "cuda", "source": "omni_pq_torch/csrc/fused_mlp.cu",
            "replaces": "omni_pq_tpu/ops/fused_mlp.py:116",
            "launches": launched,
            "max_abs_err": max(r["max_abs_err"] for r in mrows),
            "ms": sum(r["ms"] for r in mrows),
            "device_ms": sum(r["device_ms"] for r in mrows),
            "plain_ms": sum(r["plain_ms"] for r in mrows),
            "bound_ms": sum(r["bound_ms"] for r in mrows),
            "bound_by": max(mrows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": None, "matched": True})
    # the bfloat16 fused kernels, one entry a mode: eval's main path is
    # phase 13's bf16 fused forward (one chained-kernel call a fused SA
    # layer; times and bounds phase 14's, B=16), train's phase 15's bf16
    # fused semi-supervised step (student and teacher: 8 pass-plan calls at
    # B=6, times and bounds those calls'), the bound at the bf16
    # tensor-core peak
    for mode, launched in (("eval", bf16_eval_launches),
                           ("train", bf16_train_launches)):
        mrows = [r for r in rows["fused_mlp_pool_bf16"] if r["mode"] == mode]
        summary.append({
            "name": "fused_mlp_pool_bf16" + ("" if mode == "eval"
                                             else "_train"),
            "route": "cuda", "source": "omni_pq_torch/csrc/fused_mlp_bf16.cu",
            "replaces": "omni_pq_tpu/ops/fused_mlp.py:116",
            "launches": launched,
            "max_abs_err": max(r["max_abs_err"] for r in mrows),
            "ms": sum(r["ms"] for r in mrows),
            "device_ms": sum(r["device_ms"] for r in mrows),
            "plain_ms": sum(r["plain_ms"] for r in mrows),
            "bound_ms": sum(r["bound_ms"] for r in mrows),
            "bound_by": max(mrows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": None, "matched": True})
    # on no model path: its launches are the semi-supervised step's (0);
    # times and bounds are phase 11's four shapes
    frows11 = rows["ball_query_group_feats"]
    summary.append({
        "name": "ball_query_group_feats", "route": "cuda",
        "source": "omni_pq_torch/csrc/ball_query.cu",
        "replaces": "omni_pq_tpu/ops/ball_query.py:499",
        "launches": feats_launches, "max_abs_err": 0,
        "ms": sum(r["ms"] for r in frows11),
        "device_ms": sum(r["device_ms"] for r in frows11),
        "plain_ms": sum(r["plain_ms"] for r in frows11),
        "bound_ms": sum(r["bound_ms"] for r in frows11),
        "bound_by": max(frows11, key=lambda r: r["bound_ms"])["bound_by"],
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
