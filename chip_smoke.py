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
     profile of one step per route; a profile of one more step per route,
     which replays the step's CUDA graph: its `train.step` span's counter
     `graph_replays` 1, no kernel wrapper called, and 12 fps_kernel and 10
     ball_query_kernel launches among the card's events (phase 8's
     supervised step likewise: 6 and 5); one step with the last quad head
     rigged so that the gamma criterion engages (gamma_engaged_frac > 0).
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
     and read after; a step that replays its CUDA graph calls no wrapper
     and counts 0), the checkpoints the policy calls for, every metric
     finite; the CLI step's wall and loader-wait ms, the profiled step's
     busy share beside phases 12 and 15, the eval pass's seconds, peak
     memory; cli.eval on ema_best (the policy's, else the epoch-2 file
     tagged so) equal to the in-loop teacher's F1 and loss; a resume from
     epoch 1 (epoch 2 again, within CLI_RESUME_REL, counts carried on);
     cli.infer on a .ply of one scan.
 18. data parallelism (omni_pq_torch.parallel) on the one card, where
     NCCL takes one rank a card: (a) in this process, a world-1 NCCL group
     and the full-width fused semi step of phase 12 (weights, inputs and
     generator seed) inside parallel.data_parallel, against two steps
     without a group (their gap is the card's own noise): stats, gradients
     and BN running stats within DP_W1_TOL, 12 FPS, 10 ball-query and 8
     fused launches; ms/step in turns and a profile of each (kernel time,
     the NCCL kernels a step, the fused calls' stats-finishing launches);
     (b) 2 ranks over gloo on cuda:0 (subprocesses of this script with
     --dp-rank), the same step at 3 + 3 scenes a rank against one process
     on the global 6 + 6 from the same state and seed: total_loss and
     grad_norm within DP_STEP_RTOL, each fused call's global means and
     variances within DP_FUSED_STATS_REL of the one-process kernel's,
     12 / 10 / 8 launches a rank-step, every parameter, AdamW moment and
     BN buffer bitwise equal across the ranks after 2 steps; (c) the train
     CLI with --multihost on 2 gloo ranks on a fake ScanNet tree of 12 + 4
     scans (--ema --gamma_mixture, bf16, 2 steps, in-loop eval): rank 0
     alone writes the run's files, both ranks log the same losses and F1,
     and cli.eval in one process on its epoch-1 checkpoint gives the
     in-loop F1.
 19. the module surface off the PQTransformer's path, full widths, float32:
     (a) SAModuleMSG (sa1's widths in two branches: 2048 centres, radii
     0.2 / 0.4, nsamples 64 / 32, mlps 128-128-256 twice) on phase 3's
     scenes, eval at B=16 and forward + backward at B=3: 1 FPS, 2 idx-only
     ball-query and 0 ball-query-group launches a call, outputs and running
     stats equal to the plain path, gradients within SURFACE_GRAD_REL of
     their norm; ms (events) and device ms of the call and of each
     ball-query launch beside its bound; (b) LFPModuleMSG (sa2's 1024
     centres with 256 channels onto sa1's 2048 with a 256-channel skip,
     radii 0.4 / 0.8, nsamples 32 / 16, mlps 256-256 twice, post 256), B=16,
     at least one centre with no hit (one moved outside the room if the
     data gives none): 2 ball-query-group launches, equal to the plain
     path; (c) GroupAllModule (sa4's 256 centres x 256 channels, mlp
     256-512-1024), PointsObjClsModule on the 1024 x 288 seeds,
     general_sampling at its top 256 and self-type attention (256 queries,
     288 wide, 8 heads), B=16, within SURFACE_CPU_REL of the CPU (sampling
     exact); (d) remat_sa on phase 8's unfused supervised step, against two
     steps without it from the same state: the loss within their gap,
     gradients and stats within DP_W1_TOL, BN running stats equal (moved
     once); ms/step and peak memory in turns, a profile of each step
     (kernel time, busy share); the fused route's launches unchanged by
     it; (e) get_loss_mean_teacher (lambda_teacher 0 and 1)
     on phase 12's first student and teacher end points, and
     distance_loss_gamma_mixture on phase 3's forward (its decoded quads;
     points within WALL_BAND of a ground-truth wall quad's plane labelled
     wall), each against the same call on CPU copies within the CPU tests'
     bounds (the distance loss's crossover root: as far from the CPU's as
     the float64 roots of the two fitted mixtures, plus each side's float32
     rounding, crossover64; the fitted mixture: the EM in float64 on each
     side's input within 1e-4 relative of the CPU's, and the card's float32
     EM no farther from its float64 fit than twice the CPU's, or 1e-4).
 20. the float64 route, ModelConfig(compute_dtype="float64") at full
     width, phase 3's weights (float64 parameters holding them) and clouds
     (taken as float64), TF32 off: (a) the eval forward at B=16: 6 FPS and
     5 idx-only ball-query launches (the kernels decide on float32 copies
     of the coordinates, the grouping gathers in float64), 0
     ball-query-group and 0 fused launches; every key finite, floating keys
     float64; every FPS call's picks but vote aggregation's bitwise phase
     3's (their inputs' float32 copies are phase 3's inputs); the end points
     bitwise the same forward's under ops.plain_versions(); (b) each key's
     largest gap to phase 3's float32 forward, over its largest magnitude
     (printed); (c) the card against the port on this machine's CPU at
     B=2: indices bitwise, floats within F64_CPU_REL of each key's largest
     magnitude; (d) the backward of tests/test_torch_parity.py's weighted
     scalar of end points (B=2, eval mode) on the kernel path against the
     plain path: each leaf within F64_GRAD_REL; (e) one float64 supervised
     step at B=3 (phase 8's batch, dropout from the same generator seed) on
     both paths: finite stats, total_loss within F64_STEP_LOSS_REL, 6 / 5
     launches; ms/step of 3 more steps and the peak memory; (f) ms/batch of
     (a) in turns with phase 3's float32 forward, peak memory, a profile of
     one forward (top ops) and the FPS and ball-query kernels' device time
     a forward beside phase 6's float32 figures.
 21. the experiment drivers (omni_pq_torch.experiments) through their
     main(), at full ModelConfig() width, outputs in a temporary directory
     removed after: convergence (10 supervised steps on the 4 rooms, B=4,
     the corner-F1 after steps 1 and 10), fitted_mixture (5 semi steps of
     each criterion, 3 + 3 scenes) and each of semi_sup_ab's six Protocol-B
     arms on its own (sup_ft, ema_ft, gamma_ft, gamma_fixed_ft, arkit_ft,
     arkit_centered_ft; AB_PRETRAIN=3, AB_STEPS=6: 3 supervised steps, the
     teacher backfilled, 3 steps of the arm; the held-out F1 of the
     student after step 1 and of the student, and the teacher where the
     arm has one, after step 6). The launch counts are set to 0 before
     each run and read after: 6 FPS and 5 ball-query-group launches a
     forward through the kernels' wrappers (5, 12, and 12 forwards an arm,
     8 for sup_ft; a step that replays its CUDA graph calls no wrapper:
     convergence's steps 4-10, each criterion's steps 4-5); finite losses,
     the backfill, gamma_engaged_frac where the arm has the criterion; the
     ARKit arms' arkit_collisions > 0, their weak pools without quad
     ground truth, and the pools they trained on centred (every scene's
     median xy within 1e-3 m of 0) for arkit_centered_ft and not for
     arkit_ft; ms/step, eval seconds, peak memory and the most memory
     reserved (the graphs' pool with it, from an emptied cache) printed,
     one line a run. The kernels line carries each run's launches.
 22. the student-fall diagnosis script (scripts/student_fall_torch.py) at
     full ModelConfig() width, in this process, its saved state in a
     temporary directory removed after: a gamma_ft trunk of 3 supervised
     steps (the student's F1 after step 1) whose whole state is saved at
     step 3, then branches B1 (gamma loss off) and B2 (TF32 products) from
     it, 3 semi steps each and one eval after step 6 (the student with its
     running and its re-estimated BatchNorm statistics, K = 20 train-mode
     forwards, and the teacher). The launch counts are set to 0 before
     each part and read after: 6 FPS and 5 ball-query-group launches a
     forward (4 forwards the trunk, 29 a branch). The saved state reloads
     bitwise (student and teacher parameters and buffers, AdamW moments
     and counts, the step, the generator); every record key is present
     and finite; B2 ran with TF32 on and the process has it off again.
 23. 3DETR-m (ThreeDETRConfig(fused_sa=True), the benchmark cell
     eval_b16.3detr_m_f32fused's configuration) with random weights from
     SEED on phase 3's clouds, B=16: the launch counts set to 0 just before
     one eval forward and read just after: 3 FPS, 2 ball-query-group, 1
     fused (the interim SA layer) and 3 radius-attention launches (one an
     encoder layer); every key finite; no op returning a tensor that ends
     in (N, N) for the encoder's 2048 or 1024 tokens (no dense logits,
     softmax or mask); FPS and ball-query indices bitwise
     the plain path's, the largest float gap printed. Then the
     radius-attention kernel on that forward's own three calls (N 2048 at
     r 0.16, N 1024 at 0.64 and 1.44; H 4, head size 64) against its
     plain version within RADIUS_REL of its largest value; CUDA events,
     the profiler's device time, the plain version's time and the bytes
     floor (q, k, v and xyz read once, the output written once, over 3.35
     TB/s); the share of pairs each radius keeps; ms/batch and peak
     memory of the forward.
The second-last line is the kernels JSON, the last the device JSON. Details
go to chiprun_out/chip_smoke.json, chiprun_out/chip_smoke_profile.txt,
chiprun_out/chip_smoke_train_profile.txt,
chiprun_out/chip_smoke_semi_profile.txt and
chiprun_out/chip_smoke_bf16_semi_profile.txt.
Phase 20's profile goes to chip_smoke_float64_profile.txt beside them.
"""
from __future__ import annotations

import contextlib
import gc
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
                             r"|mlp_pool)_kernel\b",
                "radius_attention": r"::radius_attention\w*_kernel\b"}
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
# phase 18: data parallelism on the one card (NCCL takes one rank a card)
DP_WORLD = 2
DP_RANK_TIMEOUT_S = 400
# 18a, the world-1 NCCL step against the step without a group: stats
# relative to max(1, |value|), gradients relative to the gradient norm, BN
# running stats relative to max(1, their largest). At world 1 the context
# adds no arithmetic, so only the card's own noise is left (index_add_
# adds in no fixed order): two steps without a group read 0-1.8e-7 of
# stats, 0.8-1.1e-7 of the gradient norm, 0 of the buffers, and the world-1
# step 8.9e-8, 7.3e-8, 0 from them (H100 80GB HBM3, 700 W). The bounds sit
# two orders above that noise and two below what a design that summed
# [sum x, sum x^2, n] read at world 1 (9.1e-5 of stats, 4.2e-4 of the norm)
DP_W1_TOL = {"stats": 1e-5, "grads": 1e-5, "buffers": 1e-6}
# 18b, two ranks against one process on the global batch, at step 1: the
# ranks add their halves' statistics, one process all rows at once, and
# the roundoff moves a vote-aggregation FPS pick now and then (2 of the
# teacher's 3072 in a run that read total_loss 2.9e-7 and grad_norm 4.6e-6
# apart; the summed design read 1.7e-4 and 1.1e-2). A lost or doubled term
# or an undivided gather factor is 50-100 times outside
DP_STEP_RTOL = {"total_loss": 1e-3, "grad_norm": 2e-2}
# each fused call's global means and variances against the one-process
# kernel's, relative to each vector's largest magnitude
DP_FUSED_STATS_REL = 1e-5
# 18c: the train CLI's fake ScanNet tree (2 steps of 3 + 3 a rank; a val
# shard of 2 scans a rank, no padding)
DP_CLI_TRAIN, DP_CLI_VAL = 12, 4
# phase 19: no reference script names shapes for these modules, so they take
# the full ModelConfig()'s widths at the matching layers. 19a SAModuleMSG:
# sa1's in two branches (npoint, radii, nsamples, mlps)
MSG_ARGS = (2048, (0.2, 0.4), (64, 32), ((128, 128, 256), (128, 128, 256)))
# 19b LFPModuleMSG: sa2's 1024 centres (256 channels) onto sa1's 2048 (a
# 256-channel skip): (radii, nsamples, in 1, in 2, mlps, post_mlp)
LFP_ARGS = ((0.4, 0.8), (32, 16), 256, 256, ((256, 256), (256, 256)), (256,))
# 19a train mode, the kernel path against the plain one: gradients relative
# to their norm (gather's backward adds in no fixed order on the card)
SURFACE_GRAD_REL = 1e-6
# 19c: the card against the same module on the CPU, the largest gap over
# the largest magnitude (float32 products summed in other orders)
SURFACE_CPU_REL = 1e-5
# phase 20: the float64 route (ModelConfig(compute_dtype="float64")). (c)
# the card against the port on this machine's CPU, each float key's largest
# gap over its largest magnitude: the bound the CPU tests hold the port to
# against JAX's float64 route
F64_CPU_REL = 1e-9
F64_CPU_B = 2
# (d) the backward of the weighted scalar on the kernel path against the
# plain path, each leaf's largest gap over its largest magnitude (at least
# F64_GRAD_FLOOR of the gradient norm: a leaf whose gradient is roundoff):
# the forwards are bitwise equal, and the gathers' backward (index_put_
# with accumulation) adds in no fixed order on the card, float64 roundoff
# (~1e-16 of a sum) through the rest of the backward
F64_GRAD_REL = 1e-9
F64_GRAD_FLOOR = 1e-12
# the scalar's terms: tests/test_torch_parity.py's float64 test
F64_PREFIXES = ("proposal_", "0head_", "3head_", "last_")
F64_FIELDS = ("center", "objectness_scores", "sem_cls_scores",
              "heading_scores", "size_scores", "quad_scores", "quad_center",
              "normal_vector", "quad_size")
# (e) the supervised step's total_loss on the kernel path against the plain
# path from the same state and generator: the forward is bitwise the plain
# one, so only the losses' own reductions are left
F64_STEP_LOSS_REL = 1e-12
# 19e: points this close to a ground-truth wall quad's plane are wall
WALL_BAND = 0.02


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
                                 r"|mlp_stats(_finish)?|mlp_pool|ball_query"
                                 r"|fps)_kernel\b", e.key)),
                  reverse=True)
    # the collectives' kernels (data parallelism over NCCL)
    nccl = [(e.self_device_time_total / 1e3, e.count) for e in events
            if e.device_type == DeviceType.CUDA
            and re.search(r"nccl", e.key, re.I)]
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
                 nccl_launches=sum(c for _, c in nccl),
                 nccl_ms=sum(t for t, _ in nccl), line=line),
            traced[0].table(sort_by="self_device_time_total", row_limit=25))


def replayed_step_kernels(run, want, where, tries=3):
    """One call of `run`, a train step whose CUDA graph is captured,
    under torch.profiler: its `train.step` span's counter `graph_replays`
    is 1, no kernel wrapper is called, and the point kernels that ran on
    the card, counted from the profiler's device events, are `want`
    ({kernel: launches}). The profiler may lose a window's events now and
    then: a window short of `want` is traced again, up to `tries` times.
    Returns {kernel: launches seen}, chunk_box_kernel's too."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from omni_pq_torch import ops
    from omni_pq_torch.utils import trace
    wrappers = ("fps", "ball_query", "ball_query_group",
                "ball_query_group_feats", "fused_mlp_pool")
    for attempt in range(tries):
        trace.clear()
        before = [getattr(ops, w).launches for w in wrappers]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        called = [getattr(ops, w).launches - n
                  for w, n in zip(wrappers, before)]
        replays = [r.counters.get("graph_replays") for r in trace.records()
                   if r.name == "train.step"]
        trace.clear()
        check(replays == [1], f"{where}: the profiled call's train.step "
              f"graph_replays {replays}, expected [1]")
        check(not any(called), f"{where}: a replayed call called the "
              f"kernel wrappers {dict(zip(wrappers, called))}")
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        seen = {k: sum(1 for n in names if re.search(rf"::{k}\b", n))
                for k in (*want, "chunk_box_kernel")}
        if {k: seen[k] for k in want} == want:
            return seen
        print(f"[profiler] {where}: window {attempt + 1} of {tries} saw "
              f"{seen}", file=sys.stderr)
    check(False, f"{where}: a replayed step's kernels on the card {seen}, "
          f"expected {want}")


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
        top[route]["replayed_kernels"] = replayed_step_kernels(
            lambda: r["step"](r["state"], labeled, generator=r["gen"]),
            {"fps_kernel": 6, "ball_query_kernel": 5},
            f"[train] {route} replayed step")
        print(f"[train] {route}: a replayed step's point kernels on the "
              f"card {top[route]['replayed_kernels']}")
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
        top[route]["replayed_kernels"] = replayed_step_kernels(
            r["run"], {"fps_kernel": 12, "ball_query_kernel": 10},
            f"[semi] {route} replayed step")
        print(f"[semi] {route}: a replayed step's point kernels on the "
              f"card {top[route]['replayed_kernels']}")
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
    from omni_pq_torch.train.step import WARMUP_CALLS
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
        # a replayed train step (every call of its one batch shape after
        # the warm-ups and the capture) calls no wrapper: its kernels launch
        # from the graph
        semi = {"fps": 12, "ball_query_group": 10}
        steps = calls["train_step"]
        replayed = max(0, len(steps) - WARMUP_CALLS - 1)
        check(launches["fused_mlp_pool"] == 0 and all(
            launches[k] == seen[k] for k in seen),
            f"{what}: launches {launches}, counted in steps and eval "
            f"forwards {seen}")
        want = [semi] * (len(steps) - replayed) + [
            {"fps": 0, "ball_query_group": 0}] * replayed
        check(steps == want, f"{what}: train_step launches {steps}, "
              f"expected {want}")
        want = {"fps": 6, "ball_query_group": 5}
        check(all(c == want for c in calls["eval_forward"]), f"{what}: "
              f"eval_forward launches {calls['eval_forward']}, expected "
              f"{want} each")
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


# -- phase 18: data parallelism on the one card ------------------------------

def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_global_batches(num_points: int):
    """Phase 18b's global batch: DP_WORLD * TRAIN_B labeled and as many weak
    scenes, made from the seed (the ranks make the same and take their
    rows)."""
    from omni_pq_torch.data import make_batch
    return tuple(make_batch(np.random.default_rng(SEED + 10 + i),
                            DP_WORLD * TRAIN_B, num_points) for i in (0, 1))


def record_fused_stats(ops, records):
    """Route ops.fused_mlp_pool through a recorder of each call's batch
    means and variances (on the host); returns the restoring function."""
    real = ops.fused_mlp_pool

    def recorder(*a, **kw):
        out = real(*a, **kw)
        records.append(([m.detach().cpu() for m in out[1]],
                        [v.detach().cpu() for v in out[2]]))
        return out

    ops.fused_mlp_pool = recorder

    def restore():
        ops.fused_mlp_pool = real
    return restore


def record_fps_picks(ops, records):
    """Route ops.fps through a recorder of each call's picks (on the host);
    returns the restoring function."""
    real = ops.fps

    def recorder(xyz, npoint):
        inds = real(xyz, npoint)
        records.append(inds.cpu())
        return inds

    ops.fps = recorder

    def restore():
        ops.fps = real
    return restore


def rank_rows(rank: int) -> list:
    """The global rows of rank `rank`'s local double batch [L_r | W_r]."""
    return [rank * TRAIN_B + i for i in range(TRAIN_B)] + [
        DP_WORLD * TRAIN_B + rank * TRAIN_B + i for i in range(TRAIN_B)]


def semi_stepper(cfg, dev, labeled, weak):
    """A fresh full-width fused model from SEED, its TrainState (EMA) and
    generator, and a function that runs one TrainFlags() step on the given
    batches (phase 12's fused step)."""
    import torch
    from omni_pq_torch.config import SCANNET_MEAN_SIZES
    from omni_pq_torch.infer import build_model
    from omni_pq_torch.train import (OptimizerConfig, TrainFlags, TrainState,
                                     make_train_step)
    fcfg = dataclasses.replace(cfg, fused_sa=True)
    model = build_model(fcfg, dev, seed=SEED)
    state = TrainState(model, OptimizerConfig(), ema=True)
    gen = torch.Generator(dev).manual_seed(SEED)
    step = make_train_step(model, fcfg, SCANNET_MEAN_SIZES, TrainFlags())
    return model, state, lambda: step(state, labeled, weak, generator=gen,
                                      consistency_weight=CONSISTENCY_WEIGHT)


def step_reading(model, state, stats) -> dict:
    """A step's stats, gradients and BN running stats (student, and the
    teacher where the state has one)."""
    return dict(
        stats={k: float(v) for k, v in stats.items()},
        grads={n: p.grad.detach().clone()
               for n, p in model.named_parameters()},
        buffers={f"{who}.{n}": b.detach().clone()
                 for who, m in (("student", model),
                                ("teacher", state.ema_model))
                 if m is not None for n, b in m.named_buffers()
                 if n.endswith(("running_mean", "running_var"))})


def reading_gaps(a, b) -> dict:
    """Largest gaps of reading `a` from `b`: stats relative to max(1,
    |b|), gradients relative to b's grad_norm, BN running stats relative to
    max(1, the buffer's largest magnitude)."""
    norm = b["stats"]["grad_norm"]
    return dict(
        stats=max(abs(a["stats"][k] - v) / max(1.0, abs(v))
                  for k, v in b["stats"].items()),
        grads=max(float((a["grads"][n] - g).abs().max()) / norm
                  for n, g in b["grads"].items()),
        buffers=max(float((a["buffers"][n] - t).abs().max())
                    / max(1.0, float(t.abs().max()))
                    for n, t in b["buffers"].items()))


def dp_world1_phase(cfg, dev, card, report):
    """Phase 18a: the data-parallel path on a world-1 NCCL group in this
    process, the full-width fused semi step from phase 12's weights, inputs
    and generator seed, against the step without a process group."""
    import contextlib
    import torch
    import torch.distributed as dist
    from omni_pq_torch import ops, parallel
    from omni_pq_torch.data import make_batch
    from omni_pq_torch.train import batch_to_tensors
    labeled, weak = (batch_to_tensors(make_batch(
        np.random.default_rng(SEED + i), TRAIN_B, cfg.num_points), dev)
        for i in (0, 1))
    counted = {"fps": ops.fps, "ball_query_group": ops.ball_query_group,
               "fused_mlp_pool": ops.fused_mlp_pool}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        runs, readings = {}, {}
        # two steps without a group (their gap is the card's own noise:
        # index_add_ adds in no fixed order), then one inside the context
        for tag in ("plain_a", "plain_b", "nccl"):
            ctx = (parallel.data_parallel if tag == "nccl"
                   else contextlib.nullcontext)
            model, state, run = semi_stepper(cfg, dev, labeled, weak)
            with ctx():
                reset_launch_counts(counted)
                st = run()
                torch.cuda.synchronize()
            readings[tag] = step_reading(model, state, st)
            readings[tag]["launches"] = fused_launch_counts(counted)
            runs[tag] = (run, ctx)
            del model, state, st
        want = {"fps": 12, "ball_query_group": 10, "fused_mlp_pool": 8}
        for tag, r in readings.items():
            check(r["launches"] == want, f"world-1 {tag} step launches "
                  f"{r['launches']}, expected {want}")
        noise = reading_gaps(readings["plain_b"], readings["plain_a"])
        gap = reading_gaps(readings["nccl"], readings["plain_a"])
        semi = report["semi"]
        p12 = max(abs(readings["plain_a"]["stats"][k] - v) / max(1.0, abs(v))
                  for k, v in semi["routes"]["fused"]["stats"][0].items())
        print(f"[dp] 18a phase 12's fused semi step, same weights and "
              f"inputs: {np.mean(semi['step_ms']['fused']):.3f} ms/step, "
              f"kernel {semi['profile']['fused']['device_ms']:.3f} ms "
              f"[{card}]")
        print(f"[dp] 18a world-1 NCCL fused semi step against the step "
              f"without a group: stats {gap['stats']:.3e}, gradients "
              f"{gap['grads']:.3e} of the norm, BN running stats "
              f"{gap['buffers']:.3e}; two steps without a group: "
              f"{noise['stats']:.3e}, {noise['grads']:.3e}, "
              f"{noise['buffers']:.3e}; phase 12's first fused step "
              f"against this one's stats {p12:.3e} (bounds {DP_W1_TOL})")
        for key, bound in DP_W1_TOL.items():
            check(gap[key] <= bound, f"world-1 NCCL step: {key} gap "
                  f"{gap[key]:.3e} above {bound}")
        del readings
        times = {"plain_a": [], "nccl": []}
        for tag in ("plain_a", "nccl", "nccl", "plain_a"):
            run, ctx = runs[tag]
            with ctx():
                times[tag].append(wall_ms_per_call(run, reps=3))
        expect = {"fps_kernel": 12, "ball_query_kernel": 10,
                  **fused_train_launches([3] * 8)}
        prof = {}
        for tag in ("plain_a", "nccl"):
            run, ctx = runs[tag]
            want_k = dict(expect, **({"mlp_stats_finish_kernel": 24}
                                     if tag == "nccl" else {}))
            with ctx():
                prof[tag], _ = profile_step(run, want_k,
                                            float(np.mean(times[tag])))
            print(f"[dp] 18a {tag} profile: {prof[tag]['line']}")
            print(f"[dp] 18a {tag}: {np.mean(times[tag]):.3f} ms/step "
                  f"({[round(t, 1) for t in times[tag]]}), kernel "
                  f"{prof[tag]['device_ms']:.3f} ms, NCCL kernels "
                  f"{prof[tag]['nccl_launches']} a step, "
                  f"{prof[tag]['nccl_ms']:.3f} ms [{card}]")
    finally:
        dist.destroy_process_group()
    return dict(gap=gap, noise=noise, phase12_stats_gap=p12, step_ms=times,
                profile={k: {kk: v[kk] for kk in (
                    "device_ms", "step_ms", "busy_share", "complete",
                    "kernel_launches_seen", "nccl_launches", "nccl_ms")}
                    for k, v in prof.items()})


def fused_stats_gap(got, want) -> float:
    """Largest gap over the fused calls' per-layer means and variances,
    each vector's relative to its largest magnitude."""
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for (gm, gv), (wm, wv) in zip(got, want)
               for g, w in zip(gm + gv, wm + wv))


def dp_ranks_phase(cfg, dev, card):
    """Phase 18b: 2 ranks over gloo, both on cuda:0 (subprocesses of this
    script), the full-width fused semi step at 3 + 3 scenes a rank, against
    one process's step on the global 6 + 6 from the same state and seed."""
    import torch
    from omni_pq_torch import ops
    from omni_pq_torch.train import batch_to_tensors
    lab, wk = dp_global_batches(cfg.num_points)
    labeled, weak = (batch_to_tensors(b, dev) for b in (lab, wk))
    model, state, run = semi_stepper(cfg, dev, labeled, weak)
    records, picks, stats = [], [], []
    for i in range(2):
        restores = ([record_fused_stats(ops, records),
                     record_fps_picks(ops, picks)] if i == 0 else [])
        try:
            stats.append({k: float(v) for k, v in run().items()})
        finally:
            for restore in restores:
                restore()
    torch.cuda.synchronize()
    ref_peak = torch.cuda.max_memory_allocated(dev)
    del model, state, run, labeled, weak
    torch.cuda.empty_cache()
    check(len(records) == 8, f"one-process step: {len(records)} fused "
          "calls, expected 8")

    out = os.path.join(ROOT, "build", "chip_smoke_dp")
    os.makedirs(out, exist_ok=True)
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
         "--dp-port", str(port), "--dp-out", out], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(DP_WORLD)]
    outs = [p.communicate(timeout=DP_RANK_TIMEOUT_S)[0].decode()
            for p in procs]
    wall_s = time.perf_counter() - t0
    for r, (p, o) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"18b rank {r} exited {p.returncode}:\n"
              + o[-3000:])
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(DP_WORLD)]
    for r in ranks:
        check(r["launches"] == {"fps": 12, "ball_query_group": 10,
                                "fused_mlp_pool": 8},
              f"18b rank {r['rank']} step launches {r['launches']}")
        check(len(r["fused_stats"]) == 8, f"18b rank {r['rank']}: "
              f"{len(r['fused_stats'])} fused calls recorded")
    # the FPS picks of each forward (student, then teacher): sa1-4 and the
    # quad queries depend on xyz alone, so each rank's rows must be the
    # one process's bitwise; vote aggregation's depend on the features
    check(all(len(r["fps_picks"]) == len(picks) == 12 for r in ranks),
          "18b: FPS calls recorded "
          f"{[len(r['fps_picks']) for r in ranks]}, one process "
          f"{len(picks)}, expected 12")
    moved = {}
    for r in ranks:
        for c, (got, want) in enumerate(zip(r["fps_picks"], picks)):
            diff = int((got != want[rank_rows(r["rank"])]).sum())
            if c % 6 == 5:
                moved[c] = moved.get(c, 0) + diff
            else:
                check(diff == 0, f"18b rank {r['rank']}: FPS call {c} "
                      f"(xyz only) has {diff} picks unlike the one process's"
                      " rows")
    gaps = {"fused_stats": max(fused_stats_gap(r["fused_stats"], records)
                               for r in ranks)}
    for k in ("total_loss", "grad_norm"):
        gaps[k] = max(abs(r["stats"][0][k] - stats[0][k]) / abs(stats[0][k])
                      for r in ranks)
    same = ranks[0]["digests"] == ranks[1]["digests"]
    differ = sum(ranks[0]["digests"][k] != v
                 for k, v in ranks[1]["digests"].items())
    print(f"[dp] 18b 2 gloo ranks on cuda:0 (3 + 3 scenes each) against one "
          f"process on the global 6 + 6: total_loss "
          f"{gaps['total_loss']:.3e} and grad_norm {gaps['grad_norm']:.3e} "
          f"relative at step 1 (bounds {DP_STEP_RTOL}); the 8 fused calls' "
          f"global means and variances within {gaps['fused_stats']:.3e} of "
          f"each vector's largest (bound {DP_FUSED_STATS_REL}); launches a "
          f"rank-step {ranks[0]['launches']}; after 2 steps "
          f"{len(ranks[0]['digests'])} parameters, AdamW moments and BN "
          f"buffers {'bitwise equal' if same else f'{differ} UNEQUAL'} "
          "across the ranks; FPS picks of sa1-4 and the quad queries "
          "bitwise the one process's rows, vote aggregation's moved "
          f"(student, teacher; of {2 * DP_WORLD * TRAIN_B} x "
          f"{cfg.num_proposal}): {moved[5]}, {moved[11]}")
    check(gaps["fused_stats"] <= DP_FUSED_STATS_REL, "18b fused statistics "
          f"{gaps['fused_stats']:.3e} from the one-process kernel's")
    for k, bound in DP_STEP_RTOL.items():
        check(gaps[k] <= bound, f"18b {k} {gaps[k]:.3e} from the one-process"
              f" step (bound {bound})")
    check(same, f"18b: {differ} tensors differ across the ranks")
    check(ranks[0]["stats"] == ranks[1]["stats"], "18b: the ranks' stats "
          "differ")
    for r in ranks:
        print(f"[dp] 18b rank {r['rank']}: step wall ms "
              f"{[round(x, 1) for x in r['step_ms']]} (two processes "
              f"sharing one card over gloo: not a multi-card speed), peak "
              f"memory {r['peak'] / 2**30:.2f} GiB [{card}]")
    print(f"[dp] 18b one-process 6 + 6 step: total_loss "
          f"{[round(x['total_loss'], 5) for x in stats]}, grad_norm "
          f"{[round(x['grad_norm'], 4) for x in stats]}, peak memory "
          f"{ref_peak / 2**30:.2f} GiB; the ranks' run {wall_s:.1f} s")
    return dict(gaps=gaps, vote_picks_moved=moved, ref_stats=stats, rank_stats=[r["stats"]
                                                          for r in ranks],
                rank_step_ms=[r["step_ms"] for r in ranks],
                rank_peak=[r["peak"] for r in ranks], ref_peak=ref_peak,
                ranks_wall_s=wall_s, tensors=len(ranks[0]["digests"]))


def dp_rank_main(argv) -> int:
    """One rank of phase 18b (`--dp-rank R --dp-port P --dp-out DIR`)."""
    import hashlib
    import torch
    import torch.distributed as dist
    from omni_pq_torch import ops, parallel
    from omni_pq_torch.config import ModelConfig
    from omni_pq_torch.train import batch_to_tensors
    opts = dict(zip(argv[::2], argv[1::2]))
    rank, port, out = (int(opts["--dp-rank"]), opts["--dp-port"],
                       opts["--dp-out"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ[parallel.BACKEND_ENV] = "gloo"  # NCCL: one rank a card
    dev = parallel.init_distributed(f"localhost:{port}", DP_WORLD, rank,
                                    device="cuda")
    cfg = ModelConfig()
    lab, wk = dp_global_batches(cfg.num_points)
    rows = slice(rank * TRAIN_B, (rank + 1) * TRAIN_B)
    labeled, weak = (batch_to_tensors({k: v[rows] for k, v in b.items()},
                                      dev) for b in (lab, wk))
    model, state, run = semi_stepper(cfg, dev, labeled, weak)
    counted = {"fps": ops.fps, "ball_query_group": ops.ball_query_group,
               "fused_mlp_pool": ops.fused_mlp_pool}
    records, picks, stats, step_ms = [], [], [], []
    with parallel.data_parallel():
        for i in range(2):
            restores = []
            if i == 0:
                reset_launch_counts(counted)
                restores = [record_fused_stats(ops, records),
                            record_fps_picks(ops, picks)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                st = run()
                torch.cuda.synchronize()
            finally:
                for restore in reversed(restores):
                    restore()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                launches = fused_launch_counts(counted)
            stats.append({k: float(v) for k, v in st.items()})
    digests = {}
    for who, m in (("student", model), ("teacher", state.ema_model)):
        for k, v in m.state_dict().items():
            digests[f"{who}.{k}"] = v
    for name, p in model.named_parameters():
        for k, v in state.optimizer.state.get(p, {}).items():
            digests[f"adamw.{name}.{k}"] = v
    digests = {k: hashlib.sha1(v.detach().cpu().contiguous().view(-1)
                               .view(torch.uint8).numpy().tobytes())
               .hexdigest() for k, v in digests.items()}
    torch.save(dict(rank=rank, stats=stats, step_ms=step_ms,
                    launches=launches, fused_stats=records,
                    fps_picks=picks, digests=digests,
                    peak=torch.cuda.max_memory_allocated(dev)),
               os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def dp_cli_phase(card):
    """Phase 18c: `python -m omni_pq_torch.cli.train --multihost` on 2 gloo
    ranks on the card (--ema --gamma_mixture, bf16, one epoch of 2 steps,
    in-loop eval) on a fake ScanNet tree, then cli.eval in this process on
    its epoch-1 checkpoint."""
    import shutil
    from omni_pq_torch.cli import eval as eval_cli
    from omni_pq_torch.parallel import BACKEND_ENV
    work = os.path.join(ROOT, "build", "chip_smoke_dp_cli")
    shutil.rmtree(work, ignore_errors=True)
    data = os.path.join(work, "scannet")
    scans = [f"scene{i:04d}_00" for i in range(DP_CLI_TRAIN + DP_CLI_VAL)]
    load_fake_data().write_fake_scannet(data, scans,
                                        np.random.default_rng(SEED),
                                        n_verts=CLI_VERTS)
    with open(os.path.join(data, "meta_data/scannetv2_train.txt"), "w") as f:
        f.write("\n".join(scans[:DP_CLI_TRAIN]))
    with open(os.path.join(data, "meta_data/scannetv2_val.txt"), "w") as f:
        f.write("\n".join(scans[DP_CLI_TRAIN:]))
    run = os.path.join(work, "run")
    argv = ["--data_root", data, "--ema", "--gamma_mixture", "--batch_size",
            str(TRAIN_B), "--max_epoch", "1", "--end_proportion", "1.0",
            "--val_freq", "1", "--save_freq", "1", "--print_freq", "1",
            "--log_dir", run]
    port = free_port()
    try:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "omni_pq_torch.cli.train", *argv,
             "--multihost", "--coordinator_address", f"localhost:{port}",
             "--num_processes", str(DP_WORLD), "--process_id", str(r)],
            cwd=ROOT, env=dict(os.environ, **{BACKEND_ENV: "gloo"}),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(DP_WORLD)]
        outs = [p.communicate(timeout=DP_RANK_TIMEOUT_S)[0].decode()
                for p in procs]
        wall_s = time.perf_counter() - t0
        for r, (p, o) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"18c train CLI rank {r} exited "
                  f"{p.returncode}:\n" + o[-3000:])
        files = set(os.listdir(run)) - {"ckpt_epoch_best.pth",
                                        "ckpt_epoch_ema_best.pth"}
        want = {"ckpt_epoch_1.pth", "ckpt_epoch_last.pth", "config.json",
                "log.rank0.txt", "log.rank1.txt", "metrics.jsonl", "tb"}
        check(files == want, f"18c: files {sorted(files)}, expected "
              f"{sorted(want)}")
        with open(os.path.join(run, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        train = [r for r in recs if "train/total_loss" in r]
        evals = [r for r in recs if "eval/quad_f1" in r]
        check([r["step"] for r in train] == [1, 2] and len(evals) == 1,
              f"18c: metrics.jsonl holds train steps "
              f"{[r['step'] for r in train]} and {len(evals)} eval records "
              "(one writer: steps [1, 2] and one eval)")
        check(all(np.isfinite(v) for r in recs for v in r.values()),
              "18c: non-finite metrics")
        lines = []
        for r in range(DP_WORLD):
            with open(os.path.join(run, f"log.rank{r}.txt")) as f:
                lines.append([re.sub(r" (step_ms|data_ms) \S+", "",
                                     m.group(1)) for m in (
                    re.search(r"INFO (Train: .*|\[eval:.*)", line)
                    for line in f) if m])
        check(len(lines[0]) > 2 and lines[0] == lines[1],
              "18c: the ranks logged different losses or F1")
        f1_loop = evals[0]["eval/quad_f1"]
        eval_dir = os.path.join(work, "eval")
        f1 = eval_cli.main(["--data_root", data, "--log_dir", eval_dir,
                            "--checkpoint_path",
                            os.path.join(run, "ckpt_epoch_1.pth")])
        check(f1 == f1_loop, f"18c: cli.eval F1 {f1} on the epoch-1 "
              f"checkpoint, in-loop (2 ranks) {f1_loop}")
        print(f"[dp] 18c train CLI --multihost, 2 gloo ranks on cuda:0: "
              f"{len(train)} steps (B={TRAIN_B}+{TRAIN_B} a rank, bf16) "
              f"and the in-loop eval in {wall_s:.1f} s; rank 0 alone wrote "
              f"{sorted(files - {'log.rank1.txt'})}; both ranks logged the "
              f"same {len(lines[0])} loss / F1 lines; total_loss "
              f"{[round(r['train/total_loss'], 4) for r in train]}, step "
              f"wall ms {[round(r['train/step_ms'], 1) for r in train]} "
              f"(two processes sharing one card); in-loop quad F1 "
              f"{f1_loop}, cli.eval in one process on ckpt_epoch_1.pth "
              f"{f1} [{card}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(steps=len(train), wall_s=wall_s, f1=f1, f1_in_loop=f1_loop,
                total_loss=[r["train/total_loss"] for r in train],
                step_ms=[r["train/step_ms"] for r in train])


# -- phase 19: the module surface off the PQTransformer's path ---------------

def surface_module(module, dev, seed: int):
    """`module` with random weights from `seed` (infer.init_weights) and its
    BatchNorms' affine parameters and running stats drawn from numpy (not
    1/0, 0/1), on `dev`."""
    import torch
    from omni_pq_torch.infer import init_weights
    from omni_pq_torch.models.pointnet2 import BatchNorm
    init_weights(module, torch.Generator().manual_seed(seed))
    r = np.random.default_rng(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                c = m.num_features
                for t, v in ((m.weight, r.uniform(0.5, 1.5, c)),
                             (m.bias, r.normal(0, 0.1, c)),
                             (m.running_mean, r.normal(0, 0.1, c)),
                             (m.running_var, r.uniform(0.5, 1.5, c))):
                    t.copy_(torch.from_numpy(v))
    return module.to(dev)


def surface_counted():
    from omni_pq_torch import ops
    return {"fps": ops.fps, "ball_query": ops.ball_query,
            "ball_query_group": ops.ball_query_group,
            "fused_mlp_pool": ops.fused_mlp_pool}


def largest_gap(got, want) -> float:
    return max((float((a.double() - b.double()).abs().max())
                for a, b in zip(got, want)), default=0.0)


def call_times(fn, card, what):
    """Events ms and profiler device ms (every kernel) of a warmed call."""
    ms = time_ms(fn, reps=5)
    dms = device_ms(fn, r".", reps=3)
    check(dms is not None, f"{what}: the profiler recorded no kernel")
    return ms, dms


def msg_phase(pc, card):
    """Phase 19a: SAModuleMSG at sa1's widths in two branches, B=16 eval
    then B=3 train, kernels against the plain versions."""
    import contextlib
    import copy
    import torch
    from omni_pq_torch import ops
    from omni_pq_torch.models import SAModuleMSG
    dev = pc.device
    counted = surface_counted()
    npoint, radii, nsamples, mlps = MSG_ARGS
    msg = surface_module(SAModuleMSG(npoint, radii, nsamples, 0, mlps,
                                     normalize_xyz=True), dev, SEED).eval()
    xyz = pc[..., :3].contiguous()
    with torch.no_grad():
        msg(xyz)  # warm-up
        torch.cuda.synchronize()
        reset_launch_counts(counted)
        out = msg(xyz)
        torch.cuda.synchronize()
        launches = fused_launch_counts(counted)
        want = {"fps": 1, "ball_query": 2, "ball_query_group": 0,
                "fused_mlp_pool": 0}
        check(launches == want, f"SAModuleMSG eval launches {launches}, "
              f"expected {want}")
        with ops.plain_versions():
            ref = msg(xyz)
        eval_gap = largest_gap(out, ref)
        check(eval_gap == 0.0, f"SAModuleMSG eval: kernel path |diff| "
              f"{eval_gap} from the plain path")
        ms, dms = call_times(lambda: msg(xyz), card, "SAModuleMSG eval")
        with ops.plain_versions():
            plain_ms = time_ms(lambda: msg(xyz), reps=1, warmup=0)
    print(f"[surface] 19a SAModuleMSG eval B={xyz.shape[0]} N="
          f"{xyz.shape[1]} -> {npoint}, radii {radii}, nsamples {nsamples}, "
          f"mlps {mlps}: launches {launches}; output {tuple(out[1].shape)} "
          f"equal to the plain path (largest |diff| {eval_gap}); "
          f"{ms:.3f} ms (events), {dms:.3f} ms device, plain path "
          f"{plain_ms:.1f} ms [{card}]")
    # each ball_query launch of the call, at its own shape
    rows = []
    new_xyz = out[0]
    for r, k in zip(radii, nsamples):
        idx = ops.ball_query(r, k, xyz, new_xyz)
        idx_p = ops.ball_query_ref(r, k, xyz, new_xyz)
        check(torch.equal(idx, idx_p), f"ball_query r{r} K{k}: "
              f"{int((idx != idx_p).sum())} indices differ")
        bnd, by, tests, points = bq_bound(r, k, xyz, new_xyz, idx_p, 4)
        row = {"call": f"msg r{r}",
               "shape": f"B{xyz.shape[0]} N{xyz.shape[1]} S{npoint} K{k} r{r}",
               "max_abs_err": 0, "box_tests": tests, "points_tested": points,
               "ms": time_ms(lambda: ops.ball_query(r, k, xyz, new_xyz),
                             reps=10),
               "device_ms": device_ms(
                   lambda: ops.ball_query(r, k, xyz, new_xyz),
                   KERNEL_NAMES["ball_query"]),
               "plain_ms": time_ms(
                   lambda: ops.ball_query_ref(r, k, xyz, new_xyz), reps=2),
               "bound_ms": bnd, "bound_by": by}
        check(row["device_ms"] is not None, f"ball_query r{r}: the profiler "
              "recorded none of its kernels")
        rows.append(row)
        print(f"[surface] 19a ball_query launch {row['shape']}: kernel "
              f"{row['ms']:.4f} ms (device {row['device_ms']:.4f})  plain "
              f"{row['plain_ms']:.3f} ms  bound {bnd:.4f} ms ({by}) "
              f"[{card}]")
    del out, ref
    # train mode at B=3 (phase 8's scenes), forward + backward
    x3 = xyz[:TRAIN_B].contiguous()
    runs = []
    for plain in (False, True):
        m = copy.deepcopy(msg).train()
        x = x3.clone().requires_grad_()
        reset_launch_counts(counted)
        with ops.plain_versions() if plain else contextlib.nullcontext():
            res = m(x)
            gen = torch.Generator(dev).manual_seed(SEED)
            (res[1] * torch.randn(res[1].shape, generator=gen,
                                  device=dev)).sum().backward()
        torch.cuda.synchronize()
        runs.append(dict(
            out=[t.detach() for t in res], launches=fused_launch_counts(
                counted),
            grads={**{n: p.grad for n, p in m.named_parameters()},
                   "xyz": x.grad},
            buffers=dict(m.named_buffers())))
    (kern, plain) = runs
    check(kern["launches"] == want, f"SAModuleMSG train launches "
          f"{kern['launches']}, expected {want}")
    train_gap = largest_gap(kern["out"], plain["out"])
    check(train_gap == 0.0, f"SAModuleMSG train: outputs |diff| {train_gap}")
    buf_gap = largest_gap(kern["buffers"].values(), plain["buffers"].values())
    check(buf_gap == 0.0, f"SAModuleMSG train: running stats |diff| "
          f"{buf_gap}")
    grad_gap = max(float((kern["grads"][n] - g).abs().max())
                   / max(float(g.norm()), 1e-30)
                   for n, g in plain["grads"].items())
    check(grad_gap <= SURFACE_GRAD_REL, f"SAModuleMSG train: gradients "
          f"{grad_gap:.3e} of their norm from the plain path")
    m = copy.deepcopy(msg).train()
    x = x3.clone().requires_grad_()

    def train_call():
        m(x)[1].sum().backward()
    train_ms = time_ms(train_call, reps=3)
    print(f"[surface] 19a SAModuleMSG train B={TRAIN_B}: launches "
          f"{kern['launches']}, outputs and running stats equal to the plain "
          f"path, gradients (parameters and xyz) {grad_gap:.3e} of their "
          f"norm (bound {SURFACE_GRAD_REL}); forward + backward "
          f"{train_ms:.3f} ms (events) [{card}]")
    return dict(launches=launches, eval_ms=ms, eval_device_ms=dms,
                plain_ms=plain_ms, train_launches=kern["launches"],
                train_grad_gap=grad_gap, train_ms=train_ms), rows


def lfp_phase(ep, card):
    """Phase 19b: LFPModuleMSG from sa2's 1024 centres onto sa1's 2048, at
    least one centre with no point in its ball, kernels against plain."""
    import torch
    from omni_pq_torch import ops
    from omni_pq_torch.models import LFPModuleMSG
    from omni_pq_torch.ops.reference import radius_sq
    radii, nsamples, c1, c2, mlps, post = LFP_ARGS
    xyz1, xyz2 = ep["sa2_xyz"], ep["sa1_xyz"].clone()
    dev = xyz1.device
    f2 = ep["sa1_features"]
    f1 = torch.randn(xyz1.shape[:2] + (c1,), generator=torch.Generator(
        dev).manual_seed(SEED), device=dev)

    def no_hit():
        d2 = torch.stack([torch.cdist(xyz2[b].double(), xyz1[b].double())
                          for b in range(xyz2.shape[0])]).amin(-1) ** 2
        return {r: int((d2 >= radius_sq(r)).sum()) for r in radii}
    misses = no_hit()
    moved = not any(misses.values())
    if moved:  # the data gives none: one centre far outside the room
        xyz2[0, -1] += 100.0
        misses = no_hit()
    check(sum(misses.values()) >= 1, f"LFPModuleMSG: no centre without a "
          f"hit ({misses})")
    lfp = surface_module(LFPModuleMSG(radii, nsamples, c1, c2, mlps, post),
                         dev, SEED + 1).eval()
    counted = surface_counted()
    with torch.no_grad():
        lfp(xyz2, xyz1, f2, f1)
        torch.cuda.synchronize()
        reset_launch_counts(counted)
        out = lfp(xyz2, xyz1, f2, f1)
        torch.cuda.synchronize()
        launches = fused_launch_counts(counted)
        want = {"fps": 0, "ball_query": 0, "ball_query_group": 2,
                "fused_mlp_pool": 0}
        check(launches == want, f"LFPModuleMSG launches {launches}, "
              f"expected {want}")
        with ops.plain_versions():
            ref = lfp(xyz2, xyz1, f2, f1)
        gap = largest_gap([out], [ref])
        check(gap == 0.0, f"LFPModuleMSG: kernel path |diff| {gap}")
        check(bool(torch.isfinite(out).all()), "LFPModuleMSG: non-finite")
        ms, dms = call_times(lambda: lfp(xyz2, xyz1, f2, f1), card,
                             "LFPModuleMSG")
        bq_dms = device_ms(lambda: lfp(xyz2, xyz1, f2, f1),
                           KERNEL_NAMES["ball_query"])
    print(f"[surface] 19b LFPModuleMSG B={xyz2.shape[0]}: {xyz1.shape[1]} "
          f"centres x {c1} channels onto {xyz2.shape[1]} (skip {c2}), radii "
          f"{radii}, nsamples {nsamples}: no-hit centres {misses}"
          f"{' (one centre moved outside the room)' if moved else ''}; "
          f"launches {launches}; output {tuple(out.shape)} equal to the "
          f"plain path (largest |diff| {gap}); {ms:.3f} ms (events), "
          f"{dms:.3f} ms device, of which ball_query_group {bq_dms:.4f} ms "
          f"[{card}]")
    return dict(launches=launches, no_hit=misses, moved_centre=moved,
                ms=ms, device_ms=dms, ball_query_group_device_ms=bq_dms)


def cpu_gap(fn, args) -> float:
    """Largest |card - CPU| of fn's outputs over the CPU's largest
    magnitude, fn (a module or function) on the same inputs."""
    import copy
    import torch
    with torch.no_grad():
        got = fn(*args)
        cpu_fn = (copy.deepcopy(fn).cpu() if isinstance(fn, torch.nn.Module)
                  else fn)
        want = cpu_fn(*[a.cpu() for a in args])
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    scale = max(float(w.double().abs().max()) for w in want)
    return largest_gap([g.cpu() for g in got], want) / max(scale, 1e-30)


def small_modules_phase(ep, card):
    """Phase 19c: GroupAllModule, PointsObjClsModule, general_sampling and
    self-type attention at full width, B=16, against the CPU."""
    import torch
    from omni_pq_torch.models import (GroupAllModule, MultiHeadAttention,
                                      PointsObjClsModule, general_sampling)
    dev = ep["seed_xyz"].device
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    hd = ep["seed_features"].shape[-1]
    feats4 = torch.randn(ep["sa4_xyz"].shape[:2] + (256,), generator=gen,
                         device=dev)
    group_all = surface_module(GroupAllModule(256, (256, 512, 1024)), dev,
                               SEED + 2).eval()
    obj_cls = surface_module(PointsObjClsModule(hd), dev, SEED + 3).eval()
    mha = surface_module(MultiHeadAttention(hd, 8, attention_type="self"),
                         dev, SEED + 4).eval()
    with torch.no_grad():
        logits = obj_cls(ep["seed_features"])
    # the kps variant's sampling: the top-scoring seeds, as many as the
    # object queries
    inds = torch.topk(logits[..., 0], ep["cluster_feature"].shape[1],
                      dim=-1).indices.to(torch.int32)
    cases = {
        "GroupAllModule": (group_all, (ep["sa4_xyz"], feats4)),
        "PointsObjClsModule": (obj_cls, (ep["seed_features"],)),
        "general_sampling": (general_sampling,
                             (ep["seed_xyz"], ep["seed_features"], inds)),
        "MultiHeadAttention(self)": (mha, (ep["cluster_feature"],
                                           ep["seed_features"],
                                           ep["seed_features"])),
    }
    out = {}
    for name, (fn, args) in cases.items():
        gap = cpu_gap(fn, args)
        with torch.no_grad():
            ms = time_ms(lambda: fn(*args), reps=5)
        bound = 0.0 if name == "general_sampling" else SURFACE_CPU_REL
        check(gap <= bound, f"{name}: card {gap:.3e} of the largest "
              f"magnitude from the CPU (bound {bound})")
        out[name] = dict(cpu_gap=gap, ms=ms,
                         shapes=[tuple(a.shape) for a in args])
        print(f"[surface] 19c {name} {out[name]['shapes']}: card against "
              f"CPU {gap:.3e} of the largest magnitude (bound {bound}); "
              f"{ms:.3f} ms (events) [{card}]")
    return out


def remat_phase(cfg, dev, card):
    """Phase 19d: phase 8's unfused supervised step, twice without
    remat_sa and once with it from the same state; the fused route's
    launches with and without it."""
    import torch
    from omni_pq_torch.config import SCANNET_MEAN_SIZES
    from omni_pq_torch.data import make_batch
    from omni_pq_torch.infer import build_model
    from omni_pq_torch.train import (OptimizerConfig, TrainState,
                                     batch_to_tensors, make_train_step)
    labeled = batch_to_tensors(
        make_batch(np.random.default_rng(SEED), TRAIN_B, cfg.num_points), dev)
    counted = surface_counted()

    def stepper(c):
        model = build_model(c, dev, seed=SEED)
        state = TrainState(model, OptimizerConfig())
        step = make_train_step(model, c, SCANNET_MEAN_SIZES)
        gen = torch.Generator(dev).manual_seed(SEED)
        return model, state, lambda: step(state, labeled, generator=gen)

    runs, readings = {}, {}
    for tag, remat in (("plain_a", False), ("plain_b", False),
                       ("remat", True)):
        model, state, run = stepper(dataclasses.replace(cfg, remat_sa=remat))
        reset_launch_counts(counted)
        st = run()
        torch.cuda.synchronize()
        readings[tag] = step_reading(model, state, st)
        readings[tag]["launches"] = fused_launch_counts(counted)
        runs[tag] = run
        del model, state, st
    del runs["plain_b"]
    want = {"fps": 6, "ball_query": 0, "ball_query_group": 5,
            "fused_mlp_pool": 0}
    for tag, r in readings.items():
        check(r["launches"] == want, f"19d {tag} step launches "
              f"{r['launches']}, expected {want}")
    noise = reading_gaps(readings["plain_b"], readings["plain_a"])
    gap = reading_gaps(readings["remat"], readings["plain_a"])
    loss = {t: readings[t]["stats"]["total_loss"] for t in readings}
    loss_noise = abs(loss["plain_b"] - loss["plain_a"])
    print(f"[surface] 19d remat_sa step against the step without it: "
          f"total_loss {loss['remat']!r} vs {loss['plain_a']!r} (two steps "
          f"without it: {loss['plain_b']!r}); stats {gap['stats']:.3e}, "
          f"gradients {gap['grads']:.3e} of the norm, BN running stats "
          f"{gap['buffers']:.3e}; two steps without it: {noise['stats']:.3e}"
          f", {noise['grads']:.3e}, {noise['buffers']:.3e} (bounds: the "
          f"loss within the two plain steps' gap, gradients and stats "
          f"{DP_W1_TOL['grads']}, {DP_W1_TOL['stats']}, buffers 0)")
    check(abs(loss["remat"] - loss["plain_a"]) <= loss_noise,
          f"remat_sa: total_loss {loss['remat']} vs {loss['plain_a']}")
    check(gap["grads"] <= DP_W1_TOL["grads"] and gap["stats"]
          <= DP_W1_TOL["stats"], f"remat_sa step: gaps {gap}")
    check(gap["buffers"] == 0.0, f"remat_sa step: BN running stats "
          f"{gap['buffers']} from the step without it: not moved once")
    del readings
    # ms/step and peak memory in turns: plain, remat, remat, plain
    times = {"plain_a": [], "remat": []}
    peaks = {"plain_a": [], "remat": []}
    for tag in ("plain_a", "remat", "remat", "plain_a"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        times[tag].append(wall_ms_per_call(runs[tag], reps=3))
        peaks[tag].append((torch.cuda.max_memory_allocated(dev), base))
    prof = {}
    for tag in times:
        prof[tag], _ = profile_step(runs[tag], {"fps_kernel": 6,
                                                "ball_query_kernel": 5},
                                    float(np.mean(times[tag])))
        print(f"[surface] 19d {'remat_sa' if tag == 'remat' else 'plain'} "
              f"profile: {prof[tag]['line']}")
        print(f"[surface] 19d {'remat_sa' if tag == 'remat' else 'plain'} "
              f"step B={TRAIN_B}: {np.mean(times[tag]):.3f} ms/step "
              f"({[round(t, 1) for t in times[tag]]}), peak memory "
              f"{[round(p / 2**30, 3) for p, _ in peaks[tag]]} GiB, of which "
              f"above the memory held before the step "
              f"{[round((p - b) / 2**30, 3) for p, b in peaks[tag]]} GiB "
              f"[{card}]")
    del runs
    # the fused route: remat_sa changes no launch count
    fcfg = dataclasses.replace(cfg, fused_sa=True)
    fused = {}
    for remat in (False, True):
        model, state, run = stepper(dataclasses.replace(fcfg, remat_sa=remat))
        reset_launch_counts(counted)
        run()
        torch.cuda.synchronize()
        fused[remat] = fused_launch_counts(counted)
        del model, state, run
    check(fused[True] == fused[False] and fused[False]["fused_mlp_pool"] == 4,
          f"fused_sa: launches with remat_sa {fused[True]}, without "
          f"{fused[False]}")
    print(f"[surface] 19d fused_sa step launches with and without remat_sa: "
          f"{fused[True]} (unchanged)")
    return dict(gap=gap, noise=noise, total_loss=loss, step_ms=times,
                peak_bytes=peaks, fused_launches=fused[True],
                profile={k: {kk: v[kk] for kk in (
                    "device_ms", "step_ms", "busy_share", "complete")}
                    for k, v in prof.items()})


def surface_losses_phase(cfg, dev, card, batch, ep, pred_corners):
    """Phase 19e: the legacy teacher and distance losses on the card against
    the same calls on CPU copies."""
    import torch
    from omni_pq_torch.config import SCANNET_MEAN_SIZES
    from omni_pq_torch.data import make_batch
    from omni_pq_torch.infer import build_model
    from omni_pq_torch.losses import (distance_loss_gamma_mixture,
                                      get_loss_mean_teacher)
    from omni_pq_torch.losses import distance as tdist
    from omni_pq_torch.losses.gamma import gamma_mixture_em
    from omni_pq_torch.train import (OptimizerConfig, TrainState,
                                     batch_to_tensors)
    # the mean-teacher loss on phase 12's student and teacher end points
    # (their first step's forwards, the labeled scenes)
    labeled = batch_to_tensors(
        make_batch(np.random.default_rng(SEED), TRAIN_B, cfg.num_points), dev)
    model = build_model(cfg, dev, seed=SEED)
    teacher = TrainState(model, OptimizerConfig(), ema=True).ema_model
    gen = torch.Generator(dev).manual_seed(SEED)
    with torch.no_grad():
        ep_s = model.train()(labeled["point_clouds"], generator=gen)
        ep_t = teacher.train()(labeled["ema_point_clouds"], generator=gen)
    model.eval(), teacher.eval()
    out = {}
    for lam in (0.0, 1.0):
        res = []
        for d in (dev, torch.device("cpu")):
            with torch.no_grad():
                res.append(get_loss_mean_teacher(
                    {**{k: v.to(d) for k, v in ep_s.items()},
                     **{k: v.to(d) for k, v in labeled.items()}},
                    {k: v.to(d) for k, v in ep_t.items()}, SCANNET_MEAN_SIZES,
                    num_layer=cfg.num_decoder_layers, lambda_teacher=lam))
        (loss, stats), (loss_c, stats_c) = res
        check(set(stats) == set(stats_c), "mean-teacher stats differ")
        worst = max(abs(float(stats[k]) - float(v))
                    / (1e-5 * abs(float(v)) + 1e-6)
                    for k, v in stats_c.items())
        check(worst <= 1.0, f"get_loss_mean_teacher(lambda_teacher={lam}): "
              f"a stat {worst:.2f} times its bound from the CPU's")
        out[f"mean_teacher_{lam}"] = dict(
            loss=float(loss), loss_cpu=float(loss_c),
            teacher_loss=float(stats["teacher_loss"]),
            gt_loss=float(stats["gt_loss"]), worst_of_bound=worst)
        print(f"[surface] 19e get_loss_mean_teacher(lambda_teacher={lam}) "
              f"B={TRAIN_B}: loss {float(loss)!r} (CPU {float(loss_c)!r}), "
              f"teacher_loss {float(stats['teacher_loss']):.6f}, gt_loss "
              f"{float(stats['gt_loss']):.6f}; every stat within rtol 1e-5 "
              f"+ 1e-6 of the CPU's (largest {worst:.3f} of the bound)")
    del model, teacher, ep_s, ep_t
    # the distance loss on phase 3's forward: its decoded quads, points
    # within WALL_BAND of a ground-truth wall quad's plane labelled wall
    pts = batch["point_clouds"][..., :3]
    Bx, N, _ = pts.shape
    Q = max(1, max(len(c) for c in pred_corners))
    corners = np.zeros((Bx, Q, 4, 3), np.float32)
    qmask = np.zeros((Bx, Q), bool)
    for b, cs in enumerate(pred_corners):
        if len(cs):
            corners[b, :len(cs)] = np.stack(cs)
            qmask[b, :len(cs)] = True
    check(qmask.any(), "19e: the decode kept no quad")
    g_c, g_n = batch["gt_quad_centers"], batch["gt_normal_vectors"]
    walls = ((np.arange(g_c.shape[1])[None] < batch["num_gt_quads"][:, None])
             & (np.abs(g_n[..., 2]) < 0.5))
    plane = np.abs(np.einsum("bnqc,bqc->bnq", pts[:, :, None] - g_c[:, None],
                             g_n))
    labels = (np.where(walls[:, None], plane, np.inf) < WALL_BAND).any(-1)
    labels = labels.astype(np.int64)
    share = float(labels.mean())
    args = [torch.from_numpy(a) for a in (pts, labels, corners, qmask)]
    res = []
    for d in (dev, torch.device("cpu")):
        a = [t.to(d) for t in args]
        loss, aux = distance_loss_gamma_mixture(*a)
        lay = aux["layout_mask"]
        d_abs = torch.where(lay, aux["distance"], 1.0).abs() + 1e-12
        mean = (torch.where(lay, d_abs, 0.0).sum(-1, keepdim=True)
                / lay.sum(-1, keepdim=True).clamp_min(1))
        em_in = torch.where(lay, d_abs, mean)
        fit = gamma_mixture_em(em_in, 2.0, 40.0, 10.0, 20.0, 0.5, 20)
        fit64 = gamma_mixture_em(em_in.double(), 2.0, 40.0, 10.0, 20.0, 0.5,
                                 20)
        res.append(dict(loss=float(loss),
                        aux={k: v.cpu() for k, v in aux.items()},
                        fit=torch.cat(fit, -1).cpu(),
                        fit64=torch.cat(fit64, -1).cpu(),
                        root=tdist._pdf_crossover(*fit)[:, 0].cpu()))
    card_r, cpu_r = res
    # indices equal but at ties within the distances' bound
    dist_c, dist_p = card_r["aux"]["distance"], cpu_r["aux"]["distance"]
    idx_c, idx_p = card_r["aux"]["idx_array"], cpu_r["aux"]["idx_array"]
    tie = (idx_c != idx_p)
    check(bool(((dist_c - dist_p).abs() <= 1e-6 + 1e-6 * dist_p.abs())[~tie]
               .all()), "19e: distances beyond 1e-6 of the CPU's")
    check(bool(((dist_c.abs() - dist_p.abs()).abs() <= 2e-6)[tie].all()),
          "19e: a quad index differs where the distances do not tie")
    # the fitted mixture. A float32 EM of 20 steps over ~17 000 distances a
    # scene determines the parameters only to ~1e-4 relative (the CPU's own
    # float32 fit reads 2.2e-4 from the float64 EM of the same input on
    # this phase's data), so the two sides' float32 fits are no closer than
    # their roundings. Held instead: the same EM in float64 on each side's
    # input (the card's code against the CPU's; the inputs differ by the
    # distances' 1e-6) within 1e-4 relative; and the card's float32 fit no
    # farther from its float64 fit than twice the CPU's float32 fit is from
    # the CPU's (or 1e-4): the card's float32 EM as accurate as the CPU's.
    def rel(a, b):
        return float(((a - b).abs() / b.abs()).max())
    fit_rel = rel(card_r["fit"].double(), cpu_r["fit"].double())
    fit64_rel = rel(card_r["fit64"], cpu_r["fit64"])
    err_card = rel(card_r["fit"].double(), card_r["fit64"])
    err_cpu = rel(cpu_r["fit"].double(), cpu_r["fit64"])
    check(fit64_rel <= 1e-4, f"19e: the float64 mixture {fit64_rel:.2e} "
          "relative from the CPU's")
    check(err_card <= max(2 * err_cpu, 1e-4), f"19e: the card's float32 "
          f"mixture {err_card:.2e} relative from its float64 fit, the CPU's "
          f"{err_cpu:.2e}")
    # the roots: as far apart as the two mixtures' float64 roots, plus each
    # side's float32 rounding
    (x_c, r_c), (x_p, r_p) = (crossover64(r["fit"].numpy())
                              for r in (card_r, cpu_r))
    root_gap = (card_r["root"].double() - cpu_r["root"].double()).abs()
    root_of_bound = float((root_gap.numpy() / (np.abs(x_c - x_p) + r_c
                                               + r_p)).max())
    check(root_of_bound <= 1.0, f"19e: the roots {root_of_bound:.2f} times "
          f"their bound apart")
    root_rel = float((root_gap / cpu_r["root"].double().abs()).max())
    keep_c, keep_p = card_r["aux"]["keep_mask"], cpu_r["aux"]["keep_mask"]
    band = (card_r["root"] - cpu_r["root"]).abs()[:, None] + 1e-6
    outside = (dist_p.abs() - cpu_r["root"][:, None]).abs() > band
    check(bool((keep_c == keep_p)[outside].all()), "19e: keep masks differ "
          "away from the crossover")
    n_diff = int((keep_c != keep_p).sum())
    kept = keep_p.sum(-1)
    fitted = kept > 0
    check(bool(fitted.any()), "19e: no scene kept a point")
    loss_rel = (abs(card_r["loss"] - cpu_r["loss"])
                / max(abs(cpu_r["loss"]), 1e-30))
    loss_bound = 1e-5 + 2 * n_diff / int(kept[fitted].min())
    check(loss_rel <= loss_bound, f"19e: distance loss {card_r['loss']} vs "
          f"CPU {cpu_r['loss']} ({loss_rel:.2e}, bound {loss_bound:.2e})")
    print(f"[surface] 19e distance_loss_gamma_mixture B={Bx} N={N}: "
          f"{int(qmask.sum())} decoded quads (up to {Q} a scene); wall "
          f"labels on {share:.4f} of the points (within {WALL_BAND} m of a "
          f"ground-truth wall quad's plane); loss {card_r['loss']!r} (CPU "
          f"{cpu_r['loss']!r}, {loss_rel:.2e}); scenes fitted "
          f"{int(fitted.sum())}, kept points {int(kept.sum())}; index ties "
          f"{int(tie.sum())}; mixture {fit_rel:.2e} (float64 EM "
          f"{fit64_rel:.2e}; float32 against float64: card {err_card:.2e}, "
          f"CPU {err_cpu:.2e}) and root {root_rel:.2e} relative from the "
          f"CPU's (the root {root_of_bound:.3f} of its bound); keep masks "
          f"differ at {n_diff} points (between the roots only)")
    out["distance"] = dict(loss=card_r["loss"], loss_cpu=cpu_r["loss"],
                           quads=int(qmask.sum()), wall_share=share,
                           index_ties=int(tie.sum()), fit_rel=fit_rel,
                           fit64_rel=fit64_rel, fit_err_card=err_card,
                           fit_err_cpu=err_cpu,
                           root_rel=root_rel, root_of_bound=root_of_bound,
                           keep_diff=n_diff)
    return out


def crossover64(fit):
    """The gamma crossover of `losses.distance._pdf_crossover` for each row
    (a1, b1, a2, b2, w) of `fit`, bisected in float64; and the rounding
    bound of a float32 bisection there: 2^-20 of the sum of the log-pdf
    difference's terms' magnitudes over its slope (the CPU tests' bound)."""
    from scipy.special import gammaln
    a1, b1, a2, b2, w = np.asarray(fit, np.float64).T

    def mode(a, b):
        return np.maximum(a - 1.0, 1e-3) / np.maximum(b, 1e-6)

    def logpdf(x, a, b):
        return a * np.log(b) - gammaln(a) + (a - 1) * np.log(x) - b * x
    lo = np.minimum(mode(a1, b1), mode(a2, b2)) * 1e-3 + 1e-6
    hi = np.maximum(mode(a1, b1), mode(a2, b2)) * 4.0 + 1e-3
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        right = (np.log(w) + logpdf(mid, a1, b1) - np.log1p(-w)
                 - logpdf(mid, a2, b2)) > 0
        lo, hi = np.where(right, mid, lo), np.where(right, hi, mid)
    x = 0.5 * (lo + hi)
    terms = (np.abs(np.log(w)) + np.abs(np.log1p(-w))
             + sum(np.abs(a * np.log(b)) + np.abs(gammaln(a))
                   + np.abs((a - 1) * np.log(x)) + np.abs(b * x)
                   for a, b in ((a1, b1), (a2, b2))))
    return x, 2.0 ** -20 * terms / np.abs((a1 - a2) / x - b1 + b2)


def surface_phase(cfg, pc, batch, ep, pred_corners, card):
    """Phase 19: the module surface off the PQTransformer's path. Returns
    (report, the idx-only ball query's rows: 19a's two launches)."""
    report = {}
    report["msg"], bq_rows = msg_phase(pc, card)
    report["lfp"] = lfp_phase(ep, card)
    report["small_modules"] = small_modules_phase(ep, card)
    report["remat"] = remat_phase(cfg, pc.device, card)
    report["losses"] = surface_losses_phase(cfg, pc.device, card, batch, ep,
                                            pred_corners)
    return report, bq_rows


def float64_phase(cfg, dev, pc, batch, model, ep, rows, report, card):
    """Phase 20: the float64 route beside phase 3's float32 forward."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from omni_pq_torch import ops
    from omni_pq_torch.config import SCANNET_MEAN_SIZES
    from omni_pq_torch.data import make_batch
    from omni_pq_torch.infer import build_model, eval_forward
    from omni_pq_torch.train import (OptimizerConfig, TrainState,
                                     batch_to_tensors, make_train_step)
    f64 = torch.float64
    cfg64 = dataclasses.replace(cfg, compute_dtype="float64")
    out = {}
    counted = surface_counted()
    want = {"fps": 6, "ball_query": 5, "ball_query_group": 0,
            "fused_mlp_pool": 0}

    # (a) the eval forward at B=16
    model64 = build_model(cfg64, dev, seed=SEED)
    check(all(p.dtype == f64 for p in model64.parameters()),
          "float64 route: parameters not float64")
    eval_forward(model64, pc)  # warm-up
    picks32, picks64 = [], []
    restore = record_fps_picks(ops, picks32)
    try:
        eval_forward(model, pc)
    finally:
        restore()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts(counted)
    restore = record_fps_picks(ops, picks64)
    try:
        ep64 = eval_forward(model64, pc)
        torch.cuda.synchronize()
    finally:
        restore()
    launches = fused_launch_counts(counted)
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    print(f"[float64] launches in one forward: {launches}")
    check(launches == want, f"float64 forward launches {launches}, "
          f"expected {want}")
    check(set(ep64) == set(ep), "float64 forward: other end_points keys")
    for k, v in ep64.items():
        if v.dtype.is_floating_point:
            check(v.dtype == f64, f"float64 forward: {k} is {v.dtype}")
            check(bool(torch.isfinite(v).all()),
                  f"float64 forward: {k} has non-finite values")
        else:
            check(v.dtype == torch.int32, f"float64 forward: {k} {v.dtype}")
    check(len(picks32) == len(picks64) == 6, "float64: FPS calls recorded "
          f"{len(picks32)} / {len(picks64)}, expected 6")
    calls = ["sa1", "sa2", "sa3", "sa4", "quad_queries", "vote_aggregation"]
    moved = {c: int((a != b).sum()) for c, a, b in
             zip(calls, picks32, picks64)}
    print(f"[float64] FPS picks that differ from phase 3's float32 forward, "
          f"by call: {moved} (all but vote aggregation's must be 0: their "
          f"inputs' float32 copies are phase 3's inputs)")
    check(all(v == 0 for c, v in moved.items() if c != "vote_aggregation"),
          f"float64 FPS picks differ from phase 3's: {moved}")
    with ops.plain_versions():
        ep64_plain = eval_forward(model64, pc)
    torch.cuda.synchronize()
    check(fused_launch_counts(counted) == want,
          "the float64 plain-path forward launched a kernel")
    diffs = {k: float((ep64[k].double() - ep64_plain[k].double()).abs().max())
             for k in ep64}
    worst = max(diffs.items(), key=lambda kv: kv[1])
    print(f"[float64] kernel vs plain forward: "
          f"{sum(v > 0 for v in diffs.values())} keys differ, largest |diff| "
          f"{worst[1]} ({worst[0]}) (tolerance 0)")
    check(worst[1] == 0.0, "float64 kernel-path forward != plain-path: "
          + ", ".join(f"{k} {v}" for k, v in diffs.items() if v > 0))
    del ep64_plain
    out.update(launches=launches, fps_picks_moved=moved)

    # (b) the float64 route against phase 3's float32 forward
    gaps = {k: float((ep64[k] - ep[k].double()).abs().max()
                     / max(float(ep64[k].abs().max()), 1e-300))
            for k in ep64 if ep64[k].dtype.is_floating_point}
    top = sorted(gaps.items(), key=lambda kv: -kv[1])
    out["float32_gap_of_max"] = gaps
    print("[float64] float32 route's largest gap over each key's largest "
          "magnitude (printed only): "
          + ", ".join(f"{k} {v:.2e}" for k, v in top[:8]) + "; median "
          f"{float(np.median(list(gaps.values()))):.2e}")

    # (c) the card against the port on this machine's CPU, B=2
    t0 = time.time()
    model_cpu = build_model(cfg64, "cpu", seed=SEED)
    ep_cpu = eval_forward(model_cpu, batch["point_clouds"][:F64_CPU_B])
    ep_card = eval_forward(model64, pc[:F64_CPU_B])
    cpu_s = time.time() - t0
    flips = {k: int((ep_card[k].cpu() != v).sum()) for k, v in ep_cpu.items()
             if not v.dtype.is_floating_point}
    if any(flips.values()):
        # an index decided on a float32 copy flips when the card's and the
        # CPU's float64 inputs round to different float32 values
        va_card = ep_card["vote_xyz"].cpu()
        va_cpu = ep_cpu["vote_xyz"]
        print(f"[float64] index flips card vs CPU {flips}: vote_xyz float64 "
              f"gap {float((va_card - va_cpu).abs().max())}, float32 copies "
              f"differ at {int((va_card.float() != va_cpu.float()).sum())} "
              f"coordinates")
    check(not any(flips.values()), f"float64 card vs CPU: indices differ "
          f"{flips}")
    cpu_gaps = {k: float((ep_card[k].cpu() - v).abs().max()
                         / max(float(v.abs().max()), 1e-300))
                for k, v in ep_cpu.items() if v.dtype.is_floating_point}
    worst = max(cpu_gaps.items(), key=lambda kv: kv[1])
    out.update(cpu_gap_of_max=cpu_gaps, cpu_s=cpu_s)
    print(f"[float64] card vs CPU at B={F64_CPU_B}: indices bitwise, largest "
          f"gap over a key's largest magnitude {worst[1]:.3e} ({worst[0]}), "
          f"bound {F64_CPU_REL} ({cpu_s:.1f} s with the CPU forward)")
    check(worst[1] <= F64_CPU_REL, f"float64 card vs CPU: {worst}")
    del model_cpu, ep_cpu, ep_card

    # (d) the backward of the weighted scalar, kernel path against plain
    x2 = pc[:F64_CPU_B].to(f64)
    r = np.random.default_rng(17)
    with torch.no_grad():
        probe = model64(x2)
    weights = {p + f: torch.from_numpy(r.normal(size=tuple(
        probe[p + f].shape))).to(dev) for p in F64_PREFIXES
        for f in F64_FIELDS if p + f in probe}
    del probe

    def scalar_grads():
        model64.zero_grad(set_to_none=True)
        e = model64(x2)
        loss = sum((e[k] * w).mean() for k, w in weights.items())
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), {n: (torch.zeros_like(p) if p.grad is None
                                 else p.grad.clone())
                             for n, p in model64.named_parameters()}
    reset_launch_counts(counted)
    loss_k, grads_k = scalar_grads()
    check(fused_launch_counts(counted) == want,
          f"float64 scalar forward launches {fused_launch_counts(counted)}")
    with ops.plain_versions():
        loss_p, grads_p = scalar_grads()
    model64.zero_grad(set_to_none=True)
    norm = float(torch.sqrt(sum((g * g).sum() for g in grads_p.values())))
    ggaps = {n: float((grads_k[n] - g).abs().max()) / max(
        float(g.abs().max()), F64_GRAD_FLOOR * norm, 1e-300)
        for n, g in grads_p.items()}
    worst = max(ggaps.items(), key=lambda kv: kv[1])
    out.update(scalar=(loss_k, loss_p), grad_gap=worst)
    print(f"[float64] weighted scalar {loss_k!r} (plain {loss_p!r}); "
          f"gradients kernel vs plain path: worst leaf {worst[0]} "
          f"{worst[1]:.3e} of its scale, bound {F64_GRAD_REL} "
          f"({len(weights)} terms, {len(ggaps)} leaves)")
    check(loss_k == loss_p, "float64 scalar differs between the paths")
    check(worst[1] <= F64_GRAD_REL, f"float64 gradients: {worst}")
    del grads_k, grads_p, weights, x2

    # (e) one supervised step at B=3, both paths from the same state
    labeled = batch_to_tensors(
        make_batch(np.random.default_rng(SEED), TRAIN_B, cfg.num_points), dev,
        f64)
    steps = {}
    for path in ("kernel", "plain"):
        m = build_model(cfg64, dev, seed=SEED)
        state = TrainState(m, OptimizerConfig())
        step = make_train_step(m, cfg64, SCANNET_MEAN_SIZES)
        gen = torch.Generator(dev).manual_seed(SEED)
        reset_launch_counts(counted)
        if path == "plain":
            with ops.plain_versions():
                st = step(state, labeled, generator=gen)
        else:
            st = step(state, labeled, generator=gen)
        torch.cuda.synchronize()
        steps[path] = dict(m=m, state=state, step=step, gen=gen,
                           stats={k: float(v) for k, v in st.items()},
                           launches=fused_launch_counts(counted))
        check(all(np.isfinite(v) for v in steps[path]["stats"].values()),
              f"float64 {path} step: non-finite stats")
        check(all(v.dtype == f64 for k, v in st.items()
                  if k in ("total_loss", "grad_norm", "loss")),
              f"float64 {path} step: stats not float64")
    check(steps["kernel"]["launches"] == want,
          f"float64 step launches {steps['kernel']['launches']}")
    lk, lp = (steps[p]["stats"]["total_loss"] for p in ("kernel", "plain"))
    rel = abs(lk - lp) / abs(lp)
    print(f"[float64] supervised step B={TRAIN_B}: total_loss {lk!r} (plain "
          f"path {lp!r}, {rel:.2e} apart, bound {F64_STEP_LOSS_REL}), "
          f"grad_norm {steps['kernel']['stats']['grad_norm']!r}, launches "
          f"{steps['kernel']['launches']}")
    check(rel <= F64_STEP_LOSS_REL, "float64 step: total_loss differs from "
          "the plain path")
    k = steps["kernel"]
    del steps["plain"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = wall_ms_per_call(
        lambda: k["step"](k["state"], labeled, generator=k["gen"]), reps=3)
    step_peak = torch.cuda.max_memory_allocated(dev)
    prof, _ = profile_step(
        lambda: k["step"](k["state"], labeled, generator=k["gen"]),
        {"fps_kernel": 6, "ball_query_kernel": 5,
         **fused_train_launches([])}, step_ms)
    out.update(step_stats=k["stats"], step_loss_rel=rel, step_ms=step_ms,
               step_peak_bytes=step_peak, step_profile=prof)
    f32 = report["train"]
    print(f"[float64] supervised step: {step_ms:.1f} ms/step (3 warm steps), "
          f"peak memory {step_peak / 2**30:.2f} GiB; phase 8's float32 "
          f"unfused step {np.mean(f32['step_ms']['unfused']):.1f} ms/step, "
          f"{f32['routes']['unfused']['peak'] / 2**30:.2f} GiB [{card}]")
    print(f"[float64] profile of one step: {prof['line']}; phase 8's float32 "
          f"unfused step: {f32['profile']['unfused']['device_ms']:.3f} ms "
          f"of kernels")
    del steps, k

    # (f) times, peak and profile of (a)
    turns = []
    for which in ("float32", "float64", "float64", "float32"):
        m = model if which == "float32" else model64
        eval_forward(m, pc)
        turns.append((which, wall_ms_per_call(lambda: eval_forward(m, pc),
                                              reps=3)))
    f32_ms = [t for w, t in turns if w == "float32"]
    f64_ms = [t for w, t in turns if w == "float64"]
    fps_dev = device_ms(lambda: eval_forward(model64, pc),
                        KERNEL_NAMES["fps"], reps=3)
    bq_dev = device_ms(lambda: eval_forward(model64, pc),
                       KERNEL_NAMES["ball_query"], reps=3)
    check(fps_dev is not None and bq_dev is not None,
          "float64: the profiler recorded no FPS or ball-query kernel")
    fps32 = sum(r["device_ms"] for r in rows["fps"])
    bq32 = sum(r["device_ms"] for r in rows["ball_query"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eval_forward(model64, pc)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA) / 1e3
    op_ms = sorted(((e.self_device_time_total / 1e3, e.key) for e in events
                    if e.device_type == DeviceType.CPU
                    and e.self_device_time_total > 0), reverse=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_float64_profile.txt"),
              "w") as f:
        f.write(f"{card}\nfloat64 forward B={B}: wall {wall_ms:.3f} ms, "
                f"device kernel time {busy_ms:.3f} ms\n"
                + events.table(sort_by="self_device_time_total",
                               row_limit=25) + "\n")
    out.update(forward_ms=f64_ms, float32_forward_ms=f32_ms,
               fps_device_ms=fps_dev, ball_query_device_ms=bq_dev,
               float32_fps_device_ms=fps32,
               float32_ball_query_device_ms=bq32,
               profile=dict(wall_ms=wall_ms, device_ms=busy_ms,
                            by_op=op_ms[:12]))
    print(f"[float64] forward B={B}: {', '.join(f'{t:.3f}' for t in f64_ms)}"
          f" ms/batch = {B / np.mean(f64_ms) * 1e3:.2f} scenes/s against "
          f"phase 3's float32 {', '.join(f'{t:.3f}' for t in f32_ms)} in the "
          f"same turns (float32, float64, float64, float32); peak memory "
          f"{out['peak_mem_bytes'] / 2**30:.2f} GiB (float32 "
          f"{report['peak_mem_bytes'] / 2**30:.2f}) [{card}]")
    print(f"[float64] kernel device time a forward: fps {fps_dev:.4f} ms "
          f"(float32 route, phase 6: {fps32:.4f}), idx-only ball query "
          f"{bq_dev:.4f} ms (phase 6's idx-only rows at the same shapes: "
          f"{bq32:.4f}); profiled forward wall {wall_ms:.3f} ms, kernel time "
          f"{busy_ms:.3f} ms (busy share {busy_ms / wall_ms:.3f})")
    for ms, key in op_ms[:10]:
        print(f"[float64] {ms:10.3f} ms  {key[:90]}")
    del model64, ep64
    return out


# -- phase 21: the experiment drivers at full width ---------------------------

# each driver's knobs for phase 21 (environment variables, as a user sets
# them): a few steps of each at full width, one eval pass or two
EXPERIMENT_KNOBS = {
    "convergence": {"CONV_STEPS": "10", "CONV_EVAL_EVERY": "10",
                    "CONV_SEEDS": "0", "CONV_BF16": ""},
    "fitted_mixture": {"FM_STEPS": "5", "FM_PRETRAIN": "0"},
    "semi_sup_ab": {"AB_STEPS": "6", "AB_EVAL_EVERY": "6",
                    "AB_PRETRAIN": "3", "AB_SEEDS": "0"},
}
# Protocol B's arms, each run on its own (AB_ARMS=<arm>)
AB_ARMS = ("sup_ft", "ema_ft", "gamma_ft", "gamma_fixed_ft", "arkit_ft",
           "arkit_centered_ft")


def wrapped_steps(steps: int) -> int:
    """The calls, of `steps` in a row of one step function, state and batch
    shape, that run through the kernels' wrappers: the warm-ups and the
    capture (the later calls replay the CUDA graph)."""
    from omni_pq_torch.train.step import WARMUP_CALLS
    return min(steps, WARMUP_CALLS + 1)


# forwards through the kernels' wrappers in each driver's run (a forward
# launches 6 FPS and 5 ball-query-group kernels): convergence 10
# supervised steps at B=4 and evals after steps 1 and 10; fitted_mixture 5
# semi steps (student + teacher) a criterion, each on its own state; a
# semi_sup_ab arm 3 supervised and 3 semi steps (two step functions), the
# student's eval after step 1, the student's and the teacher's after step
# 6; `sup_ft` 3 + 3 supervised steps (two step functions) and the
# student's two evals
def experiment_forwards() -> dict:
    return {
        "convergence": wrapped_steps(10) + 2,
        "fitted_mixture": 2 * wrapped_steps(5) * 2,
        **{f"semi_sup_ab:{arm}": wrapped_steps(3) + wrapped_steps(3) * 2
           + 1 + 2 for arm in AB_ARMS},
        "semi_sup_ab:sup_ft": 2 * wrapped_steps(3) + 1 + 1}


@contextlib.contextmanager
def environ(values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def recorded_arm_pools(semi_sup_ab, seen):
    """semi_sup_ab.arm_pools, which run_arm calls for an arm's pools, also
    recording them in `seen` by base arm."""
    arm_pools = semi_sup_ab.arm_pools

    def recording(base, labeled, weak, val):
        seen[base] = arm_pools(base, labeled, weak, val)
        return seen[base]
    semi_sup_ab.arm_pools = recording
    try:
        yield
    finally:
        semi_sup_ab.arm_pools = arm_pools


def experiments_phase(dev, card):
    """Phase 21: the experiment drivers through their main(), at full
    width, for a few steps each: convergence, fitted_mixture, and every
    Protocol-B arm of semi_sup_ab on its own; their outputs in a temporary
    directory, removed after."""
    import tempfile
    import torch
    from omni_pq_torch import ops
    from omni_pq_torch.experiments import (common, convergence,
                                           fitted_mixture, semi_sup_ab)
    report = {}
    seen_pools = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_exp_") as tmp, \
            recorded_arm_pools(semi_sup_ab, seen_pools):
        argv = {
            "convergence": ["--json", f"{tmp}/conv.json",
                            "--doc", f"{tmp}/CONV.md"],
            "fitted_mixture": ["--json", f"{tmp}/fm.json",
                               "--doc", f"{tmp}/FM.md"]}
        knobs = dict(EXPERIMENT_KNOBS)
        paths = {"convergence": f"{tmp}/conv.json",
                 "fitted_mixture": f"{tmp}/fm.json"}
        runs = [("convergence", convergence), ("fitted_mixture",
                                               fitted_mixture)]
        for arm in AB_ARMS:
            name = f"semi_sup_ab:{arm}"
            paths[name] = f"{tmp}/ab_{arm}.json"
            argv[name] = ["--doc", f"{tmp}/SEMI_{arm}.md"]
            knobs[name] = dict(EXPERIMENT_KNOBS["semi_sup_ab"], AB_ARMS=arm,
                               AB_OUT=paths[name])
            runs.append((name, semi_sup_ab))
        for name, driver in runs:
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            ops.fps.launches = 0
            ops.ball_query_group.launches = 0
            t0 = time.time()
            with environ(knobs[name]):
                rc = driver.main(argv[name] + ["--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = {"fps": ops.fps.launches,
                        "ball_query_group": ops.ball_query_group.launches}
            check(rc == 0, f"[experiments] {name} returned {rc}")
            n = experiment_forwards()[name]
            check(launches == {"fps": 6 * n, "ball_query_group": 5 * n},
                  f"[experiments] {name}: launches {launches}, expected "
                  f"{6 * n} fps and {5 * n} ball_query_group ({n} forwards)")
            with open(paths[name]) as f:
                out = json.load(f)
            report[name] = {"launches": launches, "wall_s": wall,
                            "peak_gib": torch.cuda.max_memory_allocated(dev)
                            / 2**30,
                            "reserved_gib": torch.cuda.max_memory_reserved(dev)
                            / 2**30}
            if name == "convergence":
                curve = out["curves"]["0"]
                check(all(np.isfinite(c["loss"]) and np.isfinite(c["f1"])
                          for c in curve), "[experiments] convergence: a "
                      "loss or F1 is not finite")
                check([c["step"] for c in curve] == [1, 10],
                      "[experiments] convergence: evals after steps "
                      f"{[c['step'] for c in curve]}, expected [1, 10]")
                report[name].update(ms_per_step=out["ms_per_step"]["0"],
                                    eval_s=curve[-1]["eval_s"],
                                    f1=curve[-1]["f1"])
            elif name == "fitted_mixture":
                for crit in ("fixed", "fitted"):
                    curve = out[crit]["curve"]
                    check(len(curve) == 1 and all(
                        np.isfinite(c[k]) for c in curve
                        for k in fitted_mixture.RECORDED),
                        f"[experiments] fitted_mixture {crit}: "
                        "expected one finite record with gamma_engaged_frac")
                report[name].update(
                    ms_per_step={c: out[c]["ms_per_step"]
                                 for c in ("fixed", "fitted")},
                    engaged={c: out[c]["curve"][-1]["gamma_engaged_frac"]
                             for c in ("fixed", "fitted")},
                    eval_s=None)
            else:
                report[name].update(ab_arm_reading(
                    name.split(":")[1], out, seen_pools, semi_sup_ab,
                    common))
            r = report[name]
            print(f"[experiments] {name}: {n} forwards, launches {launches}, "
                  f"ms/step {r['ms_per_step']}, eval {r['eval_s']} s, wall "
                  f"{wall:.1f} s, peak {r['peak_gib']:.2f} GiB, reserved "
                  f"{r['reserved_gib']:.2f} GiB [{card}]")
    return report


def ab_arm_reading(arm, out, seen_pools, semi_sup_ab, common) -> dict:
    """Phase 21's checks of one Protocol-B arm's 3 + 3 steps (its results
    file `out`, the pools it trained on) and what it prints."""
    base, _ = semi_sup_ab.split_arm(arm)
    flags = semi_sup_ab.ARM_FLAGS[base]
    where = f"[experiments] semi_sup_ab {arm}"
    (run,) = out["runs"]
    last = run["curve"][-1]
    check([c["step"] for c in run["curve"]] == [1, 6],
          f"{where}: evals after steps {[c['step'] for c in run['curve']]}"
          ", expected [1, 6]")
    check(run["backfilled"], f"{where}: the teacher was not backfilled")
    check(("f1_ema" in last) == flags.ema,
          f"{where}: the teacher's eval {'missing' if flags.ema else 'run'}")
    check(all(np.isfinite(c["loss"]) for c in run["curve"]),
          f"{where}: a loss is not finite")
    check(("gamma_engaged_frac" in last) == flags.gamma_mixture,
          f"{where}: gamma_engaged_frac recorded: "
          f"{'gamma_engaged_frac' in last}")
    reading = {"ms_per_step": last["ms_per_step"], "eval_s": last["eval_s"],
               "f1": last["f1"], "f1_ema": last.get("f1_ema"),
               "engaged": last.get("gamma_engaged_frac")}
    if flags.arkit:
        check(last.get("arkit_collisions", 0) > 0,
              f"{where}: arkit_collisions {last.get('arkit_collisions')}, "
              "expected > 0")
        labeled, weak, val = seen_pools[base]
        # each scene's median xy: ~0 once centred
        med = max(float(np.abs(np.median(p["point_clouds"][..., :2],
                                         axis=1)).max())
                  for p in (labeled, weak, val))
        centred = base == "arkit_centered"
        check(med < 1e-3 if centred else med > 0.5,
              f"{where}: the largest |median xy| of a scene is {med:.4g} m,"
              f" expected {'< 1e-3 (centred)' if centred else '> 0.5'}")
        check(all(not weak[k].any() for k in common.QUAD_GT_KEYS),
              f"{where}: the weak pool keeps quad ground truth")
        reading.update(collisions=last["arkit_collisions"],
                       arkit_pc_loss=last["arkit_pc_loss"],
                       max_median_xy=med)
    return reading


# -- phase 22: the student-fall diagnosis script at full width ----------------

# gamma_ft's trunk to step 3 (its supervised pretrain), then 3 semi steps a
# branch and their one eval after step 6
FALL_ARGS = ["--arm", "gamma_ft", "--seed", "0", "--steps", "6",
             "--pretrain", "3", "--branch_at", "3", "--eval_every", "6"]
FALL_BRANCHES = ("B1", "B2")


def fall_forwards(k: int) -> dict:
    """Forwards of each part: the trunk's 3 supervised steps and the
    student's eval after step 1; a branch's 3 semi steps (student and
    teacher) and, at its eval, the student, the k re-estimation forwards,
    the re-estimated student and the teacher."""
    return {"trunk": 3 + 1, **{b: 3 * 2 + 1 + k + 1 + 1
                              for b in FALL_BRANCHES}}


def same_state(a, b) -> bool:
    """Two student_fall runs' states bitwise equal: both models'
    parameters and buffers, the AdamW moments and counts, the TrainState's
    step, the generator."""
    sa, sb = a.state, b.state
    for ma, mb in ((sa.model, sb.model), (sa.ema_model, sb.ema_model)):
        da, db = ma.state_dict(), mb.state_dict()
        if da.keys() != db.keys() or not all(
                torch_equal(da[k], db[k]) for k in da):
            return False
    oa, ob = sa.optimizer, sb.optimizer
    pa, pb = list(sa.model.parameters()), list(sb.model.parameters())
    moments = all(oa.state[x].keys() == ob.state[y].keys() and all(
        torch_equal(oa.state[x][k], ob.state[y][k]) for k in oa.state[x])
        for x, y in zip(pa, pb))
    return (moments and (oa.count, oa.mini_step, sa.step)
            == (ob.count, ob.mini_step, sb.step)
            and torch_equal(a.gen.get_state(), b.gen.get_state()))


def torch_equal(x, y) -> bool:
    import torch
    return x.dtype == y.dtype and torch.equal(x, y.to(x.device))


def student_fall_phase(dev, card):
    """Phase 22: scripts/student_fall_torch.py's trunk and two branches at
    full width, in this process (the launch counters are its)."""
    import importlib.util
    import tempfile
    import torch
    from omni_pq_torch import ops
    spec = importlib.util.spec_from_file_location(
        "student_fall_torch", os.path.join(ROOT, "scripts",
                                           "student_fall_torch.py"))
    sf = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sf)
    forwards = fall_forwards(sf.REESTIMATE_K)
    report = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fall_") as tmp:
        state = os.path.join(tmp, "state.pth")
        for name in ("trunk",) + FALL_BRANCHES:
            mode = "trunk" if name == "trunk" else "branch"
            args = sf.parse_args(
                [mode, *FALL_ARGS, "--device", "cuda", "--state", state,
                 "--json", os.path.join(tmp, f"{name}.json")]
                + ([] if name == "trunk" else ["--name", name]))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            ops.fps.launches = 0
            ops.ball_query_group.launches = 0
            t0 = time.time()
            run, out = (sf.trunk if name == "trunk" else sf.branch)(args)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = {"fps": ops.fps.launches,
                        "ball_query_group": ops.ball_query_group.launches}
            n = forwards[name]
            where = f"[student_fall] {name}"
            check(launches == {"fps": 6 * n, "ball_query_group": 5 * n},
                  f"{where}: launches {launches}, expected {6 * n} fps and "
                  f"{5 * n} ball_query_group ({n} forwards)")
            check(out["stopped_at"] is None, f"{where}: stopped")
            last = out["curve"][-1]
            check(all(np.isfinite(v) for k, v in last.items()
                      if isinstance(v, float)), f"{where}: a record is not "
                  f"finite: {last}")
            if name == "trunk":
                check([c["step"] for c in out["curve"]] == [1],
                      f"{where}: evals after {[c['step'] for c in out['curve']]}")
                fresh = sf.setup(args, "trunk")
                check(sf.load_state(state, fresh) == 3,
                      f"{where}: the saved state's next step is not 3")
                check(same_state(run, fresh), f"{where}: the saved state "
                      "does not reload bitwise")
                size = os.path.getsize(state) / 2**20
                del fresh
            else:
                missing = set(sf.SEMI_RECORD_KEYS) - set(last)
                check(last["step"] == 6 and not missing,
                      f"{where}: the eval after step {last['step']} lacks "
                      f"{sorted(missing)}")
                check(out["tf32"]["matmul"] == (name == "B2"),
                      f"{where}: ran with TF32 {out['tf32']}")
                check(not torch.backends.cuda.matmul.allow_tf32
                      and not torch.backends.cudnn.allow_tf32,
                      f"{where}: TF32 left on after the branch")
                check(out["backfilled_at"] == 3,
                      f"{where}: the teacher was not backfilled at step 3")
            report[name] = {"launches": launches, "wall_s": wall,
                            "peak_gib": torch.cuda.max_memory_allocated(dev)
                            / 2**30, "last": last}
            print(f"{where}: {n} forwards, launches {launches}, F1 "
                  f"{last['f1']:.3f}" + ("" if name == "trunk" else
                                         f" re-est. {last['f1_reest']:.3f}"
                                         f" teacher {last['f1_ema']:.3f}, "
                                         f"eval {last['eval_s']:.1f} s")
                  + f", wall {wall:.1f} s, peak "
                  f"{report[name]['peak_gib']:.2f} GiB [{card}]")
            del run
        report["state_mib"] = size
    print(f"[student_fall] the saved state ({size:.1f} MiB) reloads bitwise")
    return report


# -- phase 23: 3DETR-m's radius-masked attention ------------------------------

# the kernel against its plain version, over the plain version's largest
# |value| (tests/test_torch_port_three_detr.py's bound): the kernel sums each
# logit's 64 products one FMA at a time and takes the softmax online, the
# plain version sums in the GEMM's order and normalises once
RADIUS_REL = 2e-5
# FPS picks and ball-query indices of the kernel-path forward against the
# plain path's: bitwise (they depend on xyz only)
THREE_DETR_INDEX_KEYS = ("pre_enc_inds", "interim_inds", "interim_ball_inds",
                         "enc_inds", "query_inds")


def record_radius_calls(ops, records):
    """Route the model's ops.radius_attention through a recorder that keeps
    each call's inputs and calls the real op (whose counter still counts);
    returns a function that puts the real op back."""
    real = ops.radius_attention

    def recorder(q, k, v, xyz, radius):
        records.append((q, k, v, xyz, radius))
        return real(q, k, v, xyz, radius)

    ops.radius_attention = recorder

    def restore():
        ops.radius_attention = real
    return restore


def pairwise_outputs(fn, tokens) -> list:
    """The shapes of the op outputs, while `fn` ran, that end in (N, N) for
    a token count N in `tokens`: the logits, softmax or mask of a dense
    attention over the tokens."""
    from torch.utils._python_dispatch import TorchDispatchMode
    seen = []

    class Pairwise(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else [out]):
                shape = tuple(getattr(t, "shape", ()))
                if len(shape) >= 2 and shape[-1] == shape[-2] in tokens:
                    seen.append(shape)
            return out

    with Pairwise():
        fn()
    return seen


def radius_attention_phase(dev, pc, card):
    """Phase 23: 3DETR-m's eval forward (ThreeDETRConfig(fused_sa=True), the
    benchmark cell's configuration) on phase 3's clouds, and the
    radius-attention kernel against its plain version on that forward's
    own three calls."""
    import torch
    from omni_pq_torch import ops
    from omni_pq_torch.config import ThreeDETRConfig
    from omni_pq_torch.infer import build_model, eval_forward
    from omni_pq_torch.ops.radius_attention import keep_mask
    from omni_pq_torch.ops.reference import radius_sq
    cfg = ThreeDETRConfig(fused_sa=True)
    model = build_model(cfg, dev, seed=SEED)
    eval_forward(model, pc)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    counted = {"fps": ops.fps, "ball_query_group": ops.ball_query_group,
               "fused_mlp_pool": ops.fused_mlp_pool,
               "radius_attention": ops.radius_attention}
    reset_launch_counts(counted)
    ep = eval_forward(model, pc)
    torch.cuda.synchronize()
    launches = fused_launch_counts(counted)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[3detr] launches in one forward: {launches}")
    want = {"fps": 3, "ball_query_group": 2, "fused_mlp_pool": 1,
            "radius_attention": cfg.enc_nlayers}
    check(launches == want, f"3DETR-m forward: launches {launches}, "
          f"expected {want}")
    for k, v in ep.items():
        check(not v.dtype.is_floating_point or bool(torch.isfinite(v).all()),
              f"3DETR-m {k} has non-finite values")
    # no op returns a (.., N, N) tensor over the encoder's tokens: no
    # logits, softmax or mask of a dense attention
    tokens = (cfg.preenc_npoints, cfg.preenc_npoints // 2)
    pairwise = pairwise_outputs(lambda: eval_forward(model, pc), tokens)
    print(f"[3detr] op outputs ending in (N, N) for N in {tokens}: "
          f"{pairwise or 'none'}")
    check(not pairwise, f"3DETR-m forward: ops returned pairwise tensors "
          f"{pairwise[:4]}")
    with ops.plain_versions():
        ep_plain = eval_forward(model, pc)
    torch.cuda.synchronize()
    for k in THREE_DETR_INDEX_KEYS:
        check(torch.equal(ep[k], ep_plain[k]),
              f"3DETR-m {k}: the kernel path's indices differ from the "
              "plain path's")
    gaps = {k: float((ep[k] - ep_plain[k]).abs().max())
            / max(float(ep_plain[k].abs().max()), 1e-30)
            for k in ep if ep[k].dtype.is_floating_point}
    worst = max(gaps.items(), key=lambda kv: kv[1])
    print(f"[3detr] indices bitwise the plain path's; largest float gap "
          f"over the key's largest value {worst[1]:.3e} ({worst[0]}; "
          f"enc_features {gaps['enc_features']:.3e})")

    records = []
    restore = record_radius_calls(ops, records)
    try:
        eval_forward(model, pc)
    finally:
        restore()
    torch.cuda.synchronize()
    check(len(records) == cfg.enc_nlayers, f"recorded {len(records)} "
          f"radius_attention calls, expected {cfg.enc_nlayers}")
    rows = []
    for layer, args in enumerate(records):
        q, k, v, xyz, radius = args
        B, H, N, hd = q.shape
        got = ops.radius_attention(*args)
        plain = ops.radius_attention_plain(*args)
        err = float((got - plain).abs().max())
        rel = err / float(plain.abs().max())
        check(rel < RADIUS_REL, f"radius_attention layer {layer}: "
              f"{rel:.3e} of the largest value from its plain version "
              f"(bound {RADIUS_REL})")
        kept = float(keep_mask(xyz, radius_sq(radius)).float().mean())
        # the bytes floor: q, k, v and xyz read once, the output written once
        bnd, by = bound_ms(4 * B * N * (3 * H * hd + 3 + H * hd), 0)
        rows.append({
            "call": f"encoder{layer}",
            "shape": f"B{B} H{H} N{N} hd{hd} r{radius}",
            "max_abs_err": err, "rel_err": rel, "kept_share": kept,
            "ms": time_ms(lambda: ops.radius_attention(*args), reps=10),
            "device_ms": device_ms(lambda: ops.radius_attention(*args),
                                   KERNEL_NAMES["radius_attention"]),
            "plain_ms": time_ms(lambda: ops.radius_attention_plain(*args),
                                reps=2),
            "bound_ms": bnd, "bound_by": by})
    del records
    for row in rows:
        check(row["device_ms"] is not None, f"radius_attention "
              f"{row['call']}: the profiler recorded none of its kernels: "
              "device time not measured")
        print(f"[time] radius_attention {row['call']:9s} {row['shape']:28s}"
              f" kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f})"
              f"  plain {row['plain_ms']:.3f} ms  bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})  rel err "
              f"{row['rel_err']:.2e}  kept pairs {row['kept_share']:.4%}  "
              f"[{card}]")
    fwd_ms = wall_ms_per_call(lambda: eval_forward(model, pc), reps=5)
    print(f"[3detr] forward B={pc.shape[0]}: {fwd_ms:.3f} ms/batch = "
          f"{pc.shape[0] / fwd_ms * 1e3:.2f} scenes/s, peak memory "
          f"{peak / 2**30:.2f} GiB [{card}]")
    del model, ep, ep_plain
    torch.cuda.empty_cache()
    return dict(launches=launches, pairwise_outputs=len(pairwise),
                float_gaps=gaps, forward_ms=fwd_ms,
                peak_mem_bytes=peak), rows


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

    # -- 18. data parallelism on the one card: a world-1 NCCL group, 2 gloo
    # ranks against one process, the train CLI with --multihost
    report["dp_world1"] = dp_world1_phase(cfg, dev, card, report)
    report["dp_ranks"] = dp_ranks_phase(cfg, dev, card)
    report["dp_cli"] = dp_cli_phase(card)

    # -- 19. the module surface off the PQTransformer's path: SAModuleMSG
    # (the idx-only ball query), LFPModuleMSG, GroupAll, PointsObjCls,
    # general_sampling, self-type attention, remat_sa, the legacy losses
    report["surface"], rows["ball_query_msg"] = surface_phase(
        cfg, pc, batch, ep, f1["pred_corners"], card)

    # -- 20. the float64 route: FPS and the idx-only ball query on float32
    # copies, the grouping and everything else in float64
    report["float64"] = float64_phase(cfg, dev, pc, batch, model, ep, rows,
                                      report, card)

    # -- 21. the experiment drivers: convergence, fitted vs fixed gamma
    # criterion, the Protocol-B A/B, a few steps each at full width
    report["experiments"] = experiments_phase(dev, card)

    # -- 22. the student-fall diagnosis script: a trunk, its saved state
    # reloaded, two branches from it, a few steps each at full width
    report["student_fall"] = student_fall_phase(dev, card)

    # -- 23. 3DETR-m's eval forward and its radius-attention kernel
    report["three_detr"], rows["radius_attention"] = radius_attention_phase(
        dev, pc, card)
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
    # the float64 route's forward (phase 20a) launches FPS and the idx-only
    # ball query on float32 copies of its coordinates
    summary[0]["float64_launches"] = report["float64"]["launches"]["fps"]
    # phase 21: each experiment driver's launches in its run
    for entry in summary[:2]:
        entry["experiments_launches"] = {
            name: r["launches"][entry["name"]]
            for name, r in report["experiments"].items()}
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
    # the idx-only entry: its main path is phase 19a's SAModuleMSG (two
    # launches a call, B=16); times and bounds are those two launches'
    mrows = rows["ball_query_msg"]
    summary.append({
        "name": "ball_query", "route": "cuda",
        "source": "omni_pq_torch/csrc/ball_query.cu",
        "replaces": "omni_pq_tpu/ops/ball_query.py:421",
        "launches": report["surface"]["msg"]["launches"]["ball_query"],
        "float64_launches": report["float64"]["launches"]["ball_query"],
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
    # 3DETR-m's masked encoder (phase 23): one launch an encoder layer;
    # times and bounds are that forward's three calls. The JAX package has
    # no 3DETR, so the kernel replaces no TPU kernel
    mrows = rows["radius_attention"]
    summary.append({
        "name": "radius_attention", "route": "cuda",
        "source": "omni_pq_torch/csrc/radius_attention.cu",
        "replaces": None,
        "launches": report["three_detr"]["launches"]["radius_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in mrows),
        "ms": sum(r["ms"] for r in mrows),
        "device_ms": sum(r["device_ms"] for r in mrows),
        "plain_ms": sum(r["plain_ms"] for r in mrows),
        "bound_ms": sum(r["bound_ms"] for r in mrows),
        "bound_by": max(mrows, key=lambda r: r["bound_ms"])["bound_by"],
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
    if "--dp-rank" in sys.argv:
        sys.exit(dp_rank_main(sys.argv[1:]))
    sys.exit(main())
