"""Semi-supervised A/B on held-out rooms: does the paper's machinery move
held-out F1? (The port of scripts/semi_sup_ab.py: `ARM_FLAGS` :104-131,
`run_arm` :229-328, `main` :331-369.)

Per seed s: 4 labeled rooms (`load_pool(100 + s, 4)`), 16 weak rooms
(`load_pool(200 + s, 16)`) and 8 held-out rooms shared by every seed and
arm (`load_pool(999, 8)`), 40k points each, 2.0-2.6 m. Every arm of a seed
starts from the same weights (`build_model(seed=s)`) and trains on 3
labeled (+ 3 weak) rooms a step, drawn on the device, at the full model;
AdamW at 2e-3 on a cosine over AB_STEPS, EMA decay 0.999, lambda_metric_*
5e-4. The arms:

- sup: the supervised losses on the labeled rooms only;
- ema: + the EMA mean teacher's consistency over labeled + weak;
- gamma: + gamma-mixture pseudo-labels, fitted criterion;
- gamma_fixed: the same with the fixed criterion (fit.py:152-174);
- arkit: + the ARKit pc loss at 1e-3 on weak rooms whose quad ground
  truth is zeroed (ARKit's train split has object boxes only);
- arkit_centered: arkit on pools that `center_pool` centres, all of them
  (arkitscenes_dataset.py:109-118: the loss's (0, 0, 1) pseudo centre
  assumes rooms around the origin).

From scratch the consistency weight ramps up (a sigmoid over the first
third of the run). An arm named `<arm>_ft` runs the reference's fine-tune
protocol (train.sh:14-31): AB_PRETRAIN supervised steps, then the teacher
:= the student (parameters and BN buffers, train.py:167-173), then the
arm's step at consistency weight 0.05. Held-out F1 is evaluated every
AB_EVAL_EVERY steps (and after step 1), for the student and, in a semi
phase, the teacher; an arm's score is its best F1 over the trajectory.

Knobs, environment variables as in the JAX driver: AB_STEPS (6000),
AB_EVAL_EVERY (500), AB_SEEDS ("0,1,2"), AB_ARMS ("sup,ema,gamma"),
AB_PRETRAIN (AB_STEPS // 2), AB_OUT (by protocol:
docs/semi_sup_ab_torch.json for scratch arms, docs/semi_sup_ab_ft_torch.json
for `_ft` arms; required when AB_ARMS mixes the two). Runs already in AB_OUT
are skipped (resume).

    AB_ARMS=sup_ft,gamma_ft AB_SEEDS=0 AB_STEPS=8000 AB_PRETRAIN=4000 \\
        python -m omni_pq_torch.experiments.semi_sup_ab [--device cuda]

After each arm the results file is written and
`experiments.semi_sup_report` renders docs/SEMI_SUP_torch.md (--doc chooses
another path); each run's result is printed as one `SEMI_SUP_AB_JSON {...}`
line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from ..config import SCANNET_MEAN_SIZES, SMOKE_MODEL, ModelConfig
from ..infer import build_model, resolve_device
from ..train import (OptimizerConfig, TrainFlags, TrainState, batch_to_tensors,
                     make_eval_step, make_train_step)
from ..train.schedule import consistency_weight
from . import semi_sup_report
from .common import (ROOM, backfill_teacher, card_name, center_pool,
                     held_out_f1, load_pool, make_pool_step, peak_gib,
                     print_result, sync, write_json, zero_quad_gt)

N_LABELED, N_WEAK, N_VAL = 4, 16, 8
BS = 3  # labeled batch (train.sh batch_size); the weak batch equals it
CONSISTENCY = 0.05
LOSS_EVERY = 50
SCRATCH_OUT = "docs/semi_sup_ab_torch.json"
FT_OUT = "docs/semi_sup_ab_ft_torch.json"

ARM_FLAGS = {
    "sup": TrainFlags(ema=False, gamma_mixture=False, arkit=False,
                      pc_loss=True),
    "ema": TrainFlags(ema=True, gamma_mixture=False, arkit=False,
                      pc_loss=True),
    "gamma": TrainFlags(ema=True, gamma_mixture=True, arkit=False,
                        pc_loss=True, use_fitted_mixture=True),
    "gamma_fixed": TrainFlags(ema=True, gamma_mixture=True, arkit=False,
                              pc_loss=True, use_fitted_mixture=False),
    "arkit": TrainFlags(ema=True, gamma_mixture=True, arkit=True,
                        pc_loss=True, use_fitted_mixture=True,
                        lambda_arkit_pc_loss=1e-3),
    # the same flags; the arm differs in its data (centred pools)
    "arkit_centered": TrainFlags(ema=True, gamma_mixture=True, arkit=True,
                                 pc_loss=True, use_fitted_mixture=True,
                                 lambda_arkit_pc_loss=1e-3),
}
# the generator's seed: 1009 * seed + this + (7000 for `_ft`), as the JAX
# driver's PRNG key
ARM_KEY = {"sup": 1, "ema": 2, "gamma": 3, "gamma_fixed": 4, "arkit": 5,
           "arkit_centered": 6}


@dataclasses.dataclass(frozen=True)
class Settings:
    steps: int
    eval_every: int
    seeds: List[int]
    arms: List[str]
    pretrain: int
    out: str

    @classmethod
    def from_env(cls) -> "Settings":
        steps = int(os.environ.get("AB_STEPS", 6000))
        arms = os.environ.get("AB_ARMS", "sup,ema,gamma").split(",")
        out = os.environ.get("AB_OUT")
        if out is None:
            ft = [a for a in arms if a.endswith("_ft")]
            if ft and len(ft) != len(arms):
                raise SystemExit("AB_ARMS mixes scratch and _ft protocols; "
                                 "set AB_OUT explicitly")
            out = FT_OUT if ft else SCRATCH_OUT
        return cls(steps=steps,
                   eval_every=int(os.environ.get("AB_EVAL_EVERY", 500)),
                   seeds=[int(s) for s in
                          os.environ.get("AB_SEEDS", "0,1,2").split(",")],
                   arms=arms,
                   pretrain=int(os.environ.get("AB_PRETRAIN", steps // 2)),
                   out=out)


def split_arm(arm: str):
    """(base arm, fine-tune protocol?)."""
    return (arm[:-3], True) if arm.endswith("_ft") else (arm, False)


def cw_schedule(base: str, finetune: bool, steps: int, pretrain: int
                ) -> np.ndarray:
    """The consistency weight of each step (float32): 0 for the pretrain
    and 0.05 after it under the fine-tune protocol (the resume epoch is
    long past the rampup); from scratch the sigmoid rampup over the first
    third, for arms with the teacher."""
    if finetune:
        return np.asarray([0.0] * pretrain
                          + [CONSISTENCY] * (steps - pretrain), np.float32)
    ramp = max(1, steps // 3)
    return np.asarray([consistency_weight(i / ramp, CONSISTENCY, 1)
                       if ARM_FLAGS[base].ema else 0.0
                       for i in range(steps)], np.float32)


def arm_pools(base: str, labeled: Dict, weak: Dict, val: Dict):
    """The arm's numpy pools: all centred for arkit_centered, the weak
    pool's quad ground truth zeroed for both ARKit arms."""
    if base == "arkit_centered":
        labeled, weak, val = (center_pool(labeled), center_pool(weak),
                              center_pool(val))
    if base in ("arkit", "arkit_centered"):
        weak = zero_quad_gt(weak)
    return labeled, weak, val


def run_arm(arm: str, seed: int, labeled_np: Dict, weak_np: Dict,
            val_np: Dict, s: Settings, cfg: ModelConfig,
            device: torch.device) -> Dict:
    base, finetune = split_arm(arm)
    labeled_np, weak_np, val_np = arm_pools(base, labeled_np, weak_np,
                                            val_np)
    labeled = batch_to_tensors(labeled_np, device)
    weak = batch_to_tensors(weak_np, device)
    val_pc = torch.from_numpy(val_np["point_clouds"]).to(device)
    model = build_model(cfg, device, seed=seed)
    state = TrainState(model, OptimizerConfig(total_steps=s.steps,
                                              learning_rate=2e-3), ema=True)
    flags = ARM_FLAGS[base]
    step = make_pool_step(
        make_train_step(model, cfg, SCANNET_MEAN_SIZES, flags), BS,
        semi=flags.ema or flags.gamma_mixture)
    sup_step = (make_pool_step(make_train_step(
        model, cfg, SCANNET_MEAN_SIZES, ARM_FLAGS["sup"]), BS, semi=False)
        if finetune else None)
    ev = make_eval_step()
    cw = [float(w) for w in cw_schedule(base, finetune, s.steps, s.pretrain)]
    gen = torch.Generator(device=device).manual_seed(
        1009 * seed + ARM_KEY[base] + (7000 if finetune else 0))
    curve = []
    t0 = time.time()
    t_mark, step_mark = None, 0
    backfilled = False
    for i in range(s.steps):
        if finetune and i == s.pretrain:
            backfill_teacher(state)
            backfilled = True
            phase = ("semi-supervised phase begins"
                     if (flags.ema or flags.gamma_mixture or flags.arkit)
                     else "supervised fine-tune phase continues (baseline)")
            print(f"  [{arm} s{seed}] step {i}: teacher backfilled, {phase}",
                  flush=True)
        use = sup_step if (finetune and i < s.pretrain) else step
        stats = use(state, labeled, weak, cw[i], gen)
        evaluating = (i + 1) % s.eval_every == 0 or i == 0
        if (i + 1) % LOSS_EVERY == 0 or evaluating:
            loss = float(stats["total_loss"])  # the host waits here
        if not evaluating:
            continue
        now = time.time()
        ms = (None if t_mark is None
              else (now - t_mark) / (i + 1 - step_mark) * 1e3)
        rec = {"step": i + 1, "f1": held_out_f1(ev, state, val_pc, val_np),
               "loss": loss, "ms_per_step": ms}
        # the omni-supervised term and the criterion, where the step has
        # them (not in a fine-tune arm's supervised phase)
        if flags.arkit and "arkit_pc_loss" in stats:
            rec["arkit_pc_loss"] = float(stats["arkit_pc_loss"])
            rec["arkit_collisions"] = float(stats["arkit_collisions"])
        if flags.gamma_mixture and "gamma_engaged_frac" in stats:
            rec["gamma_engaged_frac"] = float(stats["gamma_engaged_frac"])
        in_semi = flags.ema and not (finetune and i < s.pretrain)
        if in_semi:
            rec["f1_ema"] = held_out_f1(ev, state, val_pc, val_np,
                                        use_ema=True)
        sync(device)
        rec["eval_s"] = time.time() - now
        rec["peak_gib"] = peak_gib(device)
        curve.append(rec)
        peak = ("" if rec["peak_gib"] is None
                else f", peak {rec['peak_gib']:.2f} GiB")
        print(f"  [{arm} s{seed}] step {i + 1}: heldout F1 {rec['f1']:.3f}"
              + (f" ema {rec['f1_ema']:.3f}" if in_semi else "")
              + f" loss {loss:.3f} ({time.time() - t0:.0f}s, eval "
              f"{rec['eval_s']:.1f}s"
              + ("" if ms is None else f", {ms:.1f} ms/step") + peak + ")",
              flush=True)
        t_mark, step_mark = time.time(), i + 1
    best = max(max(r["f1"], r.get("f1_ema", 0.0)) for r in curve)
    return {"arm": arm, "seed": seed, "best_f1": best,
            "final_f1": curve[-1]["f1"],
            "final_f1_ema": curve[-1].get("f1_ema"), "curve": curve,
            "backfilled": backfilled, "wall_s": round(time.time() - t0, 1)}


def results_doc(s: Settings, runs: List[Dict], card: str) -> Dict:
    return {"steps": s.steps, "pretrain": s.pretrain, "device": card,
            "setup": {"labeled": N_LABELED, "weak": N_WEAK, "val": N_VAL,
                      "room": {k: list(v) if isinstance(v, tuple) else v
                               for k, v in ROOM.items()}},
            "runs": runs}


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--doc", default=semi_sup_report.DST,
                    help="the report rendered after each arm")
    ap.add_argument("--smoke", action="store_true",
                    help="the CLIs' --smoke model (CPU tests)")
    ap.add_argument("--num_points", type=int, default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    s = Settings.from_env()
    device = resolve_device(args.device)
    cfg = ModelConfig(**(SMOKE_MODEL if args.smoke else {}))
    if args.num_points:
        cfg = dataclasses.replace(cfg, num_points=args.num_points)
    card = card_name(device)
    print(f"[semi_sup_ab] {card}; torch {torch.__version__}; arms {s.arms}"
          f", seeds {s.seeds}, steps {s.steps}, pretrain {s.pretrain}, "
          f"out {s.out}", flush=True)
    val_np = load_pool(999, N_VAL, cfg.num_points)
    runs: List[Dict] = []
    if os.path.exists(s.out):  # resume
        with open(s.out) as f:
            runs = json.load(f)["runs"]
        print(f"resuming: {len(runs)} runs already done", flush=True)
    done = {(r["arm"], r["seed"]) for r in runs}
    ft_protocol = all(a.endswith("_ft") for a in s.arms)
    for seed in s.seeds:
        labeled_np = load_pool(100 + seed, N_LABELED, cfg.num_points)
        weak_np = load_pool(200 + seed, N_WEAK, cfg.num_points)
        for arm in s.arms:
            if (arm, seed) in done:
                continue
            print(f"=== arm {arm} seed {seed} ===", flush=True)
            r = run_arm(arm, seed, labeled_np, weak_np, val_np, s, cfg,
                        device)
            runs.append(r)
            write_json(s.out, results_doc(s, runs, card))
            print_result("SEMI_SUP_AB_JSON", r)
            semi_sup_report.render(
                scratch=SCRATCH_OUT if ft_protocol else s.out,
                ft=s.out if ft_protocol else FT_OUT, dst=args.doc)
    for arm in s.arms:
        vals = sorted(r["best_f1"] for r in runs if r["arm"] == arm)
        if vals:
            print(f"{arm}: best-F1 per seed {vals} median "
                  f"{float(np.median(vals)):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
