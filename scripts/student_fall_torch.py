#!/usr/bin/env python3
"""Paired branches of one Protocol-B run from one saved state: where does
the fine-tune student's late fall below its EMA teacher come from?

A trunk runs one arm and seed of `omni_pq_torch.experiments.semi_sup_ab`
(default `gamma_ft`, seed 0) exactly as its `run_arm` does, up to a branch
step, and saves the whole state there: the student, the teacher and every
BatchNorm buffer, the AdamW moments and counts, the step count and the
`torch.Generator`. Each branch resumes from that state in a process of its
own and runs to the end of the run, changing one thing:

- B0a, B0b: nothing (their spread is the noise of steps that are not
  bitwise repeatable on the card);
- B1: the gamma-mixture pseudo-label loss off (every lambda_metric_* 0;
  the criterion still runs and draws, so the generator stays paired);
- B2: TF32 float32 products (`torch.backends.cuda.matmul.allow_tf32` and
  `torch.backends.cudnn.allow_tf32`, this process only).

At every eval each run records the student's held-out F1 with its running
BatchNorm statistics, the student's F1 with its statistics re-estimated (a
copy of the student, running statistics reset, K no-grad train-mode
forwards of the batches the step draws, their batch statistics averaged;
the live state is not touched), the teacher's F1, the relative distance of
student and teacher (parameters, BatchNorm buffers), the step's loss
families (and their means since the last eval), the mean fitted gamma
mixture (a1, b1, w), grad_norm, ms/step and peak memory. Each record is
printed as one `STUDENT_FALL_RECORD {...}` line and each run as one
`STUDENT_FALL_JSON {...}` line; `--json` files are rewritten after every
eval.

    # trunk to 5500, then B0a and B1 as two processes sharing the card
    # (the saved state in build/student_fall/, removed at the end)
    python scripts/student_fall_torch.py run --out log/fall \\
        --branches B0a,B1 [--limit SECONDS]
    # the parts alone
    python scripts/student_fall_torch.py trunk --state S.pth --json T.json
    python scripts/student_fall_torch.py branch --name B1 --state S.pth
    # the write-up from the runs' JSON files (or logs of stopped runs)
    python scripts/student_fall_torch.py report --doc D.md --save D.json \\
        call1/*.json call2/*.json

On the CPU: `--device cpu --smoke --num_points 2048` and a few steps
(`--steps 6 --pretrain 2 --branch_at 3 --eval_every 3`). The saved state
(274 MiB at full width) stays where `--state` says: on the machine that
runs the trunk and its branches.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import glob
import json
import os
import subprocess
import sys
import time
import types
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from omni_pq_torch import parallel  # noqa: E402
from omni_pq_torch.config import (SCANNET_MEAN_SIZES, SMOKE_MODEL,  # noqa: E402
                                  ModelConfig)
from omni_pq_torch.experiments import semi_sup_ab as ab  # noqa: E402
from omni_pq_torch.experiments.common import (  # noqa: E402
    backfill_teacher, card_name, draw, held_out_f1, load_pool,
    make_pool_step, peak_gib, sync, write_json, write_text)
from omni_pq_torch.infer import build_model, resolve_device  # noqa: E402
from omni_pq_torch.losses import gamma  # noqa: E402
from omni_pq_torch.models import pointnet2  # noqa: E402
from omni_pq_torch.train import (OptimizerConfig, TrainState,  # noqa: E402
                                 batch_to_tensors, make_eval_step,
                                 make_train_step)
from omni_pq_torch.train.checkpoint import (  # noqa: E402
    load_optimizer_state, optimizer_state)

BRANCHES = {
    "B0a": {},
    "B0b": {},
    "B1": {"flags": {f"lambda_metric_{k}": 0.0
                     for k in ("normal", "vertical", "size", "score")}},
    "B2": {"tf32": True},
}
# the step's stats recorded at an eval, and averaged over the steps since
# the last one, where the step has them
LOSS_KEYS = ("total_loss", "loss", "weighted_consistency_loss",
             "gamma_mixture_filter_loss", "gamma_engaged_frac",
             "arkit_pc_loss", "grad_norm")
REESTIMATE_K = 20
# Protocol B's fine-tune runs: JAX's A/B (TPU v5e runs) and the port's
AB_RESULTS = (("JAX (`docs/semi_sup_ab_ft.json`)",
               os.path.join(ROOT, "docs", "semi_sup_ab_ft.json")),
              ("port (`docs/semi_sup_ab_ft_torch.json`)",
               os.path.join(ROOT, "docs", "semi_sup_ab_ft_torch.json")))
# what a semi-phase eval of gamma_ft records (an arm without the fitted
# criterion has no fit_*, one without the ARKit loss no arkit_pc_loss)
SEMI_RECORD_KEYS = (
    "step", "f1", "f1_reest", "f1_ema", "gap", "gap_reest", "param_gap",
    "bn_gap", "bn_reest_gap", "fit_a1", "fit_b1", "fit_w", "ms_per_step",
    "peak_gib", "eval_s", *(k + s for k in LOSS_KEYS if k != "arkit_pc_loss"
                            for s in ("", "_mean")))
# the settings a saved state must share with the branch that loads it
STATE_KEYS = ("arm", "seed", "steps", "pretrain", "smoke", "num_points")


@contextlib.contextmanager
def recorded_fit(sink: Dict):
    """`losses.gamma.gamma_mixture_em` (which the fitted criterion's keep
    mask calls) also leaving the batch means of its fitted (a1, b1, w) in
    sink["fit"] (over the scenes whose fit is not NaN), on the device; its
    results unchanged."""
    em = gamma.gamma_mixture_em

    def recording(*args, **kwargs):
        out = em(*args, **kwargs)
        a1, b1, _, _, w = out
        sink["fit"] = torch.stack([a1.nanmean(), b1.nanmean(),
                                   w.nanmean()]).detach()
        return out
    gamma.gamma_mixture_em = recording
    try:
        yield sink
    finally:
        gamma.gamma_mixture_em = em


@contextlib.contextmanager
def cumulative_bn_stats():
    """Within the block every BatchNorm running-statistic update
    (`models.pointnet2.update_running_stats`) keeps the cumulative average
    of the batch statistics it has seen instead of the momentum average:
    after n updates, mean_n = mean_{n-1} + (batch - mean_{n-1}) / n. Yields
    the count of updates by module."""
    counts: Dict[nn.Module, int] = {}
    momentum_update = pointnet2.update_running_stats

    def cumulative(bn, mean, var):
        n = counts[bn] = counts.get(bn, 0) + 1
        with torch.no_grad():
            for name, batch in (("running_mean", mean), ("running_var", var)):
                old = getattr(bn, name)
                old.copy_(old + (batch.to(old.dtype) - old) / n)
    pointnet2.update_running_stats = cumulative
    try:
        yield counts
    finally:
        pointnet2.update_running_stats = momentum_update


def batchnorms(model: nn.Module) -> List[nn.BatchNorm1d]:
    return [m for m in model.modules() if isinstance(m, nn.BatchNorm1d)]


def reestimate_bn(model: nn.Module,
                  batches: Iterable[Tuple[torch.Tensor, Sequence[int]]],
                  generator: Optional[torch.Generator]) -> nn.Module:
    """A copy of `model` whose BatchNorm running statistics are the average
    of the batch statistics of its train-mode forwards, without gradients,
    on `batches` ((clouds, segments) pairs: the segments as the step
    declares them, `parallel.batch_segments`); dropout draws from
    `generator`. `model` is left as it was."""
    student = copy.deepcopy(model)
    bns = batchnorms(student)
    for bn in bns:
        bn.running_mean.zero_()
        bn.running_var.zero_()
    student.train()
    n = 0
    with torch.no_grad(), cumulative_bn_stats() as counts:
        for clouds, segments in batches:
            with parallel.batch_segments(*segments):
                student(clouds, generator=generator)
            n += 1
    missed = [bn for bn in bns if counts.get(bn) != n]
    if missed:
        raise RuntimeError(f"{len(missed)} of {len(bns)} BatchNorms took "
                           f"another number of updates than the {n} forwards")
    return student.eval()


def rel_gap(a: Iterable[torch.Tensor], b: Iterable[torch.Tensor]) -> float:
    """|a - b| / |b| over every element of the paired tensors (float64)."""
    num = den = 0.0
    for x, y in zip(a, b):
        x, y = x.detach().double(), y.detach().double()
        num += float(((x - y) ** 2).sum())
        den += float((y ** 2).sum())
    return (num / den) ** 0.5 if den > 0 else float("nan")


def bn_buffers(model: nn.Module) -> List[torch.Tensor]:
    return [t for bn in batchnorms(model)
            for t in (bn.running_mean, bn.running_var)]


@dataclasses.dataclass
class Run:
    """One Protocol-B run as `semi_sup_ab.run_arm` sets it up."""
    name: str
    args: argparse.Namespace
    device: torch.device
    base: str
    finetune: bool
    flags: object
    state: TrainState
    step: object
    sup_step: object
    eval_step: object
    cw: List[float]
    gen: torch.Generator
    labeled: Dict[str, torch.Tensor]
    weak: Dict[str, torch.Tensor]
    val_pc: torch.Tensor
    val_np: Dict[str, np.ndarray]

    def in_semi(self, i: int) -> bool:
        return self.flags.ema and not (self.finetune
                                       and i < self.args.pretrain)


def model_config(args) -> ModelConfig:
    cfg = ModelConfig(**(SMOKE_MODEL if args.smoke else {}))
    if args.num_points:
        cfg = dataclasses.replace(cfg, num_points=args.num_points)
    return cfg


def setup(args, name: str = "trunk") -> Run:
    """run_arm's pools, model, state, steps, consistency weights and
    generator for args.arm and args.seed, with branch `name`'s flags."""
    device = resolve_device(args.device)
    cfg = model_config(args)
    base, finetune = ab.split_arm(args.arm)
    labeled_np, weak_np, val_np = ab.arm_pools(
        base, load_pool(100 + args.seed, ab.N_LABELED, cfg.num_points),
        load_pool(200 + args.seed, ab.N_WEAK, cfg.num_points),
        load_pool(999, ab.N_VAL, cfg.num_points))
    labeled = batch_to_tensors(labeled_np, device)
    weak = batch_to_tensors(weak_np, device)
    val_pc = torch.from_numpy(val_np["point_clouds"]).to(device)
    model = build_model(cfg, device, seed=args.seed)
    state = TrainState(model, OptimizerConfig(total_steps=args.steps,
                                              learning_rate=2e-3), ema=True)
    flags = dataclasses.replace(ab.ARM_FLAGS[base],
                                **BRANCHES.get(name, {}).get("flags", {}))
    step = make_pool_step(
        make_train_step(model, cfg, SCANNET_MEAN_SIZES, flags), ab.BS,
        semi=flags.ema or flags.gamma_mixture)
    sup_step = (make_pool_step(make_train_step(
        model, cfg, SCANNET_MEAN_SIZES, ab.ARM_FLAGS["sup"]), ab.BS,
        semi=False) if finetune else None)
    cw = [float(w) for w in ab.cw_schedule(base, finetune, args.steps,
                                           args.pretrain)]
    gen = torch.Generator(device=device).manual_seed(
        1009 * args.seed + ab.ARM_KEY[base] + (7000 if finetune else 0))
    return Run(name, args, device, base, finetune, flags, state, step,
               sup_step, make_eval_step(), cw, gen, labeled, weak, val_pc,
               val_np)


def settings(args) -> Dict:
    return {k: getattr(args, k) for k in STATE_KEYS}


def save_state(path: str, run: Run, next_step: int) -> None:
    """The run's whole state before step `next_step` (0-based) in one file:
    student and teacher (parameters and BatchNorm buffers), the AdamW
    moments and counts, the TrainState's step, the generator."""
    st = run.state
    payload = {"model": st.model.state_dict(),
               "ema_model": st.ema_model.state_dict(),
               "optimizer": optimizer_state(st), "step": st.step,
               "generator": run.gen.get_state(), "next_step": next_step,
               "settings": settings(run.args)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)


def load_state(path: str, run: Run) -> int:
    """Restore `save_state`'s file into `run`; returns the next step."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if payload["settings"] != settings(run.args):
        raise ValueError(f"{path} was saved by a run with settings "
                         f"{payload['settings']}, not {settings(run.args)}")
    st = run.state
    st.model.load_state_dict(payload["model"])
    st.ema_model.load_state_dict(payload["ema_model"])
    load_optimizer_state(st, payload["optimizer"])
    st.step = int(payload["step"])
    run.gen.set_state(payload["generator"])
    return int(payload["next_step"])


def step_batches(run: Run, k: int, generator: torch.Generator):
    """k double batches (labeled, then weak) drawn from the pools as the
    semi-supervised step draws them."""
    for _ in range(k):
        labeled = draw(run.labeled, ab.BS, generator)
        weak = draw(run.weak, ab.BS, generator)
        yield (torch.cat([labeled["point_clouds"], weak["point_clouds"]]),
               (ab.BS, ab.BS))


def eval_record(run: Run, i: int, stats, window, fit, ms) -> Dict:
    """The records after step i (0-based)."""
    st = run.state
    rec = {"step": i + 1, "f1": held_out_f1(run.eval_step, st, run.val_pc,
                                            run.val_np)}
    rec.update({k: float(stats[k]) for k in LOSS_KEYS if k in stats})
    n = window.pop("_n", 0)
    rec.update({f"{k}_mean": float(v) / n for k, v in window.items()})
    window.clear()
    if fit is not None:
        rec.update(zip(("fit_a1", "fit_b1", "fit_w"), fit.tolist()))
    if run.in_semi(i):
        rec["f1_ema"] = held_out_f1(run.eval_step, st, run.val_pc,
                                    run.val_np, use_ema=True)
        gen = torch.Generator(device=run.device).manual_seed(
            1_000_003 * run.args.seed + i + 1)
        student = reestimate_bn(st.model,
                                step_batches(run, REESTIMATE_K, gen), gen)
        rec["f1_reest"] = held_out_f1(run.eval_step, types.SimpleNamespace(
            model=student, ema_model=None), run.val_pc, run.val_np)
        rec["bn_reest_gap"] = rel_gap(bn_buffers(student),
                                      bn_buffers(st.model))
        del student
        rec["gap"] = rec["f1"] - rec["f1_ema"]
        rec["gap_reest"] = rec["f1_reest"] - rec["f1_ema"]
        rec["param_gap"] = rel_gap(st.model.parameters(),
                                   st.ema_model.parameters())
        rec["bn_gap"] = rel_gap(bn_buffers(st.model),
                                bn_buffers(st.ema_model))
    rec["ms_per_step"] = ms
    rec["peak_gib"] = peak_gib(run.device)
    return rec


def train_span(run: Run, start: int, stop: int, out: Dict,
               deadline: Optional[float] = None) -> None:
    """Steps start..stop-1 (0-based) of run_arm's loop, the records in
    out["curve"]; a step that begins past `deadline` (time.time()) is not
    run, and out["stopped_at"] says where the run stopped."""
    st, args = run.state, run.args
    window: Dict = {}
    sink: Dict = {}
    t_mark, step_mark = time.time(), start
    with recorded_fit(sink):
        for i in range(start, stop):
            if deadline is not None and time.time() > deadline:
                out["stopped_at"] = i
                print(f"  [{run.name}] stopped before step {i + 1}: time "
                      "limit", flush=True)
                return
            if run.finetune and i == args.pretrain:
                backfill_teacher(st)
                out["backfilled_at"] = i
                print(f"  [{run.name}] step {i}: teacher backfilled",
                      flush=True)
            semi_step = not (run.finetune and i < args.pretrain)
            stats = (run.step if semi_step else run.sup_step)(
                st, run.labeled, run.weak, run.cw[i], run.gen)
            for k in LOSS_KEYS:
                if k in stats:
                    window[k] = window.get(k, 0.0) + stats[k].float()
            window["_n"] = window.get("_n", 0) + 1
            if (i + 1) % args.eval_every and i != 0:
                continue
            sync(run.device)
            ms = (time.time() - t_mark) / (i + 1 - step_mark) * 1e3
            t0 = time.time()
            rec = eval_record(run, i, stats, window,
                              sink.pop("fit", None) if semi_step else None,
                              ms)
            sync(run.device)
            rec["eval_s"] = time.time() - t0
            rec["run"] = run.name
            out["curve"].append(rec)
            print("STUDENT_FALL_RECORD " + json.dumps(rec), flush=True)
            if out.get("json"):
                write_json(out["json"], out)
            t_mark, step_mark = time.time(), i + 1
    out["stopped_at"] = None


def run_doc(run: Run, card: str) -> Dict:
    a = run.args
    return {"run": run.name, **settings(a), "branch_at": a.branch_at,
            "eval_every": a.eval_every, "reestimate_k": REESTIMATE_K,
            "device": card, "torch": torch.__version__,
            "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                     "cudnn": torch.backends.cudnn.allow_tf32},
            "changed": BRANCHES.get(run.name, {}), "curve": [],
            "json": a.json}


def finish(out: Dict, t0: float) -> Dict:
    out["wall_s"] = round(time.time() - t0, 1)
    if out.get("json"):
        write_json(out["json"], out)
    print("STUDENT_FALL_JSON " + json.dumps(out), flush=True)
    return out


def trunk(args) -> Tuple[Run, Dict]:
    """Steps 0..branch_at-1 of the run, then its state saved to
    args.state."""
    t0 = time.time()
    run = setup(args, "trunk")
    card = card_name(run.device)
    print(f"[student_fall] trunk {args.arm} s{args.seed} to step "
          f"{args.branch_at} on {card}", flush=True)
    out = run_doc(run, card)
    train_span(run, 0, args.branch_at, out, args.deadline)
    if out["stopped_at"] is None:
        save_state(args.state, run, args.branch_at)
        out["state"] = args.state
        print(f"  [trunk] state saved to {args.state} "
              f"({os.path.getsize(args.state) / 2**20:.1f} MiB)", flush=True)
    finish(out, t0)
    return run, out


@contextlib.contextmanager
def branch_backends(name: str):
    """The branch's TF32 settings, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    if BRANCHES[name].get("tf32"):
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def branch(args) -> Tuple[Run, Dict]:
    """Branch args.name from the state in args.state to args.steps."""
    t0 = time.time()
    with branch_backends(args.name):
        run = setup(args, args.name)
        start = load_state(args.state, run)
        card = card_name(run.device)
        print(f"[student_fall] branch {args.name} {args.arm} s{args.seed} "
              f"steps {start + 1}-{args.steps} on {card}", flush=True)
        out = run_doc(run, card)
        train_span(run, start, args.steps, out, args.deadline)
    return run, finish(out, t0)


def child(args, mode: str, extra: List[str]) -> List[str]:
    cmd = [sys.executable, os.path.abspath(__file__), mode,
           "--device", args.device, "--state", args.state]
    for k in STATE_KEYS + ("branch_at", "eval_every", "deadline"):
        v = getattr(args, k)
        if isinstance(v, bool):
            cmd += [f"--{k}"] if v else []
        elif v is not None:
            cmd += [f"--{k}", str(v)]
    return cmd + extra


def run_all(args) -> int:
    """The trunk, then each branch as a process of its own, all at once;
    logs and JSON files under args.out. The saved state goes to
    build/student_fall/ unless --state says where, and is removed at the
    end."""
    os.makedirs(args.out, exist_ok=True)
    args.state = args.state or os.path.join(ROOT, "build", "student_fall",
                                            "state.pth")
    if args.limit:
        args.deadline = time.time() + args.limit
    env = dict(os.environ, OMP_NUM_THREADS=os.environ.get(
        "OMP_NUM_THREADS", "2"))
    names = ["trunk"] + args.branches.split(",")
    procs = []
    for name in names:
        extra = ["--json", os.path.join(args.out, f"{name}.json")]
        cmd = (child(args, "trunk", extra) if name == "trunk"
               else child(args, "branch", extra + ["--name", name]))
        with open(os.path.join(args.out, f"{name}.log"), "w") as log:
            procs.append((name, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, env=env)))
        if name == "trunk":
            rc = procs[0][1].wait()
            print(f"[student_fall] trunk exit {rc}", flush=True)
            if rc or not os.path.exists(args.state):
                return 1
    rc = 0
    for name, p in procs[1:]:
        r = p.wait()
        print(f"[student_fall] {name} exit {r}", flush=True)
        rc |= r != 0
    os.remove(args.state)
    runs = [load_run(os.path.join(args.out, f"{n}.json")) for n in names]
    print("\n".join(curve_table([r for r in runs if r])), flush=True)
    return rc


# -- the write-up --------------------------------------------------------------

def load_run(path: str) -> Optional[Dict]:
    """A run's JSON file, or its log rebuilt from the printed lines (the
    JSON line where it got that far, else its records, marked stopped)."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        if path.endswith(".json"):
            return json.load(f)
        lines = f.read().splitlines()
    for ln in reversed(lines):
        if ln.startswith("STUDENT_FALL_JSON "):
            return json.loads(ln.split(" ", 1)[1])
    curve = [json.loads(ln.split(" ", 1)[1]) for ln in lines
             if ln.startswith("STUDENT_FALL_RECORD ")]
    if not curve:
        return None
    return {"run": curve[0]["run"], "curve": curve,
            "stopped_at": curve[-1]["step"], "rebuilt_from": path}


def fmt(v, digits=3) -> str:
    return "-" if v is None else f"{v:.{digits}f}"


def curve_table(runs: List[Dict]) -> List[str]:
    """Each semi-phase eval of each run: student F1 (running / re-estimated
    statistics), teacher F1, and the two gaps."""
    lines = ["| run | step | student | student, BN re-est. | teacher | gap "
             "| gap, re-est. | param gap | BN gap | cons. | gamma | engaged "
             "| fit b1 | grad norm | ms/step |", "|" + "---|" * 15]
    for r in runs:
        for c in r["curve"]:
            if "f1_ema" not in c:
                continue
            lines.append(
                f"| {r['run']} | {c['step']} | {fmt(c['f1'])} | "
                f"{fmt(c['f1_reest'])} | {fmt(c['f1_ema'])} | "
                f"{c['gap']:+.3f} | {c['gap_reest']:+.3f} | "
                f"{c['param_gap']:.4f} | {c['bn_gap']:.4f} | "
                f"{fmt(c.get('weighted_consistency_loss_mean'), 5)} | "
                f"{fmt(c.get('gamma_mixture_filter_loss_mean'), 6)} | "
                f"{fmt(c.get('gamma_engaged_frac_mean'), 2)} | "
                f"{fmt(c.get('fit_b1'), 1)} | "
                f"{fmt(c.get('grad_norm_mean'), 3)} | "
                f"{fmt(c.get('ms_per_step'), 0)} |")
    return lines


def final_gaps(runs: List[Dict]) -> Dict[str, Dict]:
    """Each run's last semi eval: step, gap, re-estimated gap."""
    out = {}
    for r in runs:
        semi = [c for c in r["curve"] if "f1_ema" in c]
        if semi:
            c = semi[-1]
            out[r["run"]] = {"step": c["step"], "gap": c["gap"],
                             "gap_reest": c["gap_reest"],
                             "stopped": r.get("stopped_at") is not None}
    return out


# each branch beside its paired control (same call, same trunk)
PAIRS = (("B1", "B0a"), ("B2", "B0b"))


def paired_table(runs: Dict[str, Dict]) -> List[str]:
    """At each eval of the branches: each one's gap (running statistics /
    re-estimated), each branch's gap less its control's, and B0a's less
    B0b's (the noise)."""
    gaps = {name: {c["step"]: (c["gap"], c["gap_reest"])
                   for c in r["curve"] if "f1_ema" in c}
            for name, r in runs.items() if name in BRANCHES}
    steps = sorted({s for g in gaps.values() for s in g})
    names = [n for n in BRANCHES if n in gaps]
    pairs = [p for p in PAIRS + (("B0a", "B0b"),)
             if p[0] in gaps and p[1] in gaps]
    head = ["step", *names, *(f"{a} - {b}" for a, b in pairs)]
    lines = ["| " + " | ".join(head) + " |", "|" + "---|" * len(head)]

    def cell(name, step):
        g = gaps[name].get(step)
        return "-" if g is None else f"{g[0]:+.3f} / {g[1]:+.3f}"

    for step in steps:
        deltas = []
        for a, b in pairs:
            ga, gb = gaps[a].get(step), gaps[b].get(step)
            deltas.append("-" if ga is None or gb is None else
                          f"{ga[0] - gb[0]:+.3f} / {ga[1] - gb[1]:+.3f}")
        row = [str(step), *(cell(n, step) for n in names), *deltas]
        lines.append("| " + " | ".join(row) + " |")
    return lines


def reading(calls: Dict[str, List[Dict]], branches: Dict[str, Dict]
            ) -> List[str]:
    """The numbers that decide each candidate: the re-estimated statistics
    against the running ones over every semi eval of every run, each
    branch's paired difference from its control, each branch's worst
    gap."""
    diffs, bn = [], []
    for runs in calls.values():
        for r in runs:
            for c in r["curve"]:
                if "f1_ema" in c:
                    diffs.append(c["gap_reest"] - c["gap"])
                    bn.append(c["bn_reest_gap"])
    if not diffs:
        return []
    d = np.asarray(diffs)
    lines = [f"- BN statistics re-estimated against running, over {d.size} "
             f"semi evals: F1 difference mean {d.mean():+.4f}, SD "
             f"{d.std():.4f}, range {d.min():+.3f} to {d.max():+.3f}; the "
             f"statistics {min(bn):.1%}-{max(bn):.1%} apart."]
    gaps = {n: {c["step"]: c["gap"] for c in r["curve"] if "f1_ema" in c}
            for n, r in branches.items()}
    for a, b in PAIRS + (("B0a", "B0b"),):
        if a in gaps and b in gaps:
            x = np.asarray([gaps[a][k] - gaps[b][k] for k in gaps[a]
                            if k in gaps[b]])
            lines.append(f"- {a} - {b} over {x.size} evals: mean "
                         f"{x.mean():+.4f}, RMS {np.sqrt((x * x).mean()):.4f},"
                         f" range {x.min():+.3f} to {x.max():+.3f}.")
    lines.append("- Worst gap of each branch: " + ", ".join(
        f"{n} {min(g.values()):+.3f}" for n, g in gaps.items() if g) + ".")
    return lines


def semi_summary(curve: List[Dict], loss_key: str) -> Optional[Dict]:
    """A run's semi phase: its last eval's step and single-step total
    loss, its worst and its last student-minus-teacher gap."""
    semi = [c for c in curve if "f1_ema" in c]
    if not semi:
        return None
    return {"step": semi[-1]["step"], "loss": semi[-1][loss_key],
            "min_gap": min(c["f1"] - c["f1_ema"] for c in semi),
            "final_gap": semi[-1]["f1"] - semi[-1]["f1_ema"]}


def regime_table(sources: Sequence[Tuple[str, str]],
                 runs: Dict[str, Dict]) -> List[str]:
    """Every fine-tune semi run of the Protocol-B result files (label,
    path) and the branches: the last eval's loss beside the worst and the
    last gap, by loss."""
    rows = []
    for label, path in sources:
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for r in json.load(f)["runs"]:
                row = semi_summary(r["curve"], "loss")
                if row:
                    rows.append((label, f"{r['arm']} s{r['seed']}", row))
    for name, r in runs.items():
        row = semi_summary(r["curve"], "total_loss")
        if row:
            arm = f"{r['arm']} s{r['seed']} " if "arm" in r else ""
            rows.append(("this script", arm + name, row))
    lines = ["| source | run | last eval | loss | worst gap | last gap |",
             "|---|---|---|---|---|---|"]
    for label, run, r in sorted(rows, key=lambda x: x[2]["loss"]):
        lines.append(f"| {label} | {run} | {r['step']} | {r['loss']:.3f} | "
                     f"{r['min_gap']:+.3f} | {r['final_gap']:+.3f} |")
    return lines


def report(args) -> int:
    """docs: every call's runs (grouped by the directory of their files),
    each eval's table, the final gaps and the B0 spread."""
    calls: Dict[str, List[Dict]] = {}
    for path in args.inputs:
        for p in sorted(glob.glob(path)) or [path]:
            r = load_run(p)
            if r is not None:
                calls.setdefault(os.path.dirname(p) or ".", []).append(r)
    lines = ["# The fine-tune student's late fall: paired branches "
             "(`scripts/student_fall_torch.py`)", "",
             "Generated by `python scripts/student_fall_torch.py report`. "
             "Gap = student minus teacher held-out F1; \"re-est.\" = the "
             "student with its BatchNorm statistics re-estimated "
             f"(K = {REESTIMATE_K} train-mode forwards). Param / BN gap = "
             "|student - teacher| / |teacher| over parameters / running "
             "statistics. cons., gamma, engaged, grad norm: means over the "
             "steps since the last eval; fit b1: the fitted near "
             "component's rate at the eval step.", ""]
    saved = {"calls": {}}
    for call, runs in calls.items():
        runs.sort(key=lambda r: r["run"])
        dev = next((r["device"] for r in runs if "device" in r), "?")
        lines += [f"## {os.path.basename(os.path.abspath(call))}: one "
                  f"trunk and its branches ({dev})", ""]
        lines += curve_table(runs)
        gaps = final_gaps(runs)
        lines += ["", "Final gaps: " + ", ".join(
            f"{k} {v['gap']:+.3f} (re-est. {v['gap_reest']:+.3f}, step "
            f"{v['step']}{', stopped' if v['stopped'] else ''})"
            for k, v in gaps.items()), ""]
        saved["calls"][call] = {"device": dev, "final": gaps, "runs": runs}
    branches = {r["run"]: r for runs in calls.values() for r in runs
                if r["run"] in BRANCHES}
    if branches:
        lines += ["## Paired", "", "Gap (student minus teacher, running / "
                  "re-estimated BN statistics) of each branch at each eval, "
                  "and each branch's gap less its control's (B1 against "
                  "B0a, B2 against B0b: the same trunk); B0a - B0b is the "
                  "noise of two unchanged branches of two trunks.", ""]
        lines += paired_table(branches) + [""]
        lines += reading(calls, branches) + [""]
    b0 = [v for c in saved["calls"].values() for k, v in c["final"].items()
          if k in ("B0a", "B0b")]
    if len(b0) == 2:
        spread = abs(b0[0]["gap"] - b0[1]["gap"])
        saved["b0_spread"] = spread
        lines += [f"B0a / B0b final-gap spread: {spread:.3f}", ""]
    lines += ["## Every fine-tune run's gap beside its loss", "",
              "Each Protocol-B semi run of JAX's A/B (TPU v5e runs), of the "
              "port's (H100) and of these branches: the total loss of the "
              "step of its last eval (one step's, as `semi_sup_ab` records "
              "it), its worst and its last student-minus-teacher gap.", ""]
    lines += regime_table(AB_RESULTS, branches) + [""]
    if args.doc:
        write_text(args.doc, lines)
    if args.save:
        write_json(args.save, saved)
    print("\n".join(lines))
    return 0


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    for mode in ("trunk", "branch", "run"):
        p = sub.add_parser(mode)
        p.add_argument("--device", default="cuda")
        p.add_argument("--arm", default="gamma_ft")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--steps", type=int, default=8000)
        p.add_argument("--pretrain", type=int, default=4000)
        p.add_argument("--branch_at", type=int, default=5500)
        p.add_argument("--eval_every", type=int, default=250)
        p.add_argument("--smoke", action="store_true",
                       help="the CLIs' --smoke model (CPU tests)")
        p.add_argument("--num_points", type=int, default=None)
        p.add_argument("--state", default=None,
                       help="the saved state's file")
        p.add_argument("--deadline", type=float, default=None,
                       help="time.time() past which no step begins")
        if mode == "branch":
            p.add_argument("--name", required=True, choices=sorted(BRANCHES))
        if mode == "run":
            p.add_argument("--out", required=True)
            p.add_argument("--branches", default="B0a,B1")
            p.add_argument("--limit", type=float, default=None,
                           help="seconds for the trunk and its branches")
        else:
            p.add_argument("--json", default=None)
    p = sub.add_parser("report")
    p.add_argument("inputs", nargs="+", help="runs' .json or .log files")
    p.add_argument("--doc", default=None)
    p.add_argument("--save", default=None)
    args = ap.parse_args(argv)
    if args.mode in ("trunk", "branch") and not args.state:
        ap.error("--state is required")
    return args


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.mode == "trunk":
        return 0 if trunk(args)[1]["stopped_at"] is None else 1
    if args.mode == "branch":  # a branch the deadline stopped keeps its records
        branch(args)
        return 0
    if args.mode == "run":
        return run_all(args)
    return report(args)


if __name__ == "__main__":
    sys.exit(main())
