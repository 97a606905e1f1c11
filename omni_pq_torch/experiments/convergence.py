"""Full-scale convergence: the full PQ-Transformer overfits 4 fixed
synthetic rooms, and the corner-F1 on them is logged against the step (the
port of scripts/convergence_tpu.py: `run_seed` :71-111, `main` :114-141).

The full model (40k points, 256 object + 256 quad queries, 6 decoder
layers), float32 unfused (or bfloat16 with CONV_BF16=1), the reference's
supervised losses with the physical constraints and its default 0.3/0.6 m
assignment radii, AdamW at 2e-3 on a cosine over the run. The rooms are
`make_batch(np.random.default_rng(7), 4, 40000, num_objects=3, w/d 2.0-2.6,
h 2.0-2.4)`, the train batch of every step; the F1 is the ap_helper_pq.py:
695-736 corner-F1 on them, evaluated in eval mode. Seed s gives the model's
weights (`build_model(seed=s)`) and the step's generator (1000 + s).

Knobs, environment variables as in the JAX driver: CONV_STEPS (6000),
CONV_EVAL_EVERY (500), CONV_SEEDS ("0"; "0,1,2" for the median),
CONV_BF16 ("1" for bfloat16 compute).

    python -m omni_pq_torch.experiments.convergence [--device cuda]
    python -m omni_pq_torch.experiments.convergence --redoc a.json b.json

Writes docs/convergence_curve_torch.json and docs/CONVERGENCE_torch.md
(`_bf16` before `_torch` with CONV_BF16=1; --json / --doc choose other
paths) and prints the results as one `CONVERGENCE_JSON {...}` line.
`--redoc` rebuilds the JSON's median and the doc from saved result files
(several: one a seed, merged), with no training.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import SCANNET_MEAN_SIZES, SMOKE_MODEL, ModelConfig
from ..data.synthetic import make_batch
from ..infer import build_model, resolve_device
from ..train import (OptimizerConfig, TrainFlags, TrainState, batch_to_tensors,
                     make_eval_step, make_train_step)
from .common import (ROOM, card_name, peak_gib, print_result, quad_f1, sync,
                     write_json, write_text)

FLAGS = TrainFlags(ema=False, gamma_mixture=False, arkit=False, pc_loss=True)
N_ROOMS = 4
LOSS_EVERY = 50
# the JAX package's evidence, read to stand beside the port's
JAX_JSON = {False: "docs/convergence_curve.json",
            True: "docs/convergence_curve_bf16.json"}


@dataclasses.dataclass(frozen=True)
class Settings:
    steps: int
    eval_every: int
    seeds: List[int]
    bf16: bool

    @classmethod
    def from_env(cls) -> "Settings":
        return cls(steps=int(os.environ.get("CONV_STEPS", 6000)),
                   eval_every=int(os.environ.get("CONV_EVAL_EVERY", 500)),
                   seeds=[int(s) for s in
                          os.environ.get("CONV_SEEDS", "0").split(",")],
                   bf16=os.environ.get("CONV_BF16", "") == "1")


def default_paths(bf16: bool):
    suffix = "_bf16" if bf16 else ""
    return (f"docs/convergence_curve{suffix}_torch.json",
            f"docs/CONVERGENCE{suffix}_torch.md")


def make_rooms(cfg: ModelConfig):
    """The 4 fixed rooms (numpy), as the JAX driver draws them."""
    return make_batch(np.random.default_rng(7), N_ROOMS, cfg.num_points,
                      **ROOM)


def run_seed(seed: int, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
             labels: Dict[str, np.ndarray], s: Settings,
             device: torch.device) -> Dict:
    """One seed's run: the F1 / tp / fp / loss curve every `eval_every`
    steps (and after step 1), the loss every 50 steps, steady ms a step
    (after step 1, evals excluded) and the card's peak memory at each
    eval."""
    model = build_model(cfg, device, seed=seed)
    state = TrainState(model, OptimizerConfig(total_steps=s.steps,
                                              learning_rate=2e-3), ema=True)
    step = make_train_step(model, cfg, SCANNET_MEAN_SIZES, FLAGS)
    ev = make_eval_step()
    gen = torch.Generator(device=device).manual_seed(1000 + seed)
    curve, losses = [], []
    t0 = time.time()
    t_steady = None
    eval_s = 0.0
    for i in range(s.steps):
        stats = step(state, batch, batch, gen, 0.0)
        evaluating = (i + 1) % s.eval_every == 0 or i == 0
        if (i + 1) % LOSS_EVERY == 0 or evaluating:
            loss = float(stats["total_loss"])  # the host waits here
            if (i + 1) % LOSS_EVERY == 0:
                losses.append(loss)
        if evaluating:
            te = time.time()
            f1, tp, fp = quad_f1(ev(state, batch["point_clouds"]), labels)
            sync(device)
            dt = time.time() - te
            if i > 0:
                eval_s += dt
            rec = {"step": i + 1, "f1": f1, "tp": tp, "fp": fp,
                   "loss": loss, "eval_s": dt, "peak_gib": peak_gib(device)}
            curve.append(rec)
            peak = ("" if rec["peak_gib"] is None
                    else f", peak {rec['peak_gib']:.2f} GiB")
            print(f"[seed {seed}] step {i + 1}: F1 {f1:.3f} tp {tp} fp {fp} "
                  f"loss {loss:.3f} ({time.time() - t0:.0f}s, eval "
                  f"{dt:.1f}s{peak})", flush=True)
            if i == 0:
                t_steady = time.time()
    sync(device)
    steady = s.steps - 1
    ms = ((time.time() - t_steady - eval_s) / steady * 1e3 if steady > 0
          else None)
    return {"curve": curve, "loss_every_50": losses, "ms_per_step": ms,
            "wall_s": time.time() - t0, "peak_gib": peak_gib(device)}


def median_curve(curves: Dict[int, List[Dict]], seeds: List[int]
                 ) -> List[Dict]:
    """The median over seeds of F1 and loss at each eval step (the
    headline: single trajectories carry tie-flip noise)."""
    steps = [c["step"] for c in curves[seeds[0]]]
    return [{"step": st,
             "f1": float(np.median([curves[s][i]["f1"] for s in seeds])),
             "loss": float(np.median([curves[s][i]["loss"] for s in seeds]))}
            for i, st in enumerate(steps)]


def summarise(runs: Dict[int, Dict], s: Settings, cfg: ModelConfig,
              card: str, shared: int) -> Dict:
    seeds = sorted(runs)
    curves = {sd: runs[sd]["curve"] for sd in seeds}
    return {"config": ("full PQ-Transformer" if cfg == ModelConfig(
                           compute_dtype=cfg.compute_dtype)
                       else f"reduced model {dataclasses.asdict(cfg)}")
            + f", {cfg.num_points} pts, {N_ROOMS} synthetic rooms "
              "(2.0-2.6 m), NEAR/FAR = reference default 0.3/0.6 m, "
              "supervised losses incl. physical constraints, "
            + ("bfloat16" if s.bf16 else "float32") + " unfused",
            "device": card, "runs_sharing_card": shared,
            "steps": s.steps, "eval_every": s.eval_every, "bf16": s.bf16,
            "seeds": seeds,
            "curves": {str(sd): curves[sd] for sd in seeds},
            "loss_every_50": {str(sd): runs[sd]["loss_every_50"]
                              for sd in seeds},
            "ms_per_step": {str(sd): runs[sd]["ms_per_step"] for sd in seeds},
            "wall_s": {str(sd): runs[sd]["wall_s"] for sd in seeds},
            "peak_gib": {str(sd): runs[sd]["peak_gib"] for sd in seeds},
            "median_curve": median_curve(curves, seeds)}


def merge(results: List[Dict]) -> Dict:
    """Several result files (one a seed, from separate processes) as one,
    the median recomputed over all their seeds."""
    out = json.loads(json.dumps(results[0]))
    for r in results[1:]:
        for key in ("curves", "loss_every_50", "ms_per_step", "wall_s",
                    "peak_gib"):
            out[key].update(r[key])
        if r["device"] != out["device"]:
            out["device"] = f"{out['device']}; {r['device']}"
    out["seeds"] = sorted(int(sd) for sd in out["curves"])
    curves = {sd: out["curves"][str(sd)] for sd in out["seeds"]}
    out["median_curve"] = median_curve(curves, out["seeds"])
    return out


def _load_jax(bf16: bool) -> Optional[Dict]:
    path = JAX_JSON[bf16]
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def doc_lines(out: Dict) -> List[str]:
    """docs/CONVERGENCE_torch.md: the port's curve, the JAX package's
    beside it."""
    seeds = out["seeds"]
    curves = {sd: out["curves"][str(sd)] for sd in seeds}
    bf16 = out["bf16"]
    jax = _load_jax(bf16)
    jax_med = ({c["step"]: c for c in jax["median_curve"]} if jax else {})
    env = (f"CONV_SEEDS={','.join(map(str, seeds))} "
           + ("CONV_BF16=1 " if bf16 else "")
           + (f"CONV_STEPS={out['steps']} " if out["steps"] != 6000 else ""))
    shared = out.get("runs_sharing_card", 1)
    lines = [
        "# Detection-quality convergence of the port"
        + (" — bfloat16" if bf16 else ""),
        "",
        "<!-- GENERATED by python -m omni_pq_torch.experiments.convergence"
        " --redoc from the run's JSON; re-run it instead of editing. -->",
        "",
        f"Command: `{env}python -m omni_pq_torch.experiments.convergence`"
        + (f", {shared} processes, one a seed (`CONV_SEEDS=s`), sharing "
           "the card; their JSONs merged by `--redoc`" if shared > 1 else "")
        + ".",
        "",
        f"Card: {out['device']}.",
        "",
        f"Setup: {out['config']}. The port of scripts/convergence_tpu.py "
        "(docs/CONVERGENCE.md): the same rooms, optimiser, losses and "
        "metric (quad corner-F1 with NMS, 0.5 confidence gate, 0.40 m "
        "corner matching, ceiling/floor synthesis; npos counts 6 quads a "
        "room, so 16 matched walls of 24 give recall 0.667). Seed s draws "
        "the port's weights (flax's lecun_normal, truncated) and its "
        "generator; the JAX run's seeds draw JAX's, so a seed's trajectory "
        "is not JAX's: the median over seeds is the headline.",
        "",
        "| step | " + " | ".join(f"F1 s{sd}" for sd in seeds)
        + " | median F1 | median loss | JAX median F1 | JAX median loss |",
        "|---" * (len(seeds) + 5) + "|"]
    for i, c in enumerate(out["median_curve"]):
        per_seed = " | ".join(f"{curves[sd][i]['f1']:.3f}" for sd in seeds)
        j = jax_med.get(c["step"])
        jcols = (f"{j['f1']:.3f} | {j['loss']:.3f}" if j else "— | —")
        lines.append(f"| {c['step']} | {per_seed} | {c['f1']:.3f} | "
                     f"{c['loss']:.3f} | {jcols} |")
    best = {sd: max(c["f1"] for c in curves[sd]) for sd in seeds}
    lines += ["", "Best F1 over the trajectory: " + ", ".join(
        f"seed {sd} {best[sd]:.3f}" for sd in seeds)
        + f" (median {np.median(list(best.values())):.3f})."]
    if jax:
        jbest = {int(sd): max(c["f1"] for c in jax["curves"][str(sd)])
                 for sd in jax["seeds"]}
        jlast = {int(sd): jax["curves"][str(sd)][-1]["f1"]
                 for sd in jax["seeds"]}
        lines += [
            f"JAX ({JAX_JSON[bf16]}): best over the trajectory "
            + ", ".join(f"seed {sd} {v:.3f}" for sd, v in jbest.items())
            + f" (median {np.median(list(jbest.values())):.3f}); F1 at "
            f"step {jax['median_curve'][-1]['step']} "
            + " / ".join(f"{v:.3f}" for v in jlast.values())
            + f" (median {jax['median_curve'][-1]['f1']:.3f})."]
    lines += ["", "Time and memory (the card above; a step's time is the "
              "loop's wall time after step 1, evals excluded"
              + (f", with {shared} runs sharing the card" if shared > 1
                 else "") + "):", "",
              "| seed | ms/step | wall s | peak GiB | eval s (median) |",
              "|---|---|---|---|---|"]
    for sd in seeds:
        ms = out["ms_per_step"][str(sd)]
        pk = out["peak_gib"][str(sd)]
        ev = np.median([c["eval_s"] for c in curves[sd][1:]] or [0.0])
        lines.append(f"| {sd} | {'—' if ms is None else f'{ms:.1f}'} | "
                     f"{out['wall_s'][str(sd)]:.0f} | "
                     f"{'—' if pk is None else f'{pk:.2f}'} | {ev:.2f} |")
    lines += ["", "The JAX docs' times are a TPU's and are not compared "
              "here. A tiny CPU variant of this run is "
              "`pytest tests/test_torch_port_experiments.py -m slow`."]
    return lines


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None, help="results file")
    ap.add_argument("--doc", default=None, help="markdown file")
    ap.add_argument("--redoc", nargs="*", default=None, metavar="JSON",
                    help="rebuild from these result files (default --json)")
    ap.add_argument("--shared", type=int, default=1,
                    help="runs sharing the card (recorded with the times)")
    ap.add_argument("--smoke", action="store_true",
                    help="the CLIs' --smoke model (CPU tests)")
    ap.add_argument("--num_points", type=int, default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    s = Settings.from_env()
    json_path, doc_path = default_paths(s.bf16)
    json_path = args.json or json_path
    doc_path = args.doc or doc_path
    if args.redoc is not None:
        results = []
        for path in args.redoc or [json_path]:
            with open(path) as f:
                results.append(json.load(f))
        out = merge(results)
        write_json(json_path, out)
        write_text(doc_path, doc_lines(out))
        print(f"wrote {json_path} and {doc_path}")
        return 0

    device = resolve_device(args.device)
    cfg = ModelConfig(compute_dtype="bfloat16" if s.bf16 else "float32",
                      **(SMOKE_MODEL if args.smoke else {}))
    if args.num_points:
        cfg = dataclasses.replace(cfg, num_points=args.num_points)
    card = card_name(device)
    print(f"[convergence] {card}; torch {torch.__version__}; steps "
          f"{s.steps}, eval every {s.eval_every}, seeds {s.seeds}, "
          f"{cfg.compute_dtype}", flush=True)
    labels = make_rooms(cfg)
    batch = batch_to_tensors(labels, device)
    runs = {sd: run_seed(sd, cfg, batch, labels, s, device)
            for sd in s.seeds}
    out = summarise(runs, s, cfg, card, args.shared)
    write_json(json_path, out)
    write_text(doc_path, doc_lines(out))
    print_result("CONVERGENCE_JSON", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
