"""The gamma-mixture criterion, fitted against fixed, at full scale (the
port of scripts/fitted_mixture_tpu.py: `pretrain` :40-65, `run` :68-107,
`main` :110-186).

The reference's EM fit never reaches its keep-mask (fit.py:152-174 labels
with the initial parameters): `use_fitted_mixture=False` is that fixed
criterion, `True` applies the fit (losses/gamma.py). Both runs start from
one init (`build_model(seed=0)`, or that model after FM_PRETRAIN supervised
steps) and train on the same 3 batches of 3 labeled + 3 weak synthetic
rooms of 40k points (`make_batch(np.random.default_rng(0), 3, 40000)`,
labeled then weak, three times) with every loss on: the EMA teacher,
consistency at weight 0.05, the gamma mixture and the physical
constraints. Every 5 steps the run records the four gamma metrics, the
gamma loss, the share of scenes where the criterion engaged and the total
loss; and each criterion's steady ms a step.

Knobs, environment variables as in the JAX driver: FM_STEPS (60),
FM_PRETRAIN (0).

    python -m omni_pq_torch.experiments.fitted_mixture [--device cuda]

Writes docs/fitted_mixture_curves_torch.json and
docs/FITTED_MIXTURE_torch.md (`_pre<N>` before `_torch` with FM_PRETRAIN=N;
--json / --doc choose other paths) and prints the results as one
`FITTED_MIXTURE_JSON {...}` line.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from ..config import SCANNET_MEAN_SIZES, SMOKE_MODEL, ModelConfig
from ..data.synthetic import make_batch
from ..infer import build_model, resolve_device
from ..models import PQTransformer
from ..train import (OptimizerConfig, TrainFlags, TrainState, batch_to_tensors,
                     make_train_step)
from .common import card_name, peak_gib, print_result, sync, write_json, \
    write_text

CHECK_EVERY = 5
CONSISTENCY_WEIGHT = 0.05
RECORDED = ("metric_normal", "metric_vertical", "metric_size", "metric_score",
            "gamma_mixture_filter_loss", "gamma_engaged_frac", "total_loss")
JAX_JSON = {0: "docs/fitted_mixture_curves.json",
            2000: "docs/fitted_mixture_curves_pre2000.json"}


def default_paths(pretrain: int):
    suffix = f"_pre{pretrain}" if pretrain else ""
    return (f"docs/fitted_mixture_curves{suffix}_torch.json",
            f"docs/FITTED_MIXTURE{suffix.upper()}_torch.md")


def make_batches(cfg: ModelConfig, device) -> List:
    """The 3 (labeled, weak) batches of 3 rooms, on the device."""
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        labeled = batch_to_tensors(make_batch(rng, 3, cfg.num_points), device)
        weak = batch_to_tensors(make_batch(rng, 3, cfg.num_points), device)
        batches.append((labeled, weak))
    return batches


def pretrain(model, cfg: ModelConfig, batches, steps: int, total: int,
             device) -> Dict[str, torch.Tensor]:
    """Supervised steps on the labeled batches from the shared init; the
    weights and BN statistics both criteria then start from."""
    state = TrainState(model, OptimizerConfig(total_steps=total))
    step = make_train_step(model, cfg, SCANNET_MEAN_SIZES,
                           TrainFlags(ema=False, gamma_mixture=False,
                                      pc_loss=True))
    gen = torch.Generator(device=device).manual_seed(3)
    t0 = time.time()
    for i in range(steps):
        lab = batches[i % len(batches)][0]
        stats = step(state, lab, lab, gen, 0.0)
        if (i + 1) % 50 == 0:
            print(f"[pretrain] step {i + 1}/{steps} loss "
                  f"{float(stats['total_loss']):.2f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    return copy.deepcopy(model.state_dict())


def run(use_fitted: bool, cfg: ModelConfig, init: Dict[str, torch.Tensor],
        batches, steps: int, device, label: str):
    """One criterion's run from `init`: its curve (every CHECK_EVERY
    steps; the stats stay on the device until the run ends) and its steady
    ms a step (after step 1)."""
    model = PQTransformer(cfg).to(device)
    model.load_state_dict(init)
    state = TrainState(model, OptimizerConfig(total_steps=steps), ema=True)
    flags = TrainFlags(ema=True, gamma_mixture=True, pc_loss=True,
                       use_fitted_mixture=use_fitted)
    step = make_train_step(model, cfg, SCANNET_MEAN_SIZES, flags)
    gen = torch.Generator(device=device).manual_seed(7)
    pending = []
    t_first = time.time()
    t_loop = None
    for i in range(steps):
        lab, weak = batches[i % len(batches)]
        stats = step(state, lab, weak, gen, CONSISTENCY_WEIGHT)
        if i == 0:
            sync(device)  # step 1 alone: build, warm-up
            print(f"[{label}] first step: {time.time() - t_first:.1f}s",
                  flush=True)
            t_loop = time.time()
        if (i + 1) % CHECK_EVERY == 0:
            pending.append((i + 1, {k: stats[k] for k in RECORDED}))
    sync(device)
    ms = ((time.time() - t_loop) / (steps - 1) * 1e3 if steps > 1
          else None)
    curve = [{"step": st, **{k: float(v) for k, v in d.items()}}
             for st, d in pending]
    print(f"[{label}] {ms} ms/step, peak {peak_gib(device)} GiB", flush=True)
    return curve, ms


def _load_jax(pretrain_steps: int):
    path = JAX_JSON.get(pretrain_steps)
    if path is None or not os.path.exists(path):
        return None, path
    with open(path) as f:
        return json.load(f), path


def _first_engaged(curve):
    """The first recorded step where the criterion engaged on a scene (the
    JAX package's first run recorded no engaged share: there, a non-zero
    gamma loss), or None."""
    on = [c["step"] for c in curve
          if c.get("gamma_engaged_frac", c["gamma_mixture_filter_loss"]) > 0]
    return on[0] if on else None


def doc_lines(out: Dict) -> List[str]:
    """docs/FITTED_MIXTURE_torch.md: the port's two curves, the JAX
    package's engaged shares beside them."""
    pre = out["pretrain"]
    jax, jpath = _load_jax(pre)
    fx, ft = out["fixed"], out["fitted"]
    env = (f"FM_STEPS={out['steps']} " if out["steps"] != 60 else "") + (
        f"FM_PRETRAIN={pre} " if pre else "")
    lines = [
        "# Fitted vs fixed gamma-mixture criterion in the port"
        + (f" — from a {pre}-step supervised-pretrained state"
           if pre else ""),
        "",
        f"Command: `{env}python -m omni_pq_torch.experiments."
        "fitted_mixture`. The port of scripts/fitted_mixture_tpu.py "
        "(docs/FITTED_MIXTURE.md).",
        "",
        f"Card: {out['device']}.",
        "",
        "The reference's EM fit never reaches its keep-mask (fit.py:152-174"
        " labels with the initial parameters): `use_fitted_mixture=False` "
        "is that fixed criterion, `True` applies a 25-step EM a scene a "
        "step (losses/gamma.py). Both runs start from the same init on the "
        f"same weak batches ({out['regime']}).",
        "",
        "Steady time a step on the card above (after step 1): "
        + ("—" if fx["ms_per_step"] is None else
           f"{fx['ms_per_step']:.1f} ms (fixed), "
           f"{ft['ms_per_step']:.1f} ms (fitted), "
           f"{ft['ms_per_step'] - fx['ms_per_step']:+.1f} ms for the EM")
        + ("" if out["peak_gib"] is None
           else f"; peak {out['peak_gib']:.2f} GiB") + ".",
        ""]
    engaged = {name: _first_engaged(d["curve"])
               for name, d in (("fixed", fx), ("fitted", ft))}
    jeng = ({name: _first_engaged(jax[name]["curve"])
             for name in ("fixed", "fitted")} if jax else {})

    def _first(v):
        return "never" if v is None else f"from step {v}"
    lines += [
        "| criterion | engages (port) | engages (JAX, "
        f"{jpath}) |", "|---|---|---|"]
    for name in ("fixed", "fitted"):
        lines.append(f"| {name} | {_first(engaged[name])} | "
                     + (_first(jeng[name]) if jax else "—") + " |")
    lines += [
        "",
        "| step | criterion | engaged | m_normal | m_vertical | m_size | "
        "m_score | total loss |",
        "|---|---|---|---|---|---|---|---|"]
    for name, d in (("fixed", fx), ("fitted", ft)):
        for c in d["curve"]:
            lines.append(
                f"| {c['step']} | {name} | {c['gamma_engaged_frac']:.2f} | "
                f"{c['metric_normal']:.4f} | {c['metric_vertical']:.4f} | "
                f"{c['metric_size']:.4f} | {c['metric_score']:.4f} | "
                f"{c['total_loss']:.3f} |")
    lines += ["", "The JAX docs' times are a TPU's and are not compared "
              "here."]
    return lines


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None, help="results file")
    ap.add_argument("--doc", default=None, help="markdown file")
    ap.add_argument("--redoc", action="store_true",
                    help="rebuild the doc from --json, with no training")
    ap.add_argument("--smoke", action="store_true",
                    help="the CLIs' --smoke model (CPU tests)")
    ap.add_argument("--num_points", type=int, default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    steps = int(os.environ.get("FM_STEPS", 60))
    pre = int(os.environ.get("FM_PRETRAIN", 0))
    json_path, doc_path = default_paths(pre)
    json_path = args.json or json_path
    doc_path = args.doc or doc_path
    if args.redoc:
        with open(json_path) as f:
            out = json.load(f)
        write_text(doc_path, doc_lines(out))
        print(f"wrote {doc_path}")
        return 0

    device = resolve_device(args.device)
    cfg = ModelConfig(**(SMOKE_MODEL if args.smoke else {}))
    if args.num_points:
        cfg = dataclasses.replace(cfg, num_points=args.num_points)
    card = card_name(device)
    print(f"[fitted_mixture] {card}; torch {torch.__version__}; steps "
          f"{steps}, pretrain {pre}", flush=True)
    batches = make_batches(cfg, device)
    model = build_model(cfg, device, seed=0)
    if pre:
        print(f"supervised pretrain: {pre} steps", flush=True)
        init = pretrain(model, cfg, batches, pre, pre + steps, device)
    else:
        init = copy.deepcopy(model.state_dict())
    del model
    fixed, fixed_ms = run(False, cfg, init, batches, steps, device, "fixed")
    fitted, fitted_ms = run(True, cfg, init, batches, steps, device,
                            "fitted")
    out = {"steps": steps, "pretrain": pre, "device": card,
           "regime": f"3+3 scenes/step, {cfg.num_points} pts, synthetic "
                     "rooms, all losses",
           "peak_gib": peak_gib(device),
           "fixed": {"ms_per_step": fixed_ms, "curve": fixed},
           "fitted": {"ms_per_step": fitted_ms, "curve": fitted}}
    write_json(json_path, out)
    write_text(doc_path, doc_lines(out))
    print_result("FITTED_MIXTURE_JSON", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
