"""Render docs/SEMI_SUP_torch.md from the port's A/B results (the port of
scripts/semi_sup_report.py, whose destination is the JAX package's doc).

Reads both protocols' files, docs/semi_sup_ab_torch.json (from scratch)
and docs/semi_sup_ab_ft_torch.json (the fine-tune protocol), and renders
the same tables (`_tables`, scripts/semi_sup_report.py:62-105) and the same
"Reading" medians and deltas (:183-207), then the JAX package's medians and
ranges over seeds (docs/semi_sup_ab.json, docs/semi_sup_ab_ft.json) beside
the port's, and each run's final student and teacher F1 beside JAX's run
of the same arm and seed. A protocol whose file is missing renders
nothing.

    python -m omni_pq_torch.experiments.semi_sup_report \\
        [--scratch PATH...] [--ft PATH...] [--doc PATH] [--save S.json F.json]

Several files for a protocol (one an arm, from processes that shared the
card) are merged; --save writes each protocol's merged results. A `.log`
among them is the printed output of a run that a time limit stopped before
it wrote its JSON: the run is rebuilt from its eval lines (`run_from_log`)
and marked, in the tables, as stopped at its last eval.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Dict, List

import numpy as np

SCRATCH_SRC = "docs/semi_sup_ab_torch.json"
FT_SRC = "docs/semi_sup_ab_ft_torch.json"
DST = "docs/SEMI_SUP_torch.md"
JAX_SRC = {"scratch": "docs/semi_sup_ab.json",
           "ft": "docs/semi_sup_ab_ft.json"}

ARM_LABEL = {
    "sup": "supervised-only",
    "ema": "+ EMA mean-teacher consistency",
    "gamma": "+ EMA + gamma-mixture pseudo-labels (fitted criterion)",
    "sup_ft": "supervised-only (all steps — the in-protocol baseline)",
    "ema_ft": "+ EMA mean-teacher consistency",
    "gamma_ft": "+ EMA + gamma-mixture (fitted criterion)",
    "gamma_fixed_ft": "+ EMA + gamma-mixture (FIXED criterion — the "
                      "reference-effective semantics, docs/FITTED_MIXTURE.md)",
    "arkit_ft": "+ EMA + ARKit omni-supervised pc loss (weak object boxes; "
                "UNCENTERED rooms — the measured negative: the loss's "
                "(0,0,1) pseudo scene center misfires off-origin)",
    "arkit_centered_ft": "+ EMA + ARKit omni-supervised pc loss, reference "
                         "scene-centering protocol "
                         "(arkitscenes_dataset.py:109-118)",
}
ARM_ORDER = ["sup", "ema", "gamma", "sup_ft", "ema_ft", "gamma_ft",
             "gamma_fixed_ft", "arkit_ft", "arkit_centered_ft"]


# semi_sup_ab.run_arm's eval line, and its first line's settings
EVAL_LINE = re.compile(
    r"\[(?P<arm>\w+) s(?P<seed>\d+)\] step (?P<step>\d+): heldout F1 "
    r"(?P<f1>[\d.]+)(?: ema (?P<f1_ema>[\d.]+))? loss (?P<loss>[\d.]+)"
    r"(?P<records>(?: [a-z_]+ [-\d.e+]+)*) \((?P<wall>\d+)s, eval "
    r"(?P<eval_s>[\d.]+)s(?:, (?P<ms>[\d.]+) ms/step)?"
    r"(?:, peak (?P<peak>[\d.]+) GiB)?\)")
HEADER = re.compile(r"^\[semi_sup_ab\] (?P<device>[^;]+); .* steps "
                    r"(?P<steps>\d+), pretrain (?P<pretrain>\d+),")


def run_from_log(path: str) -> Dict:
    """A results file's content for one run that a time limit stopped
    before it wrote its JSON, rebuilt from the eval lines the driver
    printed (F1 and loss to 3 decimals, ms/step to 0.1): its curve, best
    and last F1, and `stopped_at`, the step of its last eval."""
    curve, head, backfilled = [], None, False
    with open(path) as f:
        for line in f:
            head = head or HEADER.match(line)
            backfilled |= "teacher backfilled" in line
            m = EVAL_LINE.search(line)
            if not m:
                continue
            rec = {"step": int(m["step"]), "f1": float(m["f1"]),
                   "loss": float(m["loss"]),
                   "ms_per_step": m["ms"] and float(m["ms"]),
                   "eval_s": float(m["eval_s"]),
                   "peak_gib": m["peak"] and float(m["peak"])}
            words = m["records"].split()
            rec.update((k, float(v)) for k, v in zip(words[::2], words[1::2]))
            if m["f1_ema"] is not None:
                rec["f1_ema"] = float(m["f1_ema"])
            curve.append(rec)
            arm, seed, wall = m["arm"], int(m["seed"]), float(m["wall"])
    if head is None or not curve:
        raise ValueError(f"{path}: not a semi_sup_ab run's output")
    run = {"arm": arm, "seed": seed,
           "best_f1": max(max(c["f1"], c.get("f1_ema", 0.0)) for c in curve),
           "final_f1": curve[-1]["f1"],
           "final_f1_ema": curve[-1].get("f1_ema"), "curve": curve,
           "backfilled": backfilled, "wall_s": wall,
           "stopped_at": curve[-1]["step"]}
    return {"steps": int(head["steps"]), "pretrain": int(head["pretrain"]),
            "device": head["device"], "setup": None, "runs": [run]}


def _stopped(r) -> str:
    """The mark of a run a time limit stopped ("" for a whole run)."""
    return "†" if "stopped_at" in r else ""


def _load(paths) -> Dict:
    """A results file, or several (one an arm or seed, written by separate
    processes) as one: their runs concatenated, the rest the first's. A
    `.log` is a stopped run's output (`run_from_log`)."""
    out = None
    for path in [paths] if isinstance(paths, str) else paths or []:
        if not os.path.exists(path):
            continue
        if path.endswith(".log"):
            r = run_from_log(path)
        else:
            with open(path) as f:
                r = json.load(f)
        if out is None:
            out = r
        else:
            out["runs"] += r["runs"]
    return out or {"runs": [], "steps": None, "setup": None}


def _arms_in(runs) -> List[str]:
    present = {r["arm"] for r in runs}
    ordered = [a for a in ARM_ORDER if a in present]
    return ordered + sorted(present - set(ordered))


def medians(runs) -> Dict[str, float]:
    """Each arm's median best-F1 over its seeds."""
    return {arm: float(np.median([r["best_f1"] for r in runs
                                  if r["arm"] == arm]))
            for arm in _arms_in(runs)}


def _tables(runs, seeds, lines) -> Dict[str, float]:
    """Best held-out F1 a seed with its median and min, the final-step F1
    of student / teacher, and the trajectories; returns the medians."""
    by = {(r["arm"], r["seed"]): r for r in runs}
    arms = _arms_in(runs)
    med = {}
    lines += [
        "| arm | " + " | ".join(f"seed {s}" for s in seeds)
        + " | median | min |",
        "|---" * (len(seeds) + 3) + "|",
    ]
    for arm in arms:
        vals = [by[(arm, s)]["best_f1"] for s in seeds if (arm, s) in by]
        med[arm] = float(np.median(vals)) if vals else float("nan")
        row = " | ".join(f"{by[(arm, s)]['best_f1']:.3f}"
                         f"{_stopped(by[(arm, s)])}"
                         if (arm, s) in by else "—" for s in seeds)
        lines.append(f"| {ARM_LABEL.get(arm, arm)} | {row} | "
                     f"**{med[arm]:.3f}** | {min(vals):.3f} |")

    lines += ["", "Final-step held-out F1 (student / EMA teacher):", "",
              "| arm | " + " | ".join(f"seed {s}" for s in seeds) + " |",
              "|---" * (len(seeds) + 1) + "|"]
    for arm in arms:
        cells = []
        for s in seeds:
            r = by.get((arm, s))
            if r is None:
                cells.append("—")
            elif r.get("final_f1_ema") is not None:
                cells.append(f"{r['final_f1']:.3f} / {r['final_f1_ema']:.3f}"
                             f"{_stopped(r)}")
            else:
                cells.append(f"{r['final_f1']:.3f}{_stopped(r)}")
        lines.append(f"| {ARM_LABEL.get(arm, arm)} | " + " | ".join(cells)
                     + " |")

    lines += ["", "Trajectories (held-out F1 by step, max of student/EMA):",
              ""]
    for arm in arms:
        for s in seeds:
            r = by.get((arm, s))
            if r is None:
                continue
            pts = [f"{c['step']}:{max(c['f1'], c.get('f1_ema', 0.0)):.2f}"
                   for c in r["curve"][1:]]
            lines.append(f"- `{arm}` seed {s}: " + " ".join(pts)
                         + (f" (stopped at step {r['stopped_at']})"
                            if _stopped(r) else ""))
    stopped = sorted((r["arm"], r["seed"], r["stopped_at"]) for r in runs
                     if _stopped(r))
    if stopped:
        lines += ["", "† stopped by a time limit before its last step, at "
                  + ", ".join(f"`{a}` seed {s} step {n}"
                              for a, s, n in stopped)
                  + ": its best and last F1 are those of the steps it ran "
                  "(rebuilt from its printed eval lines)."]
    return med


def reading(scratch_runs, ft_runs, med_s, med_f) -> List[str]:
    """Each arm's median best-F1, and each arm's delta to its protocol's
    supervised baseline (sup_ft where the fine-tune protocol has it)."""
    lines = ["## Reading", ""]
    for arm in _arms_in(scratch_runs):
        lines.append(f"- `{arm}` (scratch) median best-F1: "
                     f"**{med_s[arm]:.3f}**")
    for arm in _arms_in(ft_runs):
        lines.append(f"- `{arm}` (reference protocol) median best-F1: "
                     f"**{med_f[arm]:.3f}**")
    for arm in _arms_in(ft_runs):
        if arm == "sup_ft":
            continue
        base_name, base = (("sup_ft", med_f["sup_ft"])
                           if "sup_ft" in med_f else
                           ("sup", med_s.get("sup")))
        if base is not None:
            lines.append(f"- `{arm}` vs `{base_name}` median: "
                         f"**{med_f[arm] - base:+.3f}**")
    if "sup" in med_s:
        for arm in _arms_in(scratch_runs):
            if arm != "sup":
                lines.append(f"- `{arm}` vs `sup` median: "
                             f"**{med_s[arm] - med_s['sup']:+.3f}**")
    return lines


def _spread(runs, arm) -> str:
    """An arm's best F1 over its seeds: the one value, or its range."""
    vals = sorted(r["best_f1"] for r in runs if r["arm"] == arm)
    if not vals:
        return "—"
    return (f"{vals[0]:.3f}" if len(vals) == 1
            else f"{vals[0]:.3f}-{vals[-1]:.3f}")


def beside_jax(port: Dict[str, Dict], jax: Dict[str, Dict]) -> List[str]:
    """The port's median best-F1 of each arm, and its range over seeds,
    beside the JAX package's."""
    lines = ["## Beside the JAX package", "",
             "JAX medians from " + " and ".join(JAX_SRC.values())
             + " (docs/SEMI_SUP.md's tables; their seeds are JAX's, so only "
             "medians and ranges over seeds compare).", "",
             "| arm | port median best-F1 (seeds) | port range | JAX median "
             "best-F1 (seeds) | JAX range |", "|---|---|---|---|---|"]
    for proto in ("scratch", "ft"):
        pruns, jruns = port[proto]["runs"], jax[proto]["runs"]
        pm, jm = medians(pruns), medians(jruns)
        for arm in _arms_in(pruns):
            ps = [r for r in pruns if r["arm"] == arm]
            js = [r for r in jruns if r["arm"] == arm]
            jcell = f"{jm[arm]:.3f} ({len(js)})" if arm in jm else "—"
            lines.append(f"| `{arm}` | {pm[arm]:.3f} ({len(ps)}) | "
                         f"{_spread(pruns, arm)} | {jcell} | "
                         f"{_spread(jruns, arm)} |")
    return lines


def student_teacher(port: Dict[str, Dict], jax: Dict[str, Dict]
                    ) -> List[str]:
    """Each run with a teacher: its final student and teacher F1 and their
    gap (student - teacher), the port's beside the JAX package's."""
    lines = ["## Student and teacher at the last step", "",
             "Final held-out F1, student / teacher (student - teacher).", "",
             "| arm | seed | port | JAX |", "|---|---|---|---|"]

    def cell(r):
        if r is None or r.get("final_f1_ema") is None:
            return "—"
        gap = r["final_f1"] - r["final_f1_ema"]
        return (f"{r['final_f1']:.3f} / {r['final_f1_ema']:.3f} ({gap:+.3f})"
                + (f" at step {r['stopped_at']} †" if _stopped(r) else ""))
    for proto in ("scratch", "ft"):
        runs = port[proto]["runs"]
        by_j = {(r["arm"], r["seed"]): r for r in jax[proto]["runs"]}
        for arm in _arms_in(runs):
            for r in sorted((r for r in runs if r["arm"] == arm),
                            key=lambda r: r["seed"]):
                if r.get("final_f1_ema") is not None:
                    lines.append(f"| `{arm}` | {r['seed']} | {cell(r)} | "
                                 f"{cell(by_j.get((arm, r['seed'])))} |")
    return lines


def render(scratch=SCRATCH_SRC, ft=FT_SRC, dst: str = DST) -> List[str]:
    """Write the report for these result files (a path, or a list of
    paths merged) to dst; returns its lines."""
    port = {"scratch": _load(scratch), "ft": _load(ft)}
    jax = {k: _load(v) for k, v in JAX_SRC.items()}
    sruns, fruns = port["scratch"]["runs"], port["ft"]["runs"]
    seeds = sorted({r["seed"] for r in sruns + fruns})
    setup = port["scratch"]["setup"] or port["ft"]["setup"] or {}
    card = port["ft"].get("device") or port["scratch"].get("device")
    lines = [
        "# Semi-supervised A/B in the port: does the machinery move "
        "HELD-OUT F1?",
        "",
        "<!-- GENERATED by python -m omni_pq_torch.experiments."
        "semi_sup_report from",
        f"     {_names(scratch)} + {_names(ft)}; re-run it instead of "
        "editing. -->",
        "",
        "The port's run of scripts/semi_sup_ab.py's experiment "
        "(docs/SEMI_SUP.md): `python -m omni_pq_torch.experiments."
        "semi_sup_ab`, at the full model (40k points, 256+256 "
        "proposals, 6 decoder layers) on synthetic rooms.",
        "",
        f"Card: {card}.",
        "",
        f"- **{setup.get('labeled')} labeled rooms** + "
        f"**{setup.get('weak')} weak (unlabeled) rooms**, "
        f"**{setup.get('val')} held-out rooms** fixed across seeds/arms",
        "- bs 3 labeled + 3 weak (AdamW, warmup-cosine, grad clip, EMA "
        "decay 0.999, consistency weight 0.05, lambda_metric_* = 5e-4)",
        "- metric: held-out quad corner-F1 (ap_helper_pq.py:695-736 "
        "semantics); an arm's score is its best F1 over the eval "
        "trajectory (max of student and EMA teacher)",
        "",
    ]
    med_s = med_f = {}
    if sruns:
        lines += [f"## Protocol A — from scratch "
                  f"({port['scratch']['steps']} steps)", "",
                  "Best held-out F1:", ""]
        med_s = _tables(sruns, seeds, lines)
        lines.append("")
    if fruns:
        lines += [
            "## Protocol B — supervised pretrain -> resume "
            f"({port['ft'].get('pretrain')} + "
            f"{port['ft']['steps'] - port['ft'].get('pretrain', 0)} steps)",
            "",
            "The teacher is backfilled from the student at the resume "
            "(train.py:167-173) and the consistency weight is 0.05 from "
            "then on.",
            "",
            "Best held-out F1:", ""]
        med_f = _tables(fruns, seeds, lines)
        lines.append("")
    lines += reading(sruns, fruns, med_s, med_f)
    lines += [""] + beside_jax(port, jax) + [""]
    lines += student_teacher(port, jax) + [""]
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    with open(dst, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {dst}")
    return lines


def _names(paths) -> str:
    return paths if isinstance(paths, str) else " ".join(paths)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scratch", nargs="+", default=[SCRATCH_SRC])
    ap.add_argument("--ft", nargs="+", default=[FT_SRC])
    ap.add_argument("--doc", default=DST)
    ap.add_argument("--save", nargs=2, metavar=("SCRATCH_JSON", "FT_JSON"),
                    help="also write each protocol's merged results")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    # both merged before either is written: a saved file may be an input
    merged = [_load(paths) for paths in (args.scratch, args.ft)]
    render(args.scratch, args.ft, args.doc)
    for m, dst in zip(merged, args.save or ()):
        if m["runs"]:
            os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
            with open(dst, "w") as f:
                json.dump(m, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
