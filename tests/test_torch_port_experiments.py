"""The port's experiment drivers (omni_pq_torch.experiments), its init and
its helper scripts against the JAX package's, on the CPU.

- The A/B's pool protocols (`center_pool`, the ARKit quad zeroing), its arms'
  flags and its consistency-weight schedules, bitwise against
  scripts/semi_sup_ab.py's own functions and expressions on the same numpy
  pools (the script imported by path with AB_* set; it does no work at
  import).
- `quad_f1` and `held_out_f1` equal to scripts/convergence_tpu.py's and
  semi_sup_ab.py's on the same end points.
- The fine-tune protocol's teacher backfill: teacher and student equal
  after it, parameters and BatchNorm buffers, in storage of their own.
- Each driver's `main` at a reduced model on the CPU for a few steps,
  writing only where it is told (never under docs/); the convergence
  driver's --redoc merge; the A/B's resume.
- `semi_sup_report` against scripts/semi_sup_report.py on the same result
  files: the same medians (`_tables`) and the same "Reading" lines; its
  own sections (each arm's range over seeds beside JAX's, each run's last
  student and teacher beside JAX's) and a run that a time limit stopped,
  rebuilt from the driver's printed output and marked in the tables.
- `infer.init_weights`: flax's lecun_normal (a normal truncated at two
  standard deviations, variance 1/fan_in) on every projection of the full
  model: no weight beyond the truncation, each large layer's variance within
  five standard errors of 1/fan_in, its distribution that of JAX's draws on
  the same shape (two-sample Kolmogorov-Smirnov), where an untruncated
  normal of the same variance fails both.
- scripts/viz_data_torch.py against scripts/viz_data.py on a fake ScanNet
  tree (the same PLY bytes), and scripts/{train,eval}_torch.sh's command
  lines against the JAX scripts' and the port's parser.
- @slow: the port overfits two TINY rooms to corner-F1 >= 0.5 at raised
  radii (tests/test_convergence.py's regime).
"""
import dataclasses
import importlib.util
import json
import os
import re
import shlex
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy import stats as sstats

from omni_pq_torch.config import SCANNET_MEAN_SIZES, SMOKE_MODEL, ModelConfig
from omni_pq_torch.data import make_batch
from omni_pq_torch.experiments import (common, convergence, fitted_mixture,
                                       semi_sup_ab, semi_sup_report)
from omni_pq_torch.infer import TRUNC_NORMAL_STD, build_model
from omni_pq_torch.models import MultiHeadAttention
from omni_pq_torch.models.pointnet2 import Conv
from omni_pq_torch.train import (OptimizerConfig, TrainFlags, TrainState,
                                 batch_to_tensors, make_eval_step,
                                 make_train_step)
from tests.torch_fake_data import write_fake_scannet

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = ModelConfig(num_points=1024, **SMOKE_MODEL)


def _load_script(name, monkeypatch, env=()):
    """scripts/<name>.py as a module, imported with `env` set."""
    for k, v in dict(env).items():
        monkeypatch.setenv(k, v)
    spec = importlib.util.spec_from_file_location(
        f"_jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_ab(monkeypatch, tmp_path):
    return _load_script("semi_sup_ab", monkeypatch, {
        "AB_STEPS": "12", "AB_PRETRAIN": "5", "AB_SEEDS": "0",
        "AB_ARMS": "sup_ft,gamma_ft", "AB_OUT": str(tmp_path / "ab.json")})


@pytest.fixture
def docs_untouched():
    """Fails the test if it changed anything under docs/."""
    def snapshot():
        d = os.path.join(ROOT, "docs")
        return {f: os.stat(os.path.join(d, f)).st_mtime_ns
                for f in os.listdir(d)}
    before = snapshot()
    yield
    assert snapshot() == before, "a driver wrote under docs/"


# -- the A/B's pools, arms and schedules against scripts/semi_sup_ab.py -----

def test_pools_and_protocols_match_jax_driver(jax_ab):
    # the JAX driver's load_pool (40k points, its room) and the port's
    pool = common.load_pool(101, 2)
    jpool = jax_ab.load_pool(101, 2)
    assert pool.keys() == jpool.keys()
    for k in pool:
        np.testing.assert_array_equal(pool[k], jpool[k], err_msg=k)
    cen, jcen = common.center_pool(pool), jax_ab._center_pool(jpool)
    for k in cen:
        assert cen[k].dtype == jcen[k].dtype
        np.testing.assert_array_equal(cen[k], jcen[k], err_msg=k)
    # the centring moved every absolute key, and no zero padding row
    for k in common.ABS_KEYS:
        assert not np.array_equal(cen[k], pool[k]), k
    pad = np.abs(pool["gt_quad_centers"]).sum(-1) == 0
    assert pad.any() and (cen["gt_quad_centers"][pad] == 0).all()
    assert common.QUAD_GT_KEYS == jax_ab.QUAD_GT_KEYS
    assert common.ABS_KEYS == jax_ab._ABS_KEYS
    assert common.ROOM == jax_ab.ROOM
    assert common.QUAD_KEYS == jax_ab.QUAD_KEYS
    # each arm's pools: run_arm's sequence (:234-248) on the JAX functions
    val = {k: v[:1] for k, v in pool.items()}
    for base in semi_sup_ab.ARM_FLAGS:
        lab, weak, v = semi_sup_ab.arm_pools(base, pool, pool, val)
        jl, jw, jv = jpool, jpool, val
        if base == "arkit_centered":
            jl, jw, jv = (jax_ab._center_pool(jl), jax_ab._center_pool(jw),
                          jax_ab._center_pool(jv))
        if base in ("arkit", "arkit_centered"):
            jw = {k: (np.zeros_like(x) if k in jax_ab.QUAD_GT_KEYS else x)
                  for k, x in jw.items()}
        for got, want in ((lab, jl), (weak, jw), (v, jv)):
            for k in want:
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{base} {k}")


def test_arms_and_schedules_match_jax_driver(jax_ab):
    assert (semi_sup_ab.N_LABELED, semi_sup_ab.N_WEAK, semi_sup_ab.N_VAL,
            semi_sup_ab.BS) == (jax_ab.N_LABELED, jax_ab.N_WEAK,
                                jax_ab.N_VAL, jax_ab.BS)
    assert semi_sup_ab.ARM_FLAGS.keys() == jax_ab.ARM_FLAGS.keys()
    for arm, flags in semi_sup_ab.ARM_FLAGS.items():
        jf = dataclasses.asdict(jax_ab.ARM_FLAGS[arm])
        for field, v in dataclasses.asdict(flags).items():
            if field in jf:
                assert v == jf[field], (arm, field)
    steps, pre = jax_ab.STEPS, jax_ab.PRETRAIN
    assert (steps, pre) == (12, 5)
    for base, flags in jax_ab.ARM_FLAGS.items():
        # run_arm's cw_sched (:267-276), the JAX driver's own expressions
        ramp = max(1, steps // 3)
        scratch = np.asarray(jax_ab.jnp.asarray([
            jax_ab.consistency_weight(i / ramp, 0.05, 1) if flags.ema
            else 0.0 for i in range(steps)], dtype=jax_ab.jnp.float32))
        ft = np.asarray(jax_ab.jnp.asarray(
            [0.0] * pre + [0.05] * (steps - pre), jax_ab.jnp.float32))
        for finetune, want in ((False, scratch), (True, ft)):
            got = semi_sup_ab.cw_schedule(base, finetune, steps, pre)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{base} ft={finetune}")


# -- the F1 helpers against the JAX drivers' ---------------------------------

def _end_points(labels, rng, K=32):
    """Quad end points: the first quads of each scene the ground truth's,
    nudged, the rest random, with confident and unconfident scores."""
    B = labels["gt_quad_centers"].shape[0]
    center = rng.uniform(0.5, 3.0, (B, K, 3)).astype(np.float32)
    size = rng.uniform(0.5, 2.5, (B, K, 2)).astype(np.float32)
    normal = rng.normal(size=(B, K, 3)).astype(np.float32)
    normal[..., 2] = 0
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    for b in range(B):
        n = int(labels["num_gt_quads"][b])
        center[b, :n] = labels["gt_quad_centers"][b, :n] + rng.normal(
            0, 0.02, (n, 3))
        size[b, :n] = labels["gt_quad_sizes"][b, :n]
        normal[b, :n] = labels["gt_normal_vectors"][b, :n]
    scores = rng.normal(0, 2, (B, K, 2)).astype(np.float32)
    scores[:, :3, 1] += 6.0
    return {"last_quad_center": center, "last_quad_size": size,
            "last_normal_vector": normal, "last_quad_scores": scores}


def test_f1_helpers_match_jax_drivers(monkeypatch, jax_ab):
    jconv = _load_script("convergence_tpu", monkeypatch)
    rng = np.random.default_rng(5)
    labels = make_batch(rng, 3, 2048, **common.ROOM)
    ep = _end_points(labels, rng)
    ep_t = {k: torch.from_numpy(v) for k, v in ep.items()}

    def jax_ev(state, clouds, use_ema=False):
        return ep

    f1, tp, fp = common.quad_f1(ep_t, labels)
    assert (f1, tp, fp) == jconv.quad_f1(jax_ev, None, labels, labels)
    assert tp > 0 and fp > 0 and 0 < f1 < 1

    calls = []

    def port_ev(state, clouds, use_ema=False):
        calls.append(use_ema)
        return ep_t
    for use_ema in (False, True):
        got = common.held_out_f1(port_ev, None, None, labels, use_ema=use_ema)
        assert got == jax_ab.held_out_f1(jax_ev, None, None, labels,
                                         use_ema=use_ema) == f1
    assert calls == [False, True]


def test_draw_picks_distinct_scenes_from_the_generator():
    pool = {"point_clouds": torch.arange(16.0).reshape(16, 1),
            "idx": torch.arange(16)}
    g = torch.Generator().manual_seed(3)
    a = common.draw(pool, 3, g)
    assert len(set(a["idx"].tolist())) == 3
    assert torch.equal(a["point_clouds"][:, 0].long(), a["idx"])
    b = common.draw(pool, 3, torch.Generator().manual_seed(3))
    assert torch.equal(a["idx"], b["idx"])


# -- the fine-tune protocol's backfill ----------------------------------------

def test_backfill_copies_student_into_teacher_storage():
    cfg = SMOKE
    model = build_model(cfg, "cpu", seed=1).train()
    state = TrainState(model, OptimizerConfig(total_steps=4), ema=True)
    batch = batch_to_tensors(make_batch(np.random.default_rng(2), 2,
                                        cfg.num_points, **common.ROOM), "cpu")
    step = make_train_step(model, cfg, SCANNET_MEAN_SIZES,
                           semi_sup_ab.ARM_FLAGS["sup"])
    step(state, batch, batch, torch.Generator().manual_seed(0), 0.0)
    student, teacher = state.model.state_dict(), state.ema_model.state_dict()
    assert student.keys() == teacher.keys()
    moved = [k for k in student if not torch.equal(student[k], teacher[k])]
    assert any("running_mean" in k for k in moved)
    assert any(k.endswith("weight") for k in moved)
    common.backfill_teacher(state)
    for k, v in student.items():
        assert torch.equal(teacher[k], v), k
        assert teacher[k].data_ptr() != v.data_ptr(), k
    # the teacher holds its own copy: the student moves on alone
    before = {k: v.clone() for k, v in teacher.items()}
    step(state, batch, batch, torch.Generator().manual_seed(1), 0.0)
    for k, v in state.ema_model.state_dict().items():
        assert torch.equal(v, before[k]), k


# -- the drivers' main(), reduced, on the CPU --------------------------------

def _run(driver, argv, monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert driver.main(argv + ["--device", "cpu", "--smoke",
                               "--num_points", "1024"]) == 0


def test_convergence_driver_runs_and_merges(tmp_path, monkeypatch, capsys,
                                            docs_untouched):
    paths = {}
    for seed in (0, 1):
        paths[seed] = str(tmp_path / f"conv_s{seed}.json")
        _run(convergence, ["--json", paths[seed],
                           "--doc", str(tmp_path / f"CONV_s{seed}.md")],
             monkeypatch, {"CONV_STEPS": "3", "CONV_EVAL_EVERY": "2",
                           "CONV_SEEDS": str(seed), "CONV_BF16": ""})
        out = json.load(open(paths[seed]))
        curve = out["curves"][str(seed)]
        assert [c["step"] for c in curve] == [1, 2]
        assert all(np.isfinite(c["loss"]) for c in curve)
        assert out["ms_per_step"][str(seed)] > 0
    assert capsys.readouterr().out.count("CONVERGENCE_JSON {") == 2
    merged_json = str(tmp_path / "merged.json")
    merged_doc = str(tmp_path / "MERGED.md")
    assert convergence.main(["--redoc", paths[0], paths[1], "--json",
                             merged_json, "--doc", merged_doc]) == 0
    merged = json.load(open(merged_json))
    assert merged["seeds"] == [0, 1]
    for i, c in enumerate(merged["median_curve"]):
        f1s = [merged["curves"][s][i]["f1"] for s in ("0", "1")]
        assert c["f1"] == float(np.median(f1s))
    doc = open(merged_doc).read()
    assert "| step | F1 s0 | F1 s1 | median F1 |" in doc
    assert "JAX median F1" in doc


def test_fitted_mixture_driver_runs(tmp_path, monkeypatch, docs_untouched):
    path = str(tmp_path / "fm.json")
    _run(fitted_mixture, ["--json", path, "--doc", str(tmp_path / "FM.md")],
         monkeypatch, {"FM_STEPS": "5", "FM_PRETRAIN": "2"})
    out = json.load(open(path))
    assert out["pretrain"] == 2
    for crit in ("fixed", "fitted"):
        (rec,) = out[crit]["curve"]
        assert rec["step"] == 5
        assert set(fitted_mixture.RECORDED) <= set(rec)
        assert all(np.isfinite(rec[k]) for k in fitted_mixture.RECORDED)
    assert "| fitted |" in open(tmp_path / "FM.md").read()


def test_semi_sup_ab_driver_runs_and_resumes(tmp_path, monkeypatch, capsys,
                                             docs_untouched):
    out_path = str(tmp_path / "ab_ft.json")
    env = {"AB_STEPS": "4", "AB_EVAL_EVERY": "2", "AB_PRETRAIN": "2",
           "AB_SEEDS": "0", "AB_ARMS": "gamma_ft,arkit_centered_ft",
           "AB_OUT": out_path}
    doc = str(tmp_path / "SEMI.md")
    _run(semi_sup_ab, ["--doc", doc], monkeypatch, env)
    runs = json.load(open(out_path))["runs"]
    assert [(r["arm"], r["seed"]) for r in runs] == [
        ("gamma_ft", 0), ("arkit_centered_ft", 0)]
    for r in runs:
        assert r["backfilled"]
        first, last = r["curve"][0], r["curve"][-1]
        # the pretrain runs the supervised step: no teacher, no criterion
        assert "f1_ema" not in first and "gamma_engaged_frac" not in first
        assert "f1_ema" in last and "gamma_engaged_frac" in last
        assert r["best_f1"] == max(max(c["f1"], c.get("f1_ema", 0.0))
                                   for c in r["curve"])
    assert "arkit_pc_loss" in runs[1]["curve"][-1]
    assert "## Protocol B" in open(doc).read()
    capsys.readouterr()
    _run(semi_sup_ab, ["--doc", doc], monkeypatch, env)  # resumes: no run
    assert "resuming: 2 runs already done" in capsys.readouterr().out
    assert len(json.load(open(out_path))["runs"]) == 2
    # a scratch arm: the ramped consistency weight, the teacher throughout
    monkeypatch.setenv("AB_ARMS", "ema")
    monkeypatch.setenv("AB_STEPS", "3")
    monkeypatch.setenv("AB_OUT", str(tmp_path / "ab.json"))
    _run(semi_sup_ab, ["--doc", doc], monkeypatch, {})
    (r,) = json.load(open(tmp_path / "ab.json"))["runs"]
    assert not r["backfilled"] and all("f1_ema" in c for c in r["curve"])
    monkeypatch.setenv("AB_ARMS", "sup,gamma_ft")
    monkeypatch.delenv("AB_OUT")
    with pytest.raises(SystemExit):
        semi_sup_ab.Settings.from_env()


def test_stopped_run_is_rebuilt_from_its_output(tmp_path, monkeypatch,
                                                capsys, docs_untouched):
    """A run's printed output, cut after an eval as a time limit would cut
    it, rebuilds the run to that eval (the JSON's values to the printed
    decimals), and the report marks it as stopped there."""
    env = {"AB_STEPS": "4", "AB_EVAL_EVERY": "2", "AB_PRETRAIN": "2",
           "AB_SEEDS": "0", "AB_ARMS": "arkit_centered_ft",
           "AB_OUT": str(tmp_path / "ab.json")}
    _run(semi_sup_ab, ["--doc", str(tmp_path / "SEMI.md")], monkeypatch, env)
    (whole,) = json.load(open(tmp_path / "ab.json"))["runs"]
    lines = capsys.readouterr().out.splitlines()
    for cut, steps in ((len(lines), [1, 2, 4]),
                       (next(i for i, x in enumerate(lines)
                             if "] step 2: heldout" in x) + 1, [1, 2])):
        log = tmp_path / "ab.log"
        log.write_text("\n".join(lines[:cut]) + "\n")
        doc = semi_sup_report.run_from_log(str(log))
        assert (doc["steps"], doc["pretrain"], doc["device"]) == (4, 2, "cpu")
        (run,) = doc["runs"]
        assert (run["arm"], run["seed"], run["stopped_at"]) == (
            "arkit_centered_ft", 0, steps[-1])
        assert run["backfilled"] == (steps[-1] == 4)
        assert [c["step"] for c in run["curve"]] == steps
        for got, want in zip(run["curve"], whole["curve"]):
            assert set(got) == set(want)
            # printed to 3 decimals (ms/step to 1)
            for k, tol in (("f1", 5e-4), ("f1_ema", 5e-4), ("loss", 5e-4),
                           ("ms_per_step", 0.05)):
                if want.get(k) is not None:
                    assert got[k] == pytest.approx(want[k], abs=tol * 1.01)
            for k in semi_sup_ab.LOG_RECORDS:
                if k in want:
                    assert got[k] == pytest.approx(want[k], rel=1e-5)
    assert "arkit_collisions" in run["curve"][-1] or steps[-1] == 2
    lines = semi_sup_report.render(str(tmp_path / "none.json"), [str(log)],
                                   str(tmp_path / "PORT.md"))
    assert any(x.startswith("| ") and "†" in x for x in lines)
    assert any("stopped at step 2" in x for x in lines)
    with pytest.raises(ValueError, match="not a semi_sup_ab run"):
        (tmp_path / "other.log").write_text("nothing\n")
        semi_sup_report.run_from_log(str(tmp_path / "other.log"))
    # --save into one of its inputs: each run once, and the saved file
    # renders the same report
    merged = str(tmp_path / "ab.json")
    md = [str(tmp_path / f"{n}.md") for n in ("A", "B")]
    for doc, inputs in ((md[0], [merged, str(log)]), (md[1], [merged])):
        assert semi_sup_report.main(
            ["--scratch", str(tmp_path / "none.json"), "--ft", *inputs,
             "--doc", doc, "--save", str(tmp_path / "s.json"), merged]) == 0
    runs = json.load(open(merged))["runs"]
    assert [(r["arm"], "stopped_at" in r) for r in runs] == [
        ("arkit_centered_ft", False), ("arkit_centered_ft", True)]
    assert (open(md[0]).read().split("-->")[1]
            == open(md[1]).read().split("-->")[1])
    assert not os.path.exists(tmp_path / "s.json")  # no scratch runs


def test_experiments_import_no_jax():
    code = ("import sys; import omni_pq_torch.experiments.convergence, "
            "omni_pq_torch.experiments.fitted_mixture, "
            "omni_pq_torch.experiments.semi_sup_ab, "
            "omni_pq_torch.experiments.semi_sup_report; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'omni_pq_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


# -- the report against scripts/semi_sup_report.py ---------------------------

def _fake_runs(rng, arms, seeds, steps):
    runs = []
    for arm in arms:
        for s in seeds:
            curve = [{"step": st, "f1": float(rng.uniform(0, 0.7)),
                      "loss": 1.0} for st in steps]
            if arm != "sup" and arm != "sup_ft":
                for c in curve[1:]:
                    c["f1_ema"] = float(rng.uniform(0, 0.7))
            runs.append({"arm": arm, "seed": s, "curve": curve,
                         "best_f1": max(max(c["f1"], c.get("f1_ema", 0.0))
                                        for c in curve),
                         "final_f1": curve[-1]["f1"],
                         "final_f1_ema": curve[-1].get("f1_ema")})
    return runs


def test_report_matches_jax_report(tmp_path, monkeypatch, docs_untouched):
    rng = np.random.default_rng(0)
    setup = {"labeled": 4, "weak": 16, "val": 8, "room": {}}
    steps = [1, 500, 1000]
    scratch = {"steps": 1000, "setup": setup,
               "runs": _fake_runs(rng, ["sup", "ema", "gamma"], [0, 1, 2],
                                  steps)}
    ft = {"steps": 1000, "pretrain": 500, "setup": setup,
          "runs": _fake_runs(rng, ["sup_ft", "ema_ft", "gamma_ft",
                                   "gamma_fixed_ft", "arkit_ft",
                                   "arkit_centered_ft"], [0, 1, 2], steps)}
    paths = {}
    for name, obj in (("scratch", scratch), ("ft", ft)):
        paths[name] = str(tmp_path / f"{name}.json")
        json.dump(obj, open(paths[name], "w"))
    jrep = _load_script("semi_sup_report", monkeypatch)
    monkeypatch.setattr(jrep, "SCRATCH_SRC", paths["scratch"])
    monkeypatch.setattr(jrep, "FT_SRC", paths["ft"])
    monkeypatch.setattr(jrep, "DST", str(tmp_path / "JAX.md"))
    jrep.main()
    port_lines = semi_sup_report.render(paths["scratch"], paths["ft"],
                                        str(tmp_path / "PORT.md"))

    def section(lines, title):
        i = lines.index(title)
        end = next((j for j in range(i + 1, len(lines))
                    if lines[j].startswith("## ")), len(lines))
        return [x for x in lines[i:end] if x]
    jlines = open(tmp_path / "JAX.md").read().split("\n")
    reading = section(jlines, "## Reading")
    assert len(reading) == 1 + 3 + 6 + 5 + 2
    assert section(port_lines, "## Reading") == reading
    for runs in (scratch["runs"], ft["runs"]):
        seeds = [0, 1, 2]
        assert semi_sup_report._tables(runs, seeds, []) == jrep._tables(
            runs, seeds, [])
    assert "## Beside the JAX package" in port_lines


def test_report_ranges_and_student_teacher(tmp_path, docs_untouched):
    """The port-only sections: each arm's median and range over seeds
    beside JAX's, and each run's final student / teacher beside JAX's run
    of the same arm and seed."""
    rng = np.random.default_rng(1)
    setup = {"labeled": 4, "weak": 16, "val": 8, "room": {}}
    port = {"steps": 1000, "pretrain": 500, "setup": setup,
            "runs": _fake_runs(rng, ["sup_ft", "gamma_ft"], [0, 2],
                               [1, 500, 1000])}
    path = str(tmp_path / "ft.json")
    json.dump(port, open(path, "w"))
    lines = semi_sup_report.render(str(tmp_path / "none.json"), path,
                                   str(tmp_path / "PORT.md"))
    with open(semi_sup_report.JAX_SRC["ft"]) as f:
        jruns = json.load(f)["runs"]
    by = {(r["arm"], r["seed"]): r for r in port["runs"]}
    jby = {(r["arm"], r["seed"]): r for r in jruns}
    for arm in ("sup_ft", "gamma_ft"):
        vals = sorted(r["best_f1"] for r in port["runs"] if r["arm"] == arm)
        jvals = sorted(r["best_f1"] for r in jruns if r["arm"] == arm)
        assert (f"| `{arm}` | {np.median(vals):.3f} (2) | {vals[0]:.3f}-"
                f"{vals[1]:.3f} | {np.median(jvals):.3f} (3) | "
                f"{jvals[0]:.3f}-{jvals[-1]:.3f} |") in lines
    i = lines.index("## Student and teacher at the last step")
    rows = [x for x in lines[i:] if x.startswith("| `")]
    assert len(rows) == 2  # gamma_ft's two seeds; sup_ft has no teacher
    for row, s in zip(rows, (0, 2)):
        r, j = by[("gamma_ft", s)], jby[("gamma_ft", s)]
        assert row == (
            f"| `gamma_ft` | {s} | {r['final_f1']:.3f} / "
            f"{r['final_f1_ema']:.3f} "
            f"({r['final_f1'] - r['final_f1_ema']:+.3f}) | "
            f"{j['final_f1']:.3f} / {j['final_f1_ema']:.3f} "
            f"({j['final_f1'] - j['final_f1_ema']:+.3f}) |")


# -- the init: flax's lecun_normal --------------------------------------------

def _projections(model):
    for name, m in model.named_modules():
        if isinstance(m, Conv):
            yield name, m.weight, m.bias
        elif isinstance(m, MultiHeadAttention):
            yield name, m.in_proj_weight, m.in_proj_bias


def _within_sampling_error(w, fan_in):
    w = np.asarray(w, np.float64).ravel()
    var = float(np.mean(w ** 2))
    se = np.sqrt((np.mean(w ** 4) - var ** 2) / w.size)
    return abs(var - 1.0 / fan_in) <= 5 * se


def test_init_weights_is_flax_lecun_normal():
    import jax
    model = build_model(ModelConfig(), "cpu", seed=0)
    layers = list(_projections(model))
    assert len(layers) > 50
    largest = max(layers, key=lambda t: t[1].numel())
    for name, w, b in layers:
        w = w.detach()
        fan_in = w.shape[1]
        std = np.sqrt(1.0 / fan_in) / TRUNC_NORMAL_STD
        assert float(w.abs().max()) <= np.float32(2 * std), name
        assert b is None or not b.any(), name
        if w.numel() >= 4096:
            assert _within_sampling_error(w.numpy(), fan_in), name
    # JAX's draws on the largest shape meet the same criteria, and their
    # distribution is the port's; an untruncated normal of the same
    # variance (the former init) fails both
    w = largest[1].detach().numpy().reshape(largest[1].shape[0], -1)
    fan_in = w.shape[1]
    jw = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (fan_in, w.shape[0]), jax.numpy.float32))
    std = np.sqrt(1.0 / fan_in) / TRUNC_NORMAL_STD
    assert np.abs(jw).max() <= np.float32(2 * std)
    assert _within_sampling_error(jw, fan_in)
    assert sstats.ks_2samp(w.ravel(), jw.ravel()).pvalue > 1e-3
    plain = np.random.default_rng(0).normal(0, np.sqrt(1.0 / fan_in),
                                            w.shape)
    assert np.abs(plain).max() > 2 * std
    assert sstats.ks_2samp(plain.ravel(), jw.ravel()).pvalue < 1e-6


# -- the helper scripts -------------------------------------------------------

def test_viz_data_torch_matches_jax_script(tmp_path, monkeypatch):
    root = tmp_path / "scannet"
    write_fake_scannet(str(root), ["scene0000_00", "scene0001_00"],
                       np.random.default_rng(0), n_verts=300)
    scan = str(root / "scannet_train_detection_data" / "scene0000_00")
    out = tmp_path / "port"
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                 "viz_data_torch.py"),
                    "--mode", "scannet-scene", "--scan", scan,
                    "--out", str(out)], check=True, cwd=tmp_path)
    jviz = _load_script("viz_data", monkeypatch)
    jviz.scannet_scene(scan, str(tmp_path / "jax"))
    files = sorted(os.listdir(out))
    assert files == ["gt_boxes.ply", "scene.ply", "scene_instance.ply",
                     "scene_semantic.ply"]
    for f in files:
        assert (out / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


@pytest.mark.parametrize("name,is_eval", [("train", False), ("eval", True)])
def test_shell_scripts_are_the_jax_command_lines(name, is_eval):
    from omni_pq_torch.cli.args import build_parser

    def command(path):
        text = open(path).read().replace("\\\n", " ")
        line = next(x for x in text.splitlines()
                    if x.strip().startswith("python -m"))
        return shlex.split(line)
    port = command(os.path.join(ROOT, "scripts", f"{name}_torch.sh"))
    jax_cmd = command(os.path.join(ROOT, "scripts", f"{name}.sh"))
    assert port[:3] == ["python", "-m", f"omni_pq_torch.cli.{name}"]
    assert jax_cmd[2] == f"omni_pq_tpu.cli.{name}"
    assert port[3:] == jax_cmd[3:]
    flags = [a for a in port[3:] if a.startswith("--")]
    args = [re.sub(r"^\$\{?\w+\}?$", "x", a.replace('"', ""))
            for a in port[3:] if a != "$@"]
    known = {a for act in build_parser(is_eval)._actions
             for a in act.option_strings}
    assert set(flags) <= known
    build_parser(is_eval).parse_args(args)
    subprocess.run(["bash", "-n", os.path.join(ROOT, "scripts",
                                               f"{name}_torch.sh")],
                   check=True)


# -- tests/test_convergence.py's overfit, on the port -------------------------

@pytest.mark.slow
def test_port_overfit_reaches_nonzero_f1():
    """tests/test_convergence.py::test_overfit_reaches_nonzero_f1 on the
    port: two fixed TINY rooms, 32 quad queries, raised radii (0.8 / 0.9 m)
    so that positive and negative assignments both exist at this scale,
    supervised-only; the corner-F1 must reach 0.5 within 800 steps."""
    cfg = dataclasses.replace(SMOKE, num_points=512, num_quad_proposal=32)
    labels = make_batch(np.random.default_rng(3), 2, cfg.num_points,
                        num_objects=2, w_range=(2.2, 2.6),
                        d_range=(2.2, 2.6), h_range=(1.5, 1.8))
    batch = batch_to_tensors(labels, "cpu")
    model = build_model(cfg, "cpu", seed=0)
    state = TrainState(model, OptimizerConfig(total_steps=800,
                                              learning_rate=2e-3), ema=True)
    flags = TrainFlags(ema=False, gamma_mixture=False, arkit=False,
                       pc_loss=False, near_threshold=0.8, far_threshold=0.9)
    step = make_train_step(model, cfg, SCANNET_MEAN_SIZES, flags)
    ev = make_eval_step()
    assert common.quad_f1(ev(state, batch["point_clouds"]), labels)[0] <= 0.2
    gen = torch.Generator().manual_seed(1)
    best = 0.0
    for i in range(800):
        stats = step(state, batch, batch, gen, 0.0)
        if (i + 1) % 125 == 0:
            f1 = common.quad_f1(ev(state, batch["point_clouds"]), labels)[0]
            best = max(best, f1)
            print(f"step {i + 1}: quad F1 {f1:.3f}")
            if best >= 0.5:
                break
    assert np.isfinite(float(stats["total_loss"]))
    assert best >= 0.5, f"corner-F1 stalled at {best:.3f}"
