"""scripts/student_fall_torch.py, the student-fall diagnosis script, on the
CPU at the --smoke model (2048-point rooms, one intra-op thread):

- a branch from a state saved at step k, run for 2 steps, is bitwise the
  unbroken run's steps k+1..k+2: student and teacher parameters and
  BatchNorm buffers, AdamW moments and counts, the TrainState's step and
  the generator (the backfill before and after the branch step);
- the trunk is `semi_sup_ab.run_arm`: the same losses and held-out F1 at
  the same evals, bitwise, although its evals also run the BatchNorm
  re-estimation and the teacher's records;
- the re-estimation leaves the live student's parameters, buffers and
  mode untouched, and on unchanging inputs gives each BatchNorm the
  batch statistics of one forward, bitwise (what the running statistics
  become at momentum 0);
- the report rebuilds a run from its JSON file or from the printed lines
  of a run stopped before its JSON line;
- the script imports nothing of JAX or the JAX package.
"""
import ast
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from omni_pq_torch.config import SMOKE_MODEL, ModelConfig
from omni_pq_torch.experiments import semi_sup_ab
from omni_pq_torch.experiments.common import load_pool
from omni_pq_torch.infer import build_model
from omni_pq_torch.models import pointnet2

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "student_fall_torch.py")
POINTS = 2048


def _script():
    spec = importlib.util.spec_from_file_location("student_fall_torch",
                                                  SCRIPT)
    mod = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sf = _script()


def _args(mode, tmp_path, *extra, steps=6, pretrain=2, branch_at=3,
          eval_every=100):
    return sf.parse_args(
        [mode, "--device", "cpu", "--smoke", "--num_points", str(POINTS),
         "--steps", str(steps), "--pretrain", str(pretrain), "--branch_at",
         str(branch_at), "--eval_every", str(eval_every), "--state",
         str(tmp_path / "state.pth"), *extra])


def _assert_same_state(a, b):
    sa, sb = a.state, b.state
    for ma, mb in ((sa.model, sb.model), (sa.ema_model, sb.ema_model)):
        da, db = ma.state_dict(), mb.state_dict()
        assert da.keys() == db.keys()
        for k in da:
            assert torch.equal(da[k], db[k]), k
    oa, ob = sa.optimizer, sb.optimizer
    for (name, x), y in zip(sa.model.named_parameters(),
                            sb.model.parameters()):
        assert oa.state[x].keys() == ob.state[y].keys() == {"mu", "nu"}
        for k in oa.state[x]:
            assert torch.equal(oa.state[x][k], ob.state[y][k]), (name, k)
    assert (oa.count, oa.mini_step, sa.step) == (ob.count, ob.mini_step,
                                                 sb.step)
    assert torch.equal(a.gen.get_state(), b.gen.get_state())


@pytest.mark.parametrize("pretrain", [2, 3], ids=["backfill_in_trunk",
                                                  "backfill_in_branch"])
def test_branch_from_saved_state_is_the_unbroken_run(tmp_path, pretrain):
    k = 3
    unbroken = sf.setup(_args("trunk", tmp_path, pretrain=pretrain))
    out = {"curve": []}
    sf.train_span(unbroken, 0, k + 2, out)
    assert out["backfilled_at"] == pretrain and out["stopped_at"] is None

    args = _args("trunk", tmp_path, "--json", str(tmp_path / "trunk.json"),
                 pretrain=pretrain, branch_at=k)
    trunk, trunk_out = sf.trunk(args)
    assert os.path.exists(args.state) and trunk_out["state"] == args.state
    # the trunk's state reloads bitwise
    fresh = sf.setup(args)
    assert sf.load_state(args.state, fresh) == k
    _assert_same_state(trunk, fresh)

    bargs = _args("branch", tmp_path, "--name", "B0a", "--json",
                  str(tmp_path / "B0a.json"), steps=k + 2,
                  pretrain=pretrain, branch_at=k)
    # a state saved for another run's settings is refused
    with pytest.raises(ValueError, match="settings"):
        sf.branch(bargs)
    bargs.steps = 6
    run = sf.setup(bargs, "B0a")
    assert sf.load_state(bargs.state, run) == k
    branch_out = {"curve": []}
    sf.train_span(run, k, k + 2, branch_out)
    assert ("backfilled_at" in branch_out) == (pretrain == k)
    _assert_same_state(run, unbroken)


def test_trunk_records_are_run_arms(tmp_path):
    steps, pretrain, every = 4, 2, 2
    args = _args("trunk", tmp_path, steps=steps, pretrain=pretrain,
                 branch_at=steps, eval_every=every)
    em = sf.gamma.gamma_mixture_em
    _, out = sf.trunk(args)
    assert sf.gamma.gamma_mixture_em is em
    cfg = sf.model_config(args)
    settings = semi_sup_ab.Settings(steps=steps, eval_every=every, seeds=[0],
                                    arms=["gamma_ft"], pretrain=pretrain,
                                    out=str(tmp_path / "ab.json"))
    want = semi_sup_ab.run_arm(
        "gamma_ft", 0, load_pool(100, semi_sup_ab.N_LABELED, POINTS),
        load_pool(200, semi_sup_ab.N_WEAK, POINTS),
        load_pool(999, semi_sup_ab.N_VAL, POINTS), settings, cfg,
        torch.device("cpu"))["curve"]
    got = out["curve"]
    assert [c["step"] for c in got] == [c["step"] for c in want] == [1, 2, 4]
    for g, w in zip(got, want):
        assert (g["total_loss"], g["f1"], g.get("f1_ema")) == (
            w["loss"], w["f1"], w.get("f1_ema"))
    last = got[-1]
    assert set(sf.SEMI_RECORD_KEYS) <= set(last)
    assert last["gap"] == last["f1"] - last["f1_ema"]
    assert 0 < last["fit_w"] < 1 and last["param_gap"] > 0


def test_reestimate_leaves_the_student_and_repeats_batch_stats(monkeypatch):
    cfg = ModelConfig(num_points=POINTS, dropout=0.0, **SMOKE_MODEL)
    model = build_model(cfg, "cpu", seed=3)
    model.train()
    pool = load_pool(100, 2, POINTS)
    clouds = torch.from_numpy(pool["point_clouds"])
    live = {k: v.clone() for k, v in model.state_dict().items()}
    momentum_update = pointnet2.update_running_stats

    copy = sf.reestimate_bn(model, [(clouds, (1, 1))] * 3, None)
    assert pointnet2.update_running_stats is momentum_update
    assert model.training and not copy.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, live[k]), k
    bns = sf.batchnorms(copy)
    assert len(bns) == len(sf.batchnorms(model)) > 20

    # one train-mode forward at momentum 0: the running statistics become
    # the batch statistics exactly
    monkeypatch.setattr(pointnet2, "BN_MOMENTUM", 0.0)
    with torch.no_grad():
        model(clouds)
    for got, want in zip(bns, sf.batchnorms(model)):
        assert torch.equal(got.running_mean, want.running_mean)
        assert torch.equal(got.running_var, want.running_var)
    key = "backbone.sa1.mlp_module.layer0.bn.bn.running_mean"
    assert not torch.equal(model.state_dict()[key], live[key])


def test_report_rebuilds_runs_and_the_b0_spread(tmp_path):
    rec = {"step": 6, "total_loss": 0.1, "f1": 0.4, "f1_ema": 0.5, "f1_reest": 0.45,
           "gap": -0.1, "gap_reest": -0.05, "param_gap": 0.01,
           "bn_gap": 0.02, "bn_reest_gap": 0.01, "ms_per_step": 500.0}
    call = tmp_path / "call1"
    call.mkdir()
    (call / "B0a.json").write_text(json.dumps(
        {"run": "B0a", "device": "card", "curve": [dict(rec, run="B0a")],
         "stopped_at": None}))
    # a run stopped before its JSON line: its records alone
    (call / "B0b.log").write_text("\n".join(
        ["[student_fall] branch B0b", "STUDENT_FALL_RECORD " + json.dumps(
            dict(rec, run="B0b", gap=0.05, f1=0.55)), "killed"]))
    doc, saved = tmp_path / "D.md", tmp_path / "D.json"
    assert sf.main(["report", str(call / "B0a.json"), str(call / "B0b.log"),
                    "--doc", str(doc), "--save", str(saved)]) == 0
    out = json.loads(saved.read_text())
    final = out["calls"][str(call)]["final"]
    assert final["B0a"]["gap"] == -0.1 and not final["B0a"]["stopped"]
    assert final["B0b"]["stopped"] and out["b0_spread"] == pytest.approx(0.15)
    text = doc.read_text()
    assert "| B0b | 6 | 0.550 | 0.450 | 0.500 | +0.050 |" in text
    assert "- B0a - B0b over 1 evals: mean -0.1500" in text
    assert "- Worst gap of each branch: B0a -0.100, B0b +0.050." in text
    # every JAX and port Protocol-B run beside the branches
    assert "| JAX (`docs/semi_sup_ab_ft.json`) | gamma_ft s0 | 8000 |" in text
    assert "| this script | B0b | 6 | 0.100 | +0.050 | +0.050 |" in text


def test_script_imports_no_jax():
    tree = ast.parse(open(SCRIPT).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    banned = ("jax", "flax", "omni_pq_tpu")
    assert not [n for n in names if n.split(".")[0] in banned]
    code = ("import runpy, sys; runpy.run_path(sys.argv[1]); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{banned!r}))")
    res = subprocess.run([sys.executable, "-c", code, SCRIPT],
                         capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, OMP_NUM_THREADS="1"),
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_branch_flags():
    assert dataclasses.replace(
        semi_sup_ab.ARM_FLAGS["gamma"], **sf.BRANCHES["B1"]["flags"]
    ).lambda_metric_score == 0.0
    assert sf.BRANCHES["B2"] == {"tf32": True}
    assert sf.BRANCHES["B0a"] == sf.BRANCHES["B0b"] == {}
