"""The benchmark's spec and harness on the CPU: names and units, the files
each cell needs, an addition that edits no existing file (a cell of a
configuration, and a second model), the refusals of `find_cell`, the
import rules, and a run without a card."""
import ast
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
import time
import types

import pb_small
import pytest
from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.BENCH
ROOT = harness.ROOT


def spec():
    return harness.load_spec()


def test_names_units_and_keys():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in s["configs"]] + [
        w["name"] for w in s["workloads"]] + [
        m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in s["workloads"]]:
        assert NAME.match(n), n
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in s["end_to_end"]}
    for m in s["per_layer"]:
        assert m["moves"] in e2e
    for w in s["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] == 1


def test_every_cell_finds_its_files():
    s = spec()
    for w in s["workloads"]:
        cell = harness.find_cell(s, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.load_reader(m["name"]))
        assert cell.limits
    for c in s["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(s["paths"][0] + "/")


def test_an_addition_edits_no_existing_file(tmp_path):
    """A configuration, a traffic mix, a metric and a cell added as new
    files in a copy of the benchmark: the harness finds them by name and
    runs the new cell on the CPU, and no file that was there changed."""
    shutil.copytree(BENCH, tmp_path / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in (tmp_path / BENCH.name).rglob("*") if p.is_file()}
    new = tmp_path / BENCH.name
    cfg = json.loads((new / "configs" / "pqt_scannet_bf16.json").read_text())
    cfg.update(pb_small.SMALL)
    (new / "configs" / "tiny_added.json").write_text(json.dumps(cfg))
    (new / "traffic" / "eval_b2.json").write_text(json.dumps(
        {"kind": "eval", "batch": 2, "num_points": 1024, "pool": 2}))
    (new / "limits" / "eval_b2.tiny_added.json").write_text(json.dumps(
        {"index_mismatch": 0, "stage_a_gap": 1e-3, "stage_b_gap": 1e-3}))
    (new / "metrics" / "eval_calls.py").write_text(textwrap.dedent('''
        def read(ctx):
            return float(ctx.window.calls)
        '''))
    s = json.loads((tmp_path / "BENCHMARK.json").read_text())
    s["configs"].append({"name": "tiny_added", "source": "test",
                         "file": "portbench/configs/tiny_added.json",
                         "reduced": [], "why": "test"})
    s["workloads"].append({"name": "eval_b2.tiny_added",
                           "config": "tiny_added", "traffic": "eval_b2",
                           "chips": 1, "why": "test"})
    s["per_layer"].append({"name": "eval_calls", "unit": "count",
                           "better": "higher", "source": "host_clock",
                           "layer": "entry", "moves": "eval_scenes_per_s",
                           "workloads": ["eval_b2.tiny_added"]})
    s["end_to_end"][0]["workloads"].append("eval_b2.tiny_added")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))

    cell = harness.find_cell(harness.load_spec(tmp_path),
                             "eval_b2.tiny_added", tmp_path)
    assert cell.cfg["hidden_dim"] == 32 and cell.traffic["batch"] == 2
    assert [m["name"] for m in cell.per_layer][-1] == "eval_calls"
    r = harness.run_cell("eval_b2.tiny_added", pb_small.SEED, 0.3, False,
                         time.perf_counter(), device="cpu", root=tmp_path)
    assert r["correct"] and r["attempted"] >= 1
    assert set(r["metrics"]) == {"eval_scenes_per_s", "setup_s"}
    ctx = harness.Context(cell=cell, window=harness.Window(calls=7),
                          setup_s=1.0)
    assert harness.load_reader("eval_calls", tmp_path)(ctx) == 7.0
    after = {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in before}
    assert after == before


TOY = BENCH / "tests" / "toy_sa"   # a test-only model's files, as laid out


def hashes(bench):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in bench.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def copy_with_toy(tmp_path):
    """A copy of the benchmark with the test-only model `toy_sa` added as
    new files: its program side, check and counts, a configuration, an eval
    traffic mix, limits, and spec entries. Returns the hashes of the
    benchmark's files the copy had before."""
    shutil.copytree(BENCH, tmp_path / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = hashes(tmp_path / BENCH.name)
    for src in TOY.rglob("*"):
        if src.is_file() and "__pycache__" not in src.parts:
            dst = tmp_path / BENCH.name / src.relative_to(TOY)
            assert not dst.exists(), dst
            shutil.copy(src, dst)
    s = json.loads((tmp_path / "BENCHMARK.json").read_text())
    s["configs"].append({"name": "toy_sa", "source": "test",
                         "file": "portbench/configs/toy_sa.json",
                         "reduced": [], "why": "test"})
    s["workloads"].append({"name": "eval_b2.toy_sa", "config": "toy_sa",
                           "traffic": "eval_toy_b2", "chips": 1,
                           "why": "test"})
    for m in s["end_to_end"] + s["per_layer"]:
        if m["name"] in ("eval_scenes_per_s", "mfu.eval",
                         "point_kernels_roofline.eval"):
            m["workloads"].append("eval_b2.toy_sa")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    return before


def test_a_second_model_arrives_as_new_files(tmp_path):
    """A test-only model (one SA layer of the port, a max-pool, a linear
    head) added as new files in a copy of the benchmark: the harness finds
    its program, check and counts by the configuration's `model`, its cell
    runs `correct` on the CPU, a perturbed output is not `correct`, its
    metrics read its own counts, and no file that was there changed."""
    before = copy_with_toy(tmp_path)
    cell = harness.find_cell(harness.load_spec(tmp_path), "eval_b2.toy_sa",
                             tmp_path)
    assert cell.model.name == "toy_sa" and cell.traffic["batch"] == 2
    r = harness.run_cell("eval_b2.toy_sa", pb_small.SEED, 0.3, False,
                         time.perf_counter(), device="cpu", root=tmp_path)
    assert r["correct"] and r["attempted"] >= 1, r["checks"]
    assert set(r["checks"]) == {"index_mismatch", "out_gap"}
    assert set(r["metrics"]) == {"eval_scenes_per_s", "setup_s"}

    def perturbed(forward, model, pc):
        out = dict(forward(model, pc))
        out["logits"] = out["logits"] + 1e-3 * out["logits"].abs().max()
        return out

    r = harness.run_cell("eval_b2.toy_sa", pb_small.SEED, 0.3, False,
                         time.perf_counter(), device="cpu", root=tmp_path,
                         fault=perturbed)
    assert not r["correct"], r["checks"]
    assert r["checks"]["out_gap"]["value"] > r["checks"]["out_gap"]["limit"]
    clouds = harness.make_pool(cell.traffic, 3, "cpu")[0]["point_clouds"]
    control = cell.model.check.control_eval(cell.cfg, 3, "cpu", clouds)
    assert control["out_gap"] > cell.limits["out_gap"]

    # the toy's FLOPs and kernel bounds by hand: 2 rooms, 64 centres x 16
    # samples through 3 -> 32 -> 64, the head 64 -> 10; one FPS of 64 from
    # 1024 points and one ball query of 16 around each centre
    rows = 2 * 64 * 16
    flops = 2 * rows * (3 * 32 + 32 * 64) + 2 * 2 * 64 * 10
    fps = max(2 * 63 * 1024 * 10 / 67e12,
              (2 * 1024 * 12 + 2 * 64 * 4) / 3.35e12)
    bq = (2 * 1024 * 12 + 2 * 64 * 12 + rows * 16) / 3.35e12
    trace = types.SimpleNamespace(calls=4, kernel_s=lambda pattern: 1e-3)
    ctx = harness.Context(cell=cell, window=harness.Window(calls=5,
                                                           seconds=2.0),
                          setup_s=1.0, trace=trace)
    read = {m["name"]: harness.load_reader(m["name"], tmp_path)(ctx)
            for m in cell.per_layer}
    assert read["mfu.eval"] == pytest.approx(100 * flops * 5 / (2.0 * 67e12),
                                             rel=1e-12)
    assert read["point_kernels_roofline.eval"] == pytest.approx(
        100 * 4 * (fps + bq) / 1e-3, rel=1e-12)
    assert "fused_mlp_roofline.eval" not in read
    assert_reference_side_imports_no_program(tmp_path / BENCH.name)
    after = {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in before}
    assert after == before


@pytest.mark.parametrize("case", ["model_without_files", "kind_not_served"])
def test_find_cell_refuses_before_set_up(tmp_path, case):
    """A configuration naming a model with no files, and a cell whose
    traffic kind its model does not serve, are refused by `find_cell`,
    with a message naming what is missing."""
    copy_with_toy(tmp_path)
    bench = tmp_path / BENCH.name
    s = json.loads((tmp_path / "BENCHMARK.json").read_text())
    if case == "model_without_files":
        cfg = json.loads((bench / "configs" / "toy_sa.json").read_text())
        (bench / "configs" / "no_such.json").write_text(
            json.dumps({**cfg, "model": "no_such_model"}))
        s["configs"].append({"name": "no_such", "source": "test",
                             "file": "portbench/configs/no_such.json",
                             "reduced": [], "why": "test"})
        s["workloads"].append({"name": "eval_b2.no_such",
                               "config": "no_such", "traffic": "eval_toy_b2",
                               "chips": 1, "why": "test"})
        name = "eval_b2.no_such"
        wanted = ["no_such_model", "models/no_such_model.py",
                  "reference/no_such_model_check.py",
                  "counts/no_such_model.py"]
    else:
        s["workloads"].append({"name": "sup_b3.toy_sa", "config": "toy_sa",
                               "traffic": "sup_b3", "chips": 1,
                               "why": "test"})
        name = "sup_b3.toy_sa"
        wanted = ["toy_sa", "'train'", "sup_b3", "['eval']"]
    (bench / "limits" / f"{name}.json").write_text("{}")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    with pytest.raises(SystemExit) as e:
        harness.find_cell(harness.load_spec(tmp_path), name, tmp_path)
    for word in wanted:
        assert word in str(e.value), (word, str(e.value))


FORBIDDEN_CHECK = textwrap.dedent('''
    import sys
    import time
    sys.path.insert(0, {root!r})
    sys.path.insert(0, {tests!r})
    import torch
    torch.set_num_threads(2)
    import pb_small
    from portbench import harness
    for w in {cells!r}:
        r = harness.run_cell(w, 7, 0.2, False, time.perf_counter(),
                             device="cpu",
                             cfg_override=pb_small.SMALL)
        assert r["correct"], r
    print(sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                        "omni_pq_tpu")))
    ''')


def test_a_run_imports_no_jax():
    cells = [w["name"] for w in spec()["workloads"]]
    out = subprocess.run(
        [sys.executable, "-c", FORBIDDEN_CHECK.format(
            root=str(ROOT), tests=str(BENCH / "tests"), cells=cells)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


PROGRAM_SIDE = {"omni_pq_torch", "omni_pq_tpu", "jax", "jaxlib", "flax"}


def reference_side_files(bench):
    """The shared check and weights, and every file under `reference/`,
    where each model's reference and check lie (`harness.MODEL_FILES`)."""
    return [bench / "check.py", bench / "weights.py"] + sorted(
        (bench / "reference").rglob("*.py"))


def assert_reference_side_imports_no_program(bench):
    models = sorted(p.stem for p in (bench / "models").glob("*.py"))
    assert models
    files = reference_side_files(bench)
    for name in models:
        check_file = bench / harness.MODEL_FILES["check"].format(name)
        assert check_file in files, check_file
    for path in files:
        tops = {m.split(".")[0] for m in imported_modules(path)}
        assert not tops & PROGRAM_SIDE, (path, tops)
    checks = [str(bench / harness.MODEL_FILES["check"].format(n))
              for n in models]
    loads = "; ".join(f"harness.load_file(Path({c!r}), 'c{i}')"
                      for i, c in enumerate(checks))
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; from pathlib import Path; sys.path.insert(0, %r); "
         "import portbench.check, portbench.weights; "
         "from portbench import harness; %s; "
         "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
         % (str(ROOT), loads, PROGRAM_SIDE)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    assert_reference_side_imports_no_program(BENCH)


def test_nothing_reads_the_tpu_benchmarks():
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "import bench" not in text, path


def test_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "eval_b16.bf16",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
