"""The benchmark harness: one run of one cell of `BENCHMARK.json`.

Everything that belongs to one configuration, traffic mix, metric or model
is a file found by its name:
  - `configs/<config>.json`: the configuration as it is run (the model's
    sizes, `compute_dtype`, `tf32`, and `model`, the name of its model:
    "pq_transformer" where the key is absent);
  - the model's files (`find_model`): `models/<model>.py`, its program
    side, the only benchmark code besides this file that reaches the
    program (`omni_pq_torch`): the traffic kinds it serves (`KINDS`), the
    batch of each forward in a call (`forwards_per_call`) and `System`, the
    program built from the seeded state_dict through its own entry point,
    with its timed call; `reference/<model>_check.py`, its weights
    (`state_dict`) and its comparison with the plain reference
    (`check_eval`, `control_eval`, and for a model that trains
    `check_train`, `reference_readings`, `judge_train`), which imports
    nothing of the program; `counts/<model>.py`, its model FLOPs and its
    kernels' least times (`readers.py`);
  - `traffic/<mix>.json`: the traffic, read by the one generator here:
    `kind` "eval" (closed loop of the model's eval call on batches of
    `batch` rooms) or "train" (closed loop of its train step on `labeled`
    + `weak` rooms, with what else the model's step reads), `pool` distinct
    batches made from the seed and cycled, `num_points` a room;
  - `metrics/<metric>.py`: each metric's reader, `read(ctx)` -> a number or
    None (nothing to read in this cell);
  - `limits/<workload>.json`: the limit of each number the comparison
    with the reference computes for that cell.

A run: set-up (the program's kernels built at first use, the weights made
on the device from the seed, the pool of rooms, every shape warmed up:
`setup_s`), the measured window of `seconds`, with `trace` a short traced
window after it, then the check against the plain reference
(`reference/`), after the program's state is freed. The result is one
JSON line on standard output; the numbers compared, each beside its limit,
are also the last lines on standard error, after those read and not
compared.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "omni_pq_tpu")
DEFAULT_MODEL = "pq_transformer"
# a model's files under the benchmark's folder, by the part they play
MODEL_FILES = {"program": "models/{}.py", "check": "reference/{}_check.py",
               "counts": "counts/{}.py"}
TRACE_CALLS = {"eval": 10, "train": 3}
CHECK_STEPS = 3      # train: the first steps that the reference follows


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    s = np.random.SeedSequence([seed % 2 ** 64, stream]).generate_state(
        2, np.uint32)
    return (int(s[0]) << 31 | int(s[1]) >> 1) & (2 ** 63 - 1)


# --- the spec: BENCHMARK.json and the files it names ----------------------

@dataclasses.dataclass
class Model:
    """A model's three files, loaded: `program`, `check`, `counts`."""
    name: str
    program: object
    check: object
    counts: object


@dataclasses.dataclass
class Cell:
    name: str
    cfg: Dict                 # the configuration file's dict
    traffic: Dict
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Dict[str, float]
    model: Model


def load_spec(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: Dict, workload: str, e2e_of_cell: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") in e2e_of_cell if "moves" in metric else True


def find_cell(spec: Dict, workload: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"]
           if _reports(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, workload, names)]
    bench = root / BENCH.name
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((bench / "traffic"
                          / f"{w['traffic']}.json").read_text())
    model = find_model(cfg.get("model", DEFAULT_MODEL), root)
    if traffic["kind"] not in model.program.KINDS:
        raise SystemExit(
            f"workload {workload!r}: model {model.name!r} serves no "
            f"{traffic['kind']!r} traffic (traffic {w['traffic']!r}); it "
            f"serves {list(model.program.KINDS)}")
    return Cell(name=workload, cfg=cfg, traffic=traffic, chips=w["chips"],
                end_to_end=e2e, per_layer=per_layer,
                limits=json.loads((bench / "limits"
                                   / f"{workload}.json").read_text()),
                model=model)


def find_model(name: str, root: Path = ROOT) -> Model:
    """A model's files (MODEL_FILES), loaded; refused, before any set-up,
    where one is missing."""
    paths = {part: root / BENCH.name / f.format(name)
             for part, f in MODEL_FILES.items()}
    missing = [str(p.relative_to(root)) for p in paths.values()
               if not p.is_file()]
    if missing:
        raise SystemExit(f"model {name!r} has no {', '.join(missing)}")
    return Model(name, **{part: load_file(p, f"portbench_{part}_{name}")
                          for part, p in paths.items()})


def load_file(path: Path, module_name: str):
    """The module in `path`, loaded under `module_name` (the benchmark's
    files that a cell finds by name: a model's, a metric's reader)."""
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str, root: Path = ROOT):
    """The reader of a metric: `metrics/<metric>.py`'s `read`."""
    return load_file(root / BENCH.name / "metrics" / f"{metric}.py",
                     "portbench_metric_"
                     + metric.replace(".", "_").replace("-", "_")).read


# --- the program side -----------------------------------------------------

def make_pool(traffic: Dict, seed: int, device) -> List[Dict]:
    """`pool` batches of rooms from the seed (the frozen generator), as
    tensors on `device`: floats float32, integers int64."""
    import torch
    from . import rooms
    rng = np.random.default_rng(sub_seed(seed, 1))
    n = traffic["num_points"]

    def tensors(batch):
        out = {}
        for k, v in batch.items():
            a = np.asarray(v)
            if a.dtype.kind == "f":
                a = a.astype(np.float32)
            elif a.dtype.kind in "iu":
                a = a.astype(np.int64)
            out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return out

    pool = []
    for _ in range(traffic["pool"]):
        if traffic["kind"] == "eval":
            b = rooms.make_batch(rng, traffic["batch"], n)
            pool.append({"point_clouds": tensors(b)["point_clouds"]})
        else:
            entry = {"labeled": tensors(rooms.make_batch(
                rng, traffic["labeled"], n))}
            if traffic["weak"]:
                entry["weak"] = tensors(rooms.make_batch(
                    rng, traffic["weak"], n))
            pool.append(entry)
    return pool


@dataclasses.dataclass
class Window:
    calls: int = 0
    scenes: int = 0
    seconds: float = 0.0
    call_ms: List[float] = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    failed: int = 0


class Program:
    """The system under test on one cell: the model's `System` (its
    program side, built from the seed's weights), fed from the pool."""

    def __init__(self, cell: Cell, seed: int, device, pool, fault=None,
                 marks=None):
        self.cell, self.device, self.pool = cell, device, pool
        self.kind = cell.traffic["kind"]
        marks = [] if marks is None else marks
        sd = cell.model.check.state_dict(cell.cfg, seed, device)
        sync(device)
        marks.append(("weights", time.perf_counter()))
        self.system = cell.model.program.System(cell, seed, device, sd,
                                                fault, marks)
        self.i = 0
        del sd

    # one call of the timed entry point
    def call(self):
        entry = self.pool[self.i % len(self.pool)]
        self.i += 1
        return self.system.call(entry)

    def first_steps(self) -> Dict:
        """Train: the first CHECK_STEPS steps through the window's own call,
        with the readings the reference is held to (the model's
        `System.first_steps`)."""
        return self.system.first_steps(self.call)

    def warm(self) -> Optional[Dict]:
        """Run every shape of the cell once before the window; for a train
        cell these are the first steps the reference follows."""
        if self.kind == "train":
            readings = self.first_steps()
        else:
            readings = None
            for _ in range(len(self.pool) + 1):
                self.call()
        sync(self.device)
        return readings

    def run_window(self, seconds: float, keep_call: int) -> tuple:
        """Back-to-back calls for `seconds`; returns the window's record and
        the output of call `keep_call` of the window (eval) with its pool
        index."""
        import torch
        dev = self.device
        cuda = torch.device(dev).type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        w = Window()
        kept = None
        sync(dev)
        t0 = time.perf_counter()
        if self.kind == "eval":
            while True:
                idx = self.i % len(self.pool)
                c0 = time.perf_counter()
                out = self.call()
                sync(dev)
                w.call_ms.append((time.perf_counter() - c0) * 1e3)
                if w.calls == keep_call:
                    kept = (idx, out)
                del out
                w.calls += 1
                if (time.perf_counter() - t0 >= seconds
                        and w.calls > keep_call):
                    break
        else:
            losses = []
            while w.calls == 0 or time.perf_counter() - t0 < seconds:
                losses.append(self.system.loss(self.call()))
                w.calls += 1
            sync(dev)
            w.failed = int((~torch.isfinite(torch.stack(losses))).sum())
        w.seconds = time.perf_counter() - t0
        w.scenes = w.calls * scenes_per_call(self.cell.traffic)
        if cuda:
            w.peak_bytes = torch.cuda.max_memory_allocated()
        return w, kept

    def free(self):
        if hasattr(self, "system"):
            self.system.free()
            del self.system
        if hasattr(self, "pool"):
            del self.pool


def scenes_per_call(traffic: Dict) -> int:
    """Rooms a call takes: an eval batch, or a step's labeled + weak."""
    if traffic["kind"] == "eval":
        return traffic["batch"]
    return traffic["labeled"] + traffic["weak"]


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# --- the run --------------------------------------------------------------

def device_record(device) -> Dict:
    """The platform, the card's name, the number of cards the run used
    (those on which it allocated memory) and the peak on the fullest."""
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    peaks = [torch.cuda.max_memory_allocated(d)
             for d in range(torch.cuda.device_count())]
    used = [d for d, b in enumerate(peaks) if b > 0]
    return {"platform": "gpu",
            "kind": torch.cuda.get_device_name(used[0] if used else 0),
            "count": len(used), "memory_peak_bytes": max(peaks, default=0)}


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def measure(cell: Cell, seed: int, seconds: float, trace: bool,
            t_start: float, device="cuda", fault=None) -> Dict:
    """Set-up, the window, the traced window, then the check once the
    program's state is freed: every number the comparison computes."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = bool(cell.cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cell.cfg["tf32"])
    marks = [("imports", time.perf_counter())]
    pool = make_pool(cell.traffic, seed, device)
    marks.append(("rooms", time.perf_counter()))
    prog = Program(cell, seed, device, pool, fault, marks)
    readings = prog.warm()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    print("set-up s: " + ", ".join(
        f"{name} {t - prev:.3f}" for (name, t), prev in
        zip(marks, [t_start] + [t for _, t in marks])), file=sys.stderr)

    keep = int(np.random.default_rng(sub_seed(seed, 2)).integers(0, 4))
    win, kept = prog.run_window(seconds, keep)
    tr = None
    if trace:
        from .devicetrace import trace_calls
        tr = trace_calls(prog.call, TRACE_CALLS[prog.kind],
                         lambda: sync(device))
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: "
                         f"{found}")
    dev = device_record(device)

    if prog.kind == "eval":
        pool_idx, out = kept
        clouds = pool[pool_idx]["point_clouds"]
        prog.free()
        del pool, kept
        gc.collect()
        numbers = cell.model.check.check_eval(cell.cfg, seed, device, clouds,
                                              out)
    else:
        batches = [pool[k % len(pool)] for k in range(CHECK_STEPS)]
        prog.free()
        del pool
        gc.collect()
        numbers = cell.model.check.check_train(cell.cfg, cell.traffic, seed,
                                               device, batches, readings)
    return {"setup_s": setup_s, "window": win, "trace": tr, "device": dev,
            "numbers": numbers}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda", cfg_override=None,
             fault=None, root: Path = ROOT) -> Dict:
    """One run of `workload`; returns the result dict (the JSON line)."""
    cell = find_cell(load_spec(root), workload, root)
    if cfg_override:
        cell.cfg = {**cell.cfg, **cfg_override}
        if "num_points" in cfg_override:
            cell.traffic = {**cell.traffic,
                            "num_points": cfg_override["num_points"]}
    m = measure(cell, seed, seconds, trace, t_start, device, fault)
    win, tr, dev = m["window"], m["trace"], m["device"]
    checks = {k: {"value": m["numbers"][k], "limit": limit}
              for k, limit in cell.limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and win.failed == 0

    ctx = Context(cell=cell, window=win, setup_s=m["setup_s"], trace=tr)
    metrics = {}
    for spec in cell.per_layer if trace else cell.end_to_end:
        value = load_reader(spec["name"], root)(ctx)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    result = {"correct": bool(correct), "attempted": win.calls,
              "failed": win.failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": tr.idle_gaps}
    result["checks"] = checks
    for name, value in m["numbers"].items():
        if name not in checks:
            print(f"read {name} = {value!r} (not compared)", file=sys.stderr)
    return result


@dataclasses.dataclass
class Context:
    """What a metric's reader reads: the cell, the measured window, the
    set-up time and, in a traced run, the traced window."""
    cell: Cell
    window: Window
    setup_s: float
    trace: Optional[object] = None

    @property
    def kind(self) -> str:
        return self.cell.traffic["kind"]

    @property
    def batch(self) -> int:
        return scenes_per_call(self.cell.traffic)

    @property
    def forwards_per_call(self) -> List[int]:
        """The batch of each model forward in one call (the model's
        `forwards_per_call`)."""
        return self.cell.model.program.forwards_per_call(self.cell.traffic)


def p95(values: List[float]) -> float:
    """The 95th percentile, by linear interpolation between order
    statistics (statistics.quantiles' inclusive method)."""
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def emit(result: Dict) -> None:
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
