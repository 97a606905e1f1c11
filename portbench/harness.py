"""The benchmark harness: one run of one cell of `BENCHMARK.json`.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name:
  - `configs/<config>.json`: the configuration as it is run (the port's
    `ModelConfig` fields, and `tf32`);
  - `traffic/<mix>.json`: the traffic, read by the one generator here:
    `kind` "eval" (closed loop of `infer.eval_forward` on batches of
    `batch` rooms) or "train" (closed loop of the step of
    `train.step.make_train_step` on `labeled` + `weak` rooms with the
    `flags`, `consistency_weight` and `optimizer` given), `pool` distinct
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
TRACE_CALLS = {"eval": 10, "train": 3}
CHECK_STEPS = 3      # train: the first steps that the reference follows


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    s = np.random.SeedSequence([seed % 2 ** 64, stream]).generate_state(
        2, np.uint32)
    return (int(s[0]) << 31 | int(s[1]) >> 1) & (2 ** 63 - 1)


# --- the spec: BENCHMARK.json and the files it names ----------------------

@dataclasses.dataclass
class Cell:
    name: str
    cfg: Dict                 # the configuration file's dict
    traffic: Dict
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Dict[str, float]


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
    return Cell(name=workload,
                cfg=json.loads((root / conf["file"]).read_text()),
                traffic=json.loads((bench / "traffic"
                                    / f"{w['traffic']}.json").read_text()),
                chips=w["chips"], end_to_end=e2e, per_layer=per_layer,
                limits=json.loads((bench / "limits"
                                   / f"{workload}.json").read_text()))


def load_reader(metric: str, root: Path = ROOT):
    """The reader of a metric: `metrics/<metric>.py`'s `read`."""
    path = root / BENCH.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --- the program side -----------------------------------------------------

def model_fields(cfg: Dict) -> Dict:
    """The configuration's ModelConfig fields (tuples where the dataclass
    holds tuples)."""
    from omni_pq_torch.config import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in cfg.items() if k in names}


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
    """The system under test on one cell: the port's model (and, for a
    train cell, its TrainState and step), fed from the pool."""

    def __init__(self, cell: Cell, seed: int, device, pool, fault=None,
                 marks=None):
        import torch
        from . import weights
        from omni_pq_torch import infer
        from omni_pq_torch.config import ModelConfig
        self.cell, self.device, self.pool = cell, device, pool
        self.kind = cell.traffic["kind"]
        self.mc = ModelConfig(**model_fields(cell.cfg))
        marks = [] if marks is None else marks
        sd = weights.state_dict(cell.cfg, seed, device)
        sync(device)
        marks.append(("weights", time.perf_counter()))
        self.model = infer.load_model(sd, self.mc, device)
        sync(device)
        marks.append(("model", time.perf_counter()))
        self.fault = fault
        self.i = 0
        if self.kind == "train":
            from omni_pq_torch.config import DatasetConfig
            from omni_pq_torch.train.state import OptimizerConfig, TrainState
            from omni_pq_torch.train.step import TrainFlags, make_train_step
            flags = TrainFlags(**cell.traffic["flags"])
            self.state = TrainState(
                self.model, OptimizerConfig(**cell.traffic["optimizer"]),
                ema=flags.ema)
            self.step_fn = make_train_step(self.model, self.mc,
                                           DatasetConfig().mean_size_arr,
                                           flags)
            self.gen = torch.Generator(device=device).manual_seed(
                sub_seed(seed, 3))
            self.initial = {k: v.detach().clone() for k, v in sd.items()}
            marks.append(("train state", time.perf_counter()))
        del sd

    # one call of the timed entry point
    def call(self):
        from omni_pq_torch import infer
        entry = self.pool[self.i % len(self.pool)]
        self.i += 1
        if self.kind == "eval":
            pc = entry["point_clouds"]
            if self.fault is not None:
                return self.fault(infer.eval_forward, self.model, pc)
            return infer.eval_forward(self.model, pc)
        labeled, weak = entry["labeled"], entry.get("weak")
        step = self.step_fn
        if self.fault is not None:
            return self.fault(step, self.state, labeled, weak, self.gen,
                              self.cell.traffic["consistency_weight"])
        return step(self.state, labeled, weak, self.gen,
                    self.cell.traffic["consistency_weight"])

    def first_steps(self) -> Dict:
        """Train: the first CHECK_STEPS steps through the window's own call,
        with the readings the reference is held to: each step's loss (and
        the first step's vote loss, which no sampling of votes reaches), each
        leaf's first gradient as AdamW got it (mu / (1 - b1) after one
        step), each leaf's change after the first step and after the last
        (student and teacher parameters, BatchNorm running statistics), and
        the generator's state after each step."""
        import torch
        losses, grad, first_change, draws = [], None, None, []
        for k in range(CHECK_STEPS):
            stats = self.call()
            losses.append(float(stats["total_loss"]))
            draws.append(generator_state(self.gen))
            if k == 0:
                first_vote = float(stats["vote_loss"])
                opt = self.state.optimizer
                grad = leaf_norms({n: opt.state[p]["mu"] / 0.1
                                   for n, p in self.model.named_parameters()
                                   if "mu" in opt.state[p]})
                with torch.no_grad():
                    first_change = state_change(
                        self.model, self.state.ema_model, self.initial)
        with torch.no_grad():
            change = state_change(self.model, self.state.ema_model,
                                  self.initial)
        del self.initial
        return {"losses": losses, "grad": grad, "change": change,
                "first_change": first_change, "draws": draws,
                "first_vote_loss": first_vote}

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
                losses.append(self.call()["total_loss"])
                w.calls += 1
            sync(dev)
            w.failed = int((~torch.isfinite(torch.stack(losses))).sum())
        w.seconds = time.perf_counter() - t0
        w.scenes = w.calls * scenes_per_call(self.cell.traffic)
        if cuda:
            w.peak_bytes = torch.cuda.max_memory_allocated()
        return w, kept

    def free(self):
        for name in ("model", "state", "step_fn", "pool", "gen"):
            if hasattr(self, name):
                delattr(self, name)


def scenes_per_call(traffic: Dict) -> int:
    """Rooms a call takes: an eval batch, or a step's labeled + weak."""
    if traffic["kind"] == "eval":
        return traffic["batch"]
    return traffic["labeled"] + traffic["weak"]


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def leaf_norms(tensors: Dict) -> Dict[str, float]:
    import torch
    names = list(tensors)
    if not names:
        return {}
    norms = torch.stack([torch.linalg.vector_norm(tensors[n].double())
                         for n in names]).cpu().tolist()
    return dict(zip(names, norms))


def generator_state(gen) -> str:
    """A digest of a generator's state: equal after two runs of steps
    exactly when they drew the same amounts in the same order."""
    import hashlib
    return hashlib.sha256(gen.get_state().numpy().tobytes()).hexdigest()


def state_change(model, teacher, initial: Dict) -> Dict[str, Dict]:
    """Norms of each leaf's change from `initial`: the student's and the
    teacher's parameters, and their BatchNorm running statistics."""
    out = {}
    for side, m in (("student", model), ("teacher", teacher)):
        if m is None:
            continue
        out[f"{side}.params"] = leaf_norms(
            {n: p.detach() - initial[n] for n, p in m.named_parameters()})
        out[f"{side}.bn"] = leaf_norms(
            {n: b - initial[n] for n, b in m.named_buffers()
             if n.endswith(("running_mean", "running_var"))})
    return out


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
    from . import check as checker
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
        numbers = checker.check_eval(cell.cfg, seed, device, clouds, out)
    else:
        batches = [pool[k % len(pool)] for k in range(CHECK_STEPS)]
        prog.free()
        del pool
        gc.collect()
        numbers = checker.check_train(cell.cfg, cell.traffic, seed, device,
                                      batches, readings)
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
        """The batch of each model forward in one call: a train step with
        an EMA teacher runs two."""
        t = self.cell.traffic
        if self.kind == "eval":
            return [t["batch"]]
        return [self.batch] * (2 if t["flags"].get("ema", True) else 1)


def p95(values: List[float]) -> float:
    """The 95th percentile, by linear interpolation between order
    statistics (statistics.quantiles' inclusive method)."""
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def emit(result: Dict) -> None:
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
