"""`portbench/spans.py` and the five readers of the program's spans on
synthetic records: the numbers a step, a window traced twice, and None on
eval cells, untraced runs and without records."""
import types

import pytest

import pb_small  # noqa: F401  (the repo root on sys.path)
from omni_pq_torch.utils.trace import Record
from portbench import harness, spans

READERS = ("forward_host_ms.train", "losses_host_ms.train",
           "backward_host_ms.train", "update_host_ms.train",
           "allocs_per_step.train")
MS = 1_000_000


def ctx_of(workload, traced=True, calls=3):
    cell = harness.find_cell(harness.load_spec(), workload)
    return harness.Context(cell=cell, window=harness.Window(), setup_s=1.0,
                           trace=types.SimpleNamespace(calls=calls)
                           if traced else None)


def one_step(first_id, t, allocations):
    """The records of one step from `t` ns: forward.student 100 ms,
    forward.teacher 50, losses 30, backward 20, update 10 with a nested
    update.ema 4 ms; train.step with its allocations."""
    out, ids = [], iter(range(first_id, first_id + 10))
    top = next(ids)
    t0 = t
    for name, ms in (("step.forward.student", 100),
                     ("step.forward.teacher", 50), ("step.losses", 30),
                     ("step.backward", 20), ("step.update", 10)):
        out.append(Record(name, next(ids), top, top, 1, t, t + ms * MS,
                          {"allocations": 7}))
        t += ms * MS
    out.append(Record("update.ema", next(ids), top, top, 1, t - 5 * MS,
                      t - MS, {}))
    out.append(Record("train.step", top, 0, top, 1, t0, t + MS,
                      {"allocations": allocations}))
    return out


def window(steps, allocs=(1000, 2000, 3000, 4000, 5000, 6000)):
    recs = []
    for k in range(steps):
        recs += one_step(100 * k + 1, k * 10 ** 9, allocs[k])
    return recs


@pytest.fixture
def with_records(monkeypatch):
    def use(recs):
        monkeypatch.setattr(spans, "records", lambda: recs)
    return use


def read_all(ctx):
    return {n: harness.load_reader(n)(ctx) for n in READERS}


def test_numbers_a_step(with_records):
    with_records(window(3))
    got = read_all(ctx_of("semi_3p3.bf16"))
    assert got == {"forward_host_ms.train": 150.0,
                   "losses_host_ms.train": 30.0,
                   "backward_host_ms.train": 20.0,
                   "update_host_ms.train": 10.0,
                   "allocs_per_step.train": 2000.0}


def test_a_window_traced_again_counts_its_steps(with_records):
    """Two traced windows of 3 calls: 6 `train.step` records; the sums are
    divided by 6, not by the 3 calls of the window."""
    with_records(window(6))
    got = read_all(ctx_of("sup_b3.f32fused", calls=3))
    assert got["forward_host_ms.train"] == 150.0
    assert got["update_host_ms.train"] == 10.0
    assert got["allocs_per_step.train"] == 3500.0


def test_none_on_eval_cells_untraced_runs_and_without_records(with_records):
    with_records(window(3) + [Record("eval.forward", 999, 0, 999, 1, 0,
                                     MS, {})])
    for ctx in (ctx_of("eval_b16.bf16"), ctx_of("eval_b16.f32fused"),
                ctx_of("semi_3p3.bf16", traced=False)):
        assert set(read_all(ctx).values()) == {None}
    with_records([])
    assert set(read_all(ctx_of("semi_3p3.bf16")).values()) == {None}
    # a program without the counter (a run off the card): no allocations
    with_records([r._replace(counters={}) for r in window(3)])
    got = read_all(ctx_of("semi_3p3.bf16"))
    assert got["allocs_per_step.train"] is None
    assert got["losses_host_ms.train"] == 30.0


def test_a_program_without_the_trace_module_gives_none(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_trace(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "omni_pq_torch.utils" and "trace" in (fromlist or ()):
            raise ImportError("no trace module")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_trace)
    assert spans.records() == []
    assert set(read_all(ctx_of("semi_3p3.bf16")).values()) == {None}


def test_the_five_metrics_read_only_the_train_cells():
    spec = harness.load_spec()
    mine = {m["name"]: m for m in spec["per_layer"] if m["name"] in READERS}
    assert set(mine) == set(READERS)
    for m in mine.values():
        assert m["workloads"] == ["semi_3p3.bf16", "sup_b3.f32fused"]
        assert (m["better"], m["source"], m["moves"]) == (
            "lower", "device_trace", "train_scenes_per_s")
