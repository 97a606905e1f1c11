"""The port's spans (`omni_pq_torch.utils.trace`) on the CPU.

Off (no profiler) a span is the shared no-op and records nothing. Under a
CPU torch.profiler, one semi-supervised step of the --smoke model records
`train.step` with its phases, each phase's own spans under it, and the four
phases cover at least 95 % of the step's host time; every record's
[t0_ns, t1_ns] lies within 50 us of its record_function event on the
profiler's clock (beyond the steps of a host wall clock that a virtual
machine steps now and then, which the profiler's clock spreads out); `eval_forward` records `eval.forward` with the model's
stages, and the decoder's blocks and heads under `model.decoder`; a span on a second thread keeps its own parent stack; a full
buffer drops records and counts them. Torch at one intra-op thread.
"""
import gc
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from omni_pq_torch.config import SCANNET_MEAN_SIZES, SMOKE_MODEL, ModelConfig
from omni_pq_torch.data import make_batch
from omni_pq_torch.infer import build_model, eval_forward
from omni_pq_torch.train import (OptimizerConfig, TrainFlags, TrainState,
                                 batch_to_tensors, make_train_step)
from omni_pq_torch.utils import trace

CFG = ModelConfig(**{**SMOKE_MODEL, "num_points": 512})
PHASES = ("step.forward.student", "step.forward.teacher", "step.losses",
          "step.backward", "step.update")
STAGES = ("model.backbone", "model.vote", "model.proposal", "model.decoder")
DECODER = ("decoder.self_attention", "decoder.cross_attention", "decoder.ffn",
           "decoder.object_head", "decoder.quad_head")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.clear()
    yield
    trace.clear()
    torch.set_num_threads(threads)


def _events(prof):
    """{name: [(start_ns, end_ns), ...]} of the profiler's host events."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        out.setdefault(ev.name(), []).append(
            (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return out


@pytest.fixture(scope="module")
def semi_step():
    """(records, host events) of one profiled semi-supervised step, after
    an unprofiled one, and of an eval forward after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = build_model(CFG, "cpu", seed=1)
        state = TrainState(model, OptimizerConfig(), ema=True)
        step = make_train_step(model, CFG, SCANNET_MEAN_SIZES, TrainFlags())
        lab, weak = (batch_to_tensors(make_batch(np.random.default_rng(s), 2,
                                                 CFG.num_points), "cpu")
                     for s in (4, 5))
        gen = torch.Generator().manual_seed(0)
        step(state, lab, weak, gen, 0.05)
        assert trace.records() == []
        trace.clear()
        gc.disable()  # a collection inside a span's exit would blur its clock
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                step(state, lab, weak, gen, 0.05)
                model.eval()
                eval_forward(model, lab["point_clouds"])
        finally:
            gc.enable()
        recs = trace.records()
        trace.clear()
        return recs, _events(prof)
    finally:
        torch.set_num_threads(threads)


def test_off_records_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span("step.losses") is trace.OFF
    assert trace.span("train.step", torch.device("cpu")) is trace.OFF
    with trace.span("step.losses") as s:
        assert s is trace.OFF
    eval_forward(build_model(CFG, "cpu", seed=1),
                 make_batch(np.random.default_rng(0), 1,
                            CFG.num_points)["point_clouds"])
    assert trace.records() == [] and trace.dropped() == 0


def test_semi_step_records_its_phases_under_train_step(semi_step):
    recs, _ = semi_step
    step = [r for r in recs if r.name == "train.step"]
    assert len(step) == 1
    step = step[0]
    assert step.parent == 0 and step.top == step.id
    by_id = {r.id: r for r in recs}
    children = {r.name: r for r in recs if r.parent == step.id}
    assert set(children) == set(PHASES)
    mine = [r for r in recs if r.top == step.id]
    for r in mine:
        assert r.t0_ns <= r.t1_ns
        if r is not step:
            parent = by_id[r.parent]
            assert parent.t0_ns <= r.t0_ns and r.t1_ns <= parent.t1_ns
    parent_of = {r.name: by_id[r.parent].name for r in mine if r.parent}
    for name in ("losses.supervised", "losses.gamma", "losses.consistency"):
        assert parent_of[name] == "step.losses"
    for name in ("update.grad_norm", "update.adamw", "update.ema"):
        assert parent_of[name] == "step.update"
    assert "losses.arkit" not in parent_of      # flags.arkit is off
    forwards = [r for r in mine if r.name in STAGES]
    assert sorted(by_id[r.parent].name for r in forwards) == sorted(
        ["step.forward.student"] * 4 + ["step.forward.teacher"] * 4)
    assert all(r.counters == {} for r in recs)  # no CUDA device
    covered = sum(children[n].t1_ns - children[n].t0_ns for n in PHASES)
    assert covered >= 0.95 * (step.t1_ns - step.t0_ns)


def realtime_step_ns(seconds=0.3):
    """The largest step of the host's wall clock (`time.time_ns()`) against
    its monotonic clock over `seconds`: 0 on a host whose wall clock runs
    smoothly. A virtual machine may step its wall clock now and then; the
    profiler's clock spreads such steps over its window."""
    m0, r0 = time.monotonic_ns(), time.time_ns()
    end, prev, step = m0 + int(seconds * 1e9), 0, 0
    while True:
        m, r = time.monotonic_ns(), time.time_ns()
        d = (r - r0) - (m - m0)
        step = max(step, abs(d - prev) if abs(d - prev) > 20_000 else 0)
        prev = d
        if m >= end:
            return step


def test_records_match_their_profiler_events(semi_step):
    """Within 50 us, beyond any step of the host's wall clock."""
    recs, events = semi_step
    assert len(recs) >= 25
    limit = 50_000 + realtime_step_ns()
    for r in recs:
        gap = min(max(abs(s - r.t0_ns), abs(e - r.t1_ns))
                  for s, e in events[r.name])
        assert gap <= limit, (r.name, gap, limit)


def test_eval_forward_records_the_model_stages(semi_step):
    recs, _ = semi_step
    ev = [r for r in recs if r.name == "eval.forward"]
    assert len(ev) == 1 and ev[0].parent == 0
    stages = [r for r in recs if r.parent == ev[0].id]
    assert sorted(r.name for r in stages) == sorted(STAGES)
    decoder = [r for r in stages if r.name == "model.decoder"][0]
    layers = [r.name for r in recs if r.parent == decoder.id]
    assert sorted(set(layers)) == sorted(DECODER)
    assert len(layers) == len(DECODER) * CFG.num_decoder_layers
    assert all(r.top == ev[0].id for r in recs if r.parent == decoder.id)


def test_a_second_thread_keeps_its_own_stack():
    opened, done = threading.Event(), threading.Event()
    got = {}

    def worker():
        opened.wait()
        with trace.span("worker.outer"):
            with trace.span("worker.inner"):
                pass
        got["thread"] = threading.get_ident()
        done.set()

    t = threading.Thread(target=worker)
    with profile(activities=[ProfilerActivity.CPU]):
        t.start()
        with trace.span("main.outer"):
            opened.set()
            done.wait()
        t.join()
    recs = {r.name: r for r in trace.records()}
    assert set(recs) == {"worker.outer", "worker.inner", "main.outer"}
    main, outer, inner = (recs[n] for n in ("main.outer", "worker.outer",
                                            "worker.inner"))
    assert main.parent == 0 and outer.parent == 0
    assert outer.top == outer.id and inner.parent == outer.id
    assert inner.top == outer.id
    assert outer.thread == inner.thread == got["thread"] != main.thread
    assert main.t0_ns < outer.t0_ns and outer.t1_ns < main.t1_ns


def test_a_full_buffer_drops_and_counts(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for name in ("a", "b", "c", "d", "e"):
            with trace.span(name):
                pass
    assert [r.name for r in trace.records()] == ["a", "b", "c"]
    assert trace.dropped() == 2
    trace.clear()
    assert trace.records() == [] and trace.dropped() == 0


def test_threads_filling_the_buffer_lose_no_count(monkeypatch):
    """More threads than cores close spans into a buffer capped below their
    total, with a short switch interval: the buffer holds exactly the cap,
    and the drops make up the rest."""
    workers, each = 2 * (os.cpu_count() or 1) + 2, 200
    monkeypatch.setattr(trace, "CAP", workers * each // 3)
    start = threading.Barrier(workers)

    def worker():
        start.wait(timeout=60)
        for _ in range(each):
            with trace.span("stress"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=worker)
                       for _ in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(trace.records()) == trace.CAP
    assert trace.dropped() == workers * each - trace.CAP
