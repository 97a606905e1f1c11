"""The train step's captured CUDA graph (`train.step.make_train_step`).

On the CPU: the device-scalar buffer (`train.state.StepScalars`) holds
bitwise the host formulas of the learning rates, the bias corrections and
the EMA's alpha, for the first 1000 steps and at `total_steps`; the ops
that read its 0-dim tensors give bitwise what they give with the Python
scalars; the rule that keeps a step eager (off a card, inside a
data-parallel context, with step_freq > 1) and the key of the batches.

On a card (marked `cuda`, skipped without one; run with the card tests,
`python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_port_graph.py`): for the flag sets of the benchmark's two
train cells (the semi-supervised step in bfloat16, the supervised step on
the fused float32 kernels) at the published widths, 10 steps through the
graphs: 5 of one batch size (2 eager warm-ups, the capture, 2 replays), 3
of another (its own warm-ups and graph, in the same memory pool), then 2
more replays of the first graph. Each step is held against an eager step
from the same state and generator state (two sound runs part after one
step: the backward's atomics and AdamW's sign-like steps), with a schedule
(cosine over 5 steps) and a consistency weight that change every step by
far more than the limits, so a graph that froze a step scalar fails: the
generator's state bitwise equal after every step, the total loss and the
weighted consistency loss within the semi cell's `first_loss_gap`, every
parameter's and BatchNorm statistic's change (the EMA replica's too)
within the cell's `first_change_gap` and the AdamW moments within the semi
cell's `grad_gap` (`portbench/limits/`), distinct returned loss tensors,
the host counters advanced once a call, the kernels' wrappers called in
the eager and capturing calls alone, and, in a profile of a replayed call,
its `train.step` span's `graph_replays` 1 and as many FPS and ball-query
kernels on the card as an eager step launches.
"""
import copy
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from omni_pq_torch import ops, parallel
from omni_pq_torch.train import (SUPERVISED, OptimizerConfig, TrainFlags,
                                 TrainState, make_train_step, warmup_cosine)
from omni_pq_torch.train.state import (AdamW, StepScalars, _bias_correction,
                                       ema_alpha)
from omni_pq_torch.train.step import batch_key, captures

LIMITS = Path(__file__).resolve().parents[1] / "portbench" / "limits"


class _TwoGroups(torch.nn.Module):
    """One 'base' and one 'decoder' parameter group."""

    def __init__(self, dtype):
        super().__init__()
        self.backbone = torch.nn.Linear(4, 3).to(dtype)
        self.decoder_layer0 = torch.nn.Linear(3, 2).to(dtype)


def _bits(x) -> int:
    return int(np.float64(x).view(np.int64))


# -- the scalars' buffer (CPU) -------------------------------------------------

@pytest.mark.parametrize("warmup", [0, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_step_scalars_hold_the_host_formulas(dtype, warmup):
    total = 100000
    cfg = OptimizerConfig(total_steps=total, warmup_steps=warmup)
    opt = AdamW(_TwoGroups(dtype).named_parameters(), cfg)
    scheds = {n: warmup_cosine(lr, total, warmup) for n, lr in
              (("base", cfg.learning_rate),
               ("decoder", cfg.decoder_learning_rate))}
    scalars = None
    for count in [*range(1001), total - 1, total]:
        opt.count = count
        values = {**opt.step_values(), **TrainState.ema_values(0.999, count)}
        if scalars is None:
            scalars = StepScalars(values, "cpu")
        scalars.fill(values)
        got = dict(zip(scalars.names, scalars.buffer.tolist()))
        want = {"ema.alpha": float(min(
            np.float32(1.0) - np.float32(1.0)
            / (np.float32(count) + np.float32(1.0)), np.float32(0.999)))}
        want["ema.one_minus_alpha"] = 1.0 - want["ema.alpha"]
        for name, sched in scheds.items():
            want[f"{name}.neg_lr"] = -sched(count)
            want[f"{name}.bc1"] = _bias_correction(0.9, count + 1, dtype)
            want[f"{name}.bc2"] = _bias_correction(0.999, count + 1, dtype)
        assert {k: _bits(v) for k, v in got.items()} == {
            k: _bits(v) for k, v in want.items()}, count
        assert ema_alpha(0.999, count) == want["ema.alpha"]
        for name, v in want.items():  # an op's cast of a Python scalar
            assert scalars.read(name, dtype).item() == float(
                torch.tensor(v, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ops_round_the_buffer_as_python_scalars(dtype):
    """The AdamW, EMA and consistency ops on 0-dim tensors of the buffer
    give bitwise what they give on the Python scalars."""
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(7, 5, generator=g, dtype=dtype) for _ in range(3)]
    ys = [torch.randn(7, 5, generator=g, dtype=dtype) for _ in range(3)]
    values = {"bc": _bias_correction(0.999, 3, dtype),
              "neg_lr": -warmup_cosine(2e-3, 100000)(7),
              "alpha": ema_alpha(0.999, 5), "one_minus_alpha":
              1.0 - ema_alpha(0.999, 5), "cw": 0.05 * float(np.exp(-2.3))}
    s = StepScalars.holding(values, "cpu")

    def same(a, b):
        for u, v in zip(a, b):
            assert torch.equal(u, v)

    same(torch._foreach_div(xs, s.read("bc", dtype)),
         torch._foreach_div(xs, values["bc"]))
    same(torch._foreach_mul(xs, s.read("neg_lr", dtype)),
         torch._foreach_mul(xs, values["neg_lr"]))
    same([s.read("alpha", dtype) * x + s.read("one_minus_alpha", dtype) * y
          for x, y in zip(xs, ys)],
         [values["alpha"] * x + (1.0 - values["alpha"]) * y
          for x, y in zip(xs, ys)])
    loss = xs[0].sum()
    assert torch.equal(loss * s.read("cw", loss.dtype), loss * values["cw"])


def test_fill_takes_every_name_and_no_other():
    s = StepScalars(["a", "b"], "cpu")
    s.fill({"a": 1.0, "b": 2.0})
    with pytest.raises(KeyError):
        s.fill({"a": 1.0})
    with pytest.raises(KeyError):
        s.fill({"a": 1.0, "b": 2.0, "c": 3.0})
    assert s.buffer.tolist() == [1.0, 2.0]


# -- where the graph is used (CPU) -------------------------------------------

@pytest.mark.parametrize("step_freq", [1, 2, 4])
def test_mini_steps_and_data_parallel_stay_eager(step_freq):
    card = torch.device("cuda")
    state = TrainState(_TwoGroups(torch.float32),
                       OptimizerConfig(step_freq=step_freq))
    assert captures(card, state) == (step_freq == 1)
    assert not captures(torch.device("cpu"), state)
    with parallel.using(object()):  # any active data-parallel context
        assert not captures(card, state)
    assert captures(card, state) == (step_freq == 1)


def test_batch_key_follows_names_shapes_and_dtypes():
    cpu = torch.device("cpu")
    lab = {"point_clouds": torch.zeros(3, 8, 3), "n": torch.zeros(3).long()}
    key = batch_key(cpu, lab, None)
    assert key == batch_key(cpu, {k: v.clone() for k, v in lab.items()},
                            None)
    assert key != batch_key(cpu, {**lab, "point_clouds": torch.zeros(2, 8, 3)},
                            None)
    assert key != batch_key(cpu, {**lab, "n": torch.zeros(3)}, None)
    assert key != batch_key(cpu, None, lab)   # the weak batch's place
    assert batch_key(cpu, {**lab, "name": "scene0000_00"}, None) is None
    assert batch_key(torch.device("cuda"), lab, None) is None


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# the benchmark's two train cells by their limits' names: (ModelConfig
# fields, flags, labeled scenes, weak scenes)
CELLS = {
    "semi_3p3.bf16": (dict(compute_dtype="bfloat16"), TrainFlags(), 3, 3),
    "sup_b3.f32fused": (dict(fused_sa=True), SUPERVISED, 3, 0),
}


ROUNDOFF_LEAF = 1e-3  # the benchmark's: leaves whose gradient is noise


def _groups(state) -> dict:
    """{group: {leaf: tensor}} of everything a step writes: the student's
    and the teacher's parameters and BatchNorm statistics, and the AdamW
    moments."""
    out = {}
    models = {"student": state.model, "teacher": state.ema_model}
    for side, m in models.items():
        if m is not None:
            out[f"{side}.params"] = dict(m.named_parameters())
            out[f"{side}.bn"] = {n: b for n, b in m.named_buffers()
                                 if b.is_floating_point()}
    opt = state.optimizer
    for k in ("mu", "nu"):
        out[k] = {n: opt.state[p][k] for n, p in
                  state.model.named_parameters() if k in opt.state[p]}
    return {g: {n: t.detach().clone() for n, t in leaves.items()}
            for g, leaves in out.items()}


def _norms(leaves, base=None) -> dict:
    return {n: float(torch.linalg.vector_norm(
        (t - base[n] if base is not None else t).double()))
        for n, t in leaves.items()}


def _step_gaps(got, want, before) -> dict:
    """The benchmark's gaps of one step from one state, by group: the
    worst leaf's | |got| - |want| | over the larger of the want leaf's norm
    and the median leaf's, of each leaf's change (the moments: of the leaf),
    the student's parameters only where they move (gradient, as AdamW got
    it, above a thousandth of the median leaf's)."""
    grad = _norms({n: (want["mu"][n] - 0.9 * before["mu"].get(n, 0.0)) / 0.1
                   for n in want["mu"]})
    med = float(np.median(list(grad.values())))
    moving = {n for n, v in grad.items() if v >= ROUNDOFF_LEAF * med}
    out = {}
    for group, leaves in want.items():
        base = None if group in ("mu", "nu") else before[group]
        w, g = _norms(leaves, base), _norms(got[group], base)
        names = [n for n in w if group != "student.params" or n in moving]
        m = float(np.median([w[n] for n in names]))
        out[group] = max(abs(g[n] - w[n]) / max(w[n], m, 1e-30)
                         for n in names)
    return out


@torch.no_grad()
def _copy_state(src, dst) -> None:
    """`dst` takes `src`'s state in place: parameters, buffers, AdamW
    moments, the EMA replica, the counters."""
    for a, b in ((dst.model, src.model), (dst.ema_model, src.ema_model)):
        if a is not None:
            for x, y in zip(a.state_dict().values(),
                            b.state_dict().values()):
                x.copy_(y)
    for pa, pb in zip(dst.model.parameters(), src.model.parameters()):
        st = dst.optimizer.state[pa]
        for k, v in src.optimizer.state[pb].items():
            if k in st:
                st[k].copy_(v)
            else:
                st[k] = v.clone()
    dst.step, dst.optimizer.count = src.step, src.optimizer.count


# the kernel wrappers that count their launches (`.launches`)
COUNTED = ("fps", "ball_query", "ball_query_group", "ball_query_group_feats",
           "fused_mlp_pool")


def _launches() -> dict:
    return {k: getattr(ops, k).launches for k in COUNTED}


def _replay_profile(run) -> tuple:
    """The `graph_replays` counters of the `train.step` spans of one call
    of `run` under torch.profiler, and the FPS and ball-query kernels that
    ran on the card: ([counter, ...], {kernel: launches})."""
    from torch.profiler import ProfilerActivity, profile
    from omni_pq_torch.utils import trace
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    replays = [r.counters.get("graph_replays") for r in trace.records()
               if r.name == "train.step"]
    trace.clear()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = {k: sum(1 for n in names if re.search(rf"::{k}\b", n))
               for k in ("fps_kernel", "ball_query_kernel")}
    return out, replays, kernels


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_replayed_steps_equal_eager_steps(dev, cell):
    """Before each step the eager state takes the graph's state and
    generator, so each step is compared from one state: the draws bitwise,
    the loss within the semi cell's `first_loss_gap`, every parameter's and
    BatchNorm statistic's change within the cell's `first_change_gap`, the
    AdamW moments within the semi cell's `grad_gap` (what the benchmark
    holds one step to: the backward's atomics reach AdamW's sign-like
    steps). The learning rate falls from 0.65 to 0.35 to 0.10 of its base
    over the first graph's capture and replays, the EMA's alpha and the
    bias corrections move with the step and the consistency weight doubles
    and halves: a stale scalar moves a change or a loss past its limit."""
    from omni_pq_torch.config import SCANNET_MEAN_SIZES, ModelConfig
    from omni_pq_torch.data import make_batch
    from omni_pq_torch.infer import build_model
    from omni_pq_torch.train import batch_to_tensors
    fields, flags, n_lab, n_weak = CELLS[cell]
    limits = json.loads((LIMITS / f"{cell}.json").read_text())
    semi = json.loads((LIMITS / "semi_3p3.bf16.json").read_text())
    cfg = ModelConfig(**fields)
    model = build_model(cfg, dev, seed=7)
    opt_cfg = OptimizerConfig(total_steps=5)
    states = [TrainState(m, opt_cfg, ema=flags.ema)
              for m in (model, copy.deepcopy(model))]
    rng = np.random.default_rng(11)

    def batches(n_lab, n_weak):
        return (batch_to_tensors(make_batch(rng, n_lab, cfg.num_points), dev),
                batch_to_tensors(make_batch(rng, n_weak, cfg.num_points), dev)
                if n_weak else None)

    pool = [batches(n_lab, n_weak) for _ in range(3)]
    other = [batches(n_lab - 1, max(n_weak - 1, 0)) for _ in range(3)]
    gens = [torch.Generator(dev).manual_seed(5) for _ in states]
    graph_step = make_train_step(states[0].model, cfg, SCANNET_MEAN_SIZES,
                                 flags)

    def both(k, lab, weak, replayed):
        """One step of each side from the graph side's state."""
        _copy_state(states[0], states[1])
        gens[1].set_state(gens[0].get_state())
        before = _groups(states[0])
        cw = 0.05 * 2.0 ** (k % 3 - 1)
        start = _launches()
        run = lambda: graph_step(states[0], lab, weak, gens[0], cw)
        if k == 3:  # a replayed call, profiled
            got, replays, kernels = _replay_profile(run)
            assert replays == [1], replays
        else:
            got = run()
        graph_launches = {n: v - start[n] for n, v in _launches().items()}
        start = _launches()
        # a step function of its own for each eager step: its first call
        want = make_train_step(states[1].model, cfg, SCANNET_MEAN_SIZES,
                               flags)(states[1], lab, weak, gens[1], cw)
        eager = {n: v - start[n] for n, v in _launches().items()}
        assert sum(eager.values()) > 0
        assert graph_launches == (dict.fromkeys(COUNTED, 0) if replayed
                                  else eager), (k, graph_launches, eager)
        if k == 3:
            assert kernels == {"fps_kernel": eager["fps"],
                               "ball_query_kernel":
                               eager["ball_query_group"]}, kernels
        assert torch.equal(gens[0].get_state(), gens[1].get_state()), k
        for s in states:
            assert s.step == s.optimizer.count == k + 1
        assert set(got) == set(want)
        for name in ("total_loss", "weighted_consistency_loss"):
            if name in want:
                g, w = float(got[name]), float(want[name])
                assert abs(g - w) <= semi["first_loss_gap"] * abs(w), (
                    k, name, g, w)
        gaps = _step_gaps(_groups(states[0]), _groups(states[1]), before)
        print(f"{cell} step {k + 1}: loss {float(got['total_loss'])} / "
              f"{float(want['total_loss'])}; gaps {gaps}")
        assert all(v <= (semi["grad_gap"] if group in ("mu", "nu")
                         else limits["first_change_gap"])
                   for group, v in gaps.items()), (k, gaps)
        return got["total_loss"]

    losses = [both(k, *pool[k % len(pool)], replayed=k >= 3)
              for k in range(5)]
    # a batch of another size: its own warm-ups and graph, then the first
    # graph again, its memory pool shared with the second's
    losses += [both(5 + k, *other[k], replayed=False) for k in range(3)]
    losses += [both(8 + k, *pool[k], replayed=True) for k in range(2)]
    assert len({id(t) for t in losses}) == len(losses)
    assert len({float(t) for t in losses}) == len(losses)
