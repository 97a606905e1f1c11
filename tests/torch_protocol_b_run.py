"""Protocol B's resume in both packages (tests/test_torch_port_protocol_b.py).

Run from the repo root as `JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python -m
tests.torch_protocol_b_run OUT.json`, in its own process: 64-bit types are a
process-wide switch of JAX. For each of `gamma_ft` and `arkit_centered_ft`
it runs P=3 supervised steps, the teacher backfill and S=4 steps of the arm
in the JAX package (its float64 route under `oracle_model_ops()`) and in
the port (its float64 route), on the same scenes, and writes, for every
step, each check's worst gap over its bound (a ratio: <= 1 passes) with the
tensor where it is worst. It also runs the port twice more against the same
JAX trajectory, with the backfill skipped and with the EMA step counter
reset at the resume (the controls).

Each package runs its driver's own pieces:
- JAX: scripts/semi_sup_ab.py imported by path with AB_* set (it does no
  work at import): its ARM_FLAGS, its pool protocol (`_center_pool`, the
  QUAD_GT_KEYS zeroing; run_arm :234-248), its optimiser (run_arm:
  total_steps=AB_STEPS, learning rate 2e-3, ema=True), its consistency
  schedule (:267-270), its key chain (make_fused_step: key, k1, k2, k_step
  = split(key, 4)) and its backfill (:287-294, inline in run_arm, so
  repeated here as written there), on make_train_step(ARM_FLAGS["sup"])
  and make_train_step(ARM_FLAGS[arm]);
- the port: omni_pq_torch.experiments.semi_sup_ab's ARM_FLAGS, arm_pools,
  cw_schedule and ARM_KEY, and common.make_pool_step and
  common.backfill_teacher, on a TrainState as run_arm builds it.
The scenes of a step are those the port's pool step draws from its
generator; JAX is handed the same scenes (its driver draws them with
jax.random, which torch cannot replay). JAX's gamma draws are replayed into
the port (`choice=`), as in tests/test_torch_port_semi.py. The TINY model
runs at dropout 0 on 3 labeled and 3 weak synthetic rooms of 512 points,
B=2, from randomised weights whose last quad head is rigged so that the
gamma criterion engages. Both run the arm's flags with the fixed gamma
criterion (`use_fitted_mixture=False`; the driver's arms fit it): JAX's
float64 route cannot trace the fitted EM (its Newton loop carries a
float32 shape parameter against float64 distances, omni_pq_tpu/losses/
gamma.py:68, and `fori_loop` refuses the carry). The criterion is not the
resume's machinery, and tests/test_torch_port_semi.py holds the fitted one.

Why float64: float32 trajectories of the two frameworks part within one
step. Adam's first updates are lr * g / (|g| + eps), about lr * sign(g), for
every element, so an element whose gradient is float32 roundoff (a bias
before a train-mode BatchNorm, analytically zero) moves +-lr at random in
either package: after step 1, 75 % of `vote.conv1.bias` differed by more
than 1e-3 lr, and by step 2 the stats were 20x past the one-step tests'
bound, growing to ~1000x by step 6 (measured on this setup in float32).
No bound then separates a faithful port from one that resets the EMA
counter. In float64 both routes agree to ~1e-14 a step
(tests/test_torch_port_float64.py), so the gaps below stay near roundoff
for all 7 steps, and a fault of the resume shows as a gap orders of
magnitude past them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
import json
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from omni_pq_tpu.interop.oracle_ops import oracle_model_ops
from omni_pq_tpu.models import PQTransformer as JaxPQTransformer
from omni_pq_tpu.train import (create_train_state as jax_create_train_state,
                               make_train_step as jax_make_train_step)
from omni_pq_torch.config import SCANNET_MEAN_SIZES
from omni_pq_torch.experiments import common, semi_sup_ab
from omni_pq_torch.infer import load_model
from omni_pq_torch.interop import flax_to_state_dict
from omni_pq_torch.losses import gamma
from omni_pq_torch.train import (OptimizerConfig, TrainState, batch_to_tensors,
                                 make_train_step)
from omni_pq_torch.train import step as step_module
from tests.test_torch_port_modules import port_config, randomised_variables
from tests.test_torch_port_semi import _rig_last_quad_head, jax_choice
from tests.torch_float64_reference import CFG64, floats64, to64

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, S = 3, 4
STEPS = P + S
B = 2
N_LABELED, N_WEAK = 3, 3
SEED = 0
ARMS = ("gamma_ft", "arkit_centered_ft")
CONTROLS = ("skip_backfill", "reset_counter")
PORT_CFG = port_config(CFG64)
F64 = torch.float64
LR = 2e-3
DECAY = 0.999
# the teacher's carried bound is a sum of float64 gaps: this much absolute
# slack covers the EMA arithmetic's own rounding (~1e-17 a step)
TEACHER_SLACK = 1e-12


def load_jax_driver(out_json: str):
    """scripts/semi_sup_ab.py as a module, imported with AB_* set."""
    env = {"AB_STEPS": str(STEPS), "AB_PRETRAIN": str(P),
           "AB_SEEDS": str(SEED), "AB_ARMS": ",".join(ARMS),
           "AB_OUT": out_json}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        spec = importlib.util.spec_from_file_location(
            "_jax_script_semi_sup_ab", os.path.join(ROOT, "scripts",
                                                    "semi_sup_ab.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    assert (mod.STEPS, mod.PRETRAIN) == (STEPS, P)
    return mod


def load_pools():
    """The labeled and weak numpy pools: the drivers' rooms at TINY's
    points (common.load_pool is the JAX driver's load_pool at any size)."""
    return (common.load_pool(100 + SEED, N_LABELED, CFG64.num_points),
            common.load_pool(200 + SEED, N_WEAK, CFG64.num_points))


def float64_flags(flags):
    """The arm's flags with the fixed gamma criterion (the module
    docstring: JAX's float64 route cannot trace the fitted one)."""
    return dataclasses.replace(flags, use_fitted_mixture=False)


def make_jax_steps(jax_ab):
    """JAX's jitted functions, shared by both arms: the driver's inner
    steps and the train-mode forward whose quad scores JAX's gamma draw
    reads."""
    model = JaxPQTransformer(CFG64)
    flags = jax_ab.ARM_FLAGS
    steps = {base: jax_make_train_step(model, CFG64, SCANNET_MEAN_SIZES,
                                       float64_flags(flags[base]))
             for base in ["sup"] + [a[:-3] for a in ARMS]}

    @jax.jit
    def quad_scores(params, batch_stats, clouds, rng_drop):
        ep, _ = model.apply({"params": params, "batch_stats": batch_stats},
                            clouds, train=True, rngs={"dropout": rng_drop},
                            mutable=["batch_stats"])
        return ep["last_quad_scores"]
    return dict(model=model, steps=steps, quad_scores=quad_scores)


def initial_variables(pools):
    """Randomised float32 weights (BN noise included), the last quad head
    rigged so that the gamma criterion finds kept points
    (tests/test_torch_port_semi.py); both packages start from them cast to
    float64."""
    model = JaxPQTransformer(dataclasses.replace(CFG64,
                                                 compute_dtype="float32"))
    return _rig_last_quad_head(randomised_variables(
        model, pools[0]["point_clouds"][:B], seed=71))


def jax_pools(jax_ab, base, labeled, weak):
    """run_arm's pool protocol (:234-248), on the JAX driver's functions."""
    if base == "arkit_centered":
        labeled, weak = jax_ab._center_pool(labeled), jax_ab._center_pool(weak)
    if base in ("arkit", "arkit_centered"):
        weak = {k: (np.zeros_like(v) if k in jax_ab.QUAD_GT_KEYS else v)
                for k, v in weak.items()}
    return labeled, weak


def peek_draws(gen, semi):
    """The scenes `common.make_pool_step` draws next (labeled, weak; the
    labeled ones twice without a weak batch): its `draw`s on a copy of the
    generator."""
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    il = torch.randperm(N_LABELED, generator=g)[:B].numpy()
    iw = torch.randperm(N_WEAK, generator=g)[:B].numpy() if semi else il
    return il, iw


def port_draws(base):
    """Every step's scenes, from the port's generator as run_arm seeds it
    (the draws do not depend on the steps' arithmetic: at dropout 0 and
    with the gamma draw replayed the step draws nothing else)."""
    gen = torch.Generator().manual_seed(
        1009 * SEED + semi_sup_ab.ARM_KEY[base] + 7000)
    draws = []
    for i in range(STEPS):
        draws.append(peek_draws(gen, i >= P))
        for _ in range(2 if i >= P else 1):
            torch.randperm(N_LABELED, generator=gen)
    return draws


# -- the two packages' runs ---------------------------------------------------

def _merge_masked(trees):
    """One tree of the per-group optax trees (MaskedNode where a leaf
    belongs to the other group)."""
    return {k: next(t[k] for t in trees
                    if not isinstance(t[k], optax.MaskedNode))
            for k in trees[0]}


def jax_reading(state, names, bn_names):
    """A JAX train state in the port's names: the student, the teacher,
    their BN statistics, the AdamW moments, the step and update counts."""
    def sd(params, stats):
        d = flax_to_state_dict({"params": params, "batch_stats": stats})
        return {k: d[k].numpy() for k in names + bn_names}
    student = sd(state.params, state.batch_stats)
    teacher = sd(state.ema_params, state.ema_batch_stats)
    adam = [s.inner_state[0] for s in state.opt_state[1].inner_states.values()]
    counts = {int(a.count) for a in adam}
    assert len(counts) == 1
    mu = sd(_merge_masked([a.mu for a in adam]), state.batch_stats)
    nu = sd(_merge_masked([a.nu for a in adam]), state.batch_stats)
    return dict(params={k: student[k] for k in names},
                bn={k: student[k] for k in bn_names},
                ema_params={k: teacher[k] for k in names},
                ema_bn={k: teacher[k] for k in bn_names},
                mu={k: mu[k] for k in names}, nu={k: nu[k] for k in names},
                step=int(state.step), count=counts.pop())


def run_jax(arm, jax_ab, jax_steps, variables, pools, draws):
    """The JAX driver's protocol on the given scenes: its key chain, its
    schedule, its steps and its backfill, in float64. Returns per step
    (the state before it, its stats, the state after it, the gamma draw)."""
    base = arm[:-3]
    flags = jax_ab.ARM_FLAGS[base]
    labeled, weak = (floats64(p) for p in jax_pools(jax_ab, base, *pools))
    state = jax_create_train_state(
        to64(variables), jax_ab.OptimizerConfig(total_steps=STEPS,
                                                learning_rate=LR), ema=True)
    cw_sched = jnp.asarray([0.0] * P + [0.05] * (STEPS - P), jnp.float32)
    key = jax.random.PRNGKey(1009 * SEED + {"gamma": 3, "arkit_centered": 6}[
        base] + 7000)
    out = []
    for i, (il, iw) in enumerate(draws):
        if i == P:  # scripts/semi_sup_ab.py:287-294
            state = state.replace(
                ema_params=jax.tree.map(jnp.copy, state.params),
                ema_batch_stats=jax.tree.map(jnp.copy, state.batch_stats))
        key, _, _, k_step = jax.random.split(key, 4)
        semi = i >= P
        jl = {k: jnp.asarray(v[il]) for k, v in labeled.items()}
        jw = ({k: jnp.asarray(v[iw]) for k, v in weak.items()} if semi
              else jl)
        choice = None
        if semi and flags.gamma_mixture:
            rng_drop, _, rng_gamma = jax.random.split(k_step, 3)
            scores = jax_steps["quad_scores"](
                state.params, state.batch_stats,
                jnp.concatenate([jl["point_clouds"], jw["point_clouds"]]),
                rng_drop)
            choice = jax_choice(rng_gamma, np.asarray(scores)[B:],
                                CFG64.num_points)
        step = jax_steps["steps"][base if semi else "sup"]
        new_state, stats = step(state, jl, jw, k_step, cw_sched[i])
        out.append((state, jax.tree.map(np.asarray, stats), new_state,
                    choice))
        state = new_state
    return out


def port_reading(state):
    """The port's train state, as jax_reading's."""
    def arr(t):
        return t.detach().numpy().copy()
    params = dict(state.model.named_parameters())
    buffers = dict(state.model.named_buffers())
    ema_buffers = dict(state.ema_model.named_buffers())
    bn = [n for n in buffers if n.endswith(("running_mean", "running_var"))]
    opt = state.optimizer
    # (no moments before the first update: zeros, as optax's init)
    return dict(
        params={k: arr(v) for k, v in params.items()},
        bn={k: arr(buffers[k]) for k in bn},
        ema_params={k: arr(v) for k, v in
                    state.ema_model.named_parameters()},
        ema_bn={k: arr(ema_buffers[k]) for k in bn},
        mu={k: arr(opt.state[p].get("mu", torch.zeros_like(p)))
            for k, p in params.items()},
        nu={k: arr(opt.state[p].get("nu", torch.zeros_like(p)))
            for k, p in params.items()},
        step=state.step, count=opt.count)


@contextlib.contextmanager
def replayed_choice(choice):
    """The port's step takes JAX's gamma draw."""
    if choice is None:
        yield
        return
    saved = step_module.gamma_mixture_guide_criterion
    step_module.gamma_mixture_guide_criterion = functools.partial(
        gamma.gamma_mixture_guide_criterion, choice=choice)
    try:
        yield
    finally:
        step_module.gamma_mixture_guide_criterion = saved


def run_port(arm, variables, pools, draws, choices, control=None):
    """The port driver's protocol (run_arm's pieces) in float64, with JAX's
    gamma draws; `control` "skip_backfill" or "reset_counter" breaks the
    resume. Returns per step (reading before, stats, reading after)."""
    base, finetune = semi_sup_ab.split_arm(arm)
    assert finetune
    lab_np, weak_np, _ = semi_sup_ab.arm_pools(base, pools[0], pools[1],
                                               pools[0])
    labeled = batch_to_tensors(lab_np, "cpu", F64)
    weak = batch_to_tensors(weak_np, "cpu", F64)
    model = load_model(flax_to_state_dict(to64(variables)), PORT_CFG, "cpu")
    state = TrainState(model, OptimizerConfig(total_steps=STEPS,
                                              learning_rate=LR), ema=True)
    flags = float64_flags(semi_sup_ab.ARM_FLAGS[base])
    step = common.make_pool_step(
        make_train_step(model, PORT_CFG, SCANNET_MEAN_SIZES, flags), B,
        semi=True)
    sup_step = common.make_pool_step(make_train_step(
        model, PORT_CFG, SCANNET_MEAN_SIZES, semi_sup_ab.ARM_FLAGS["sup"]),
        B, semi=False)
    cw = [float(w) for w in semi_sup_ab.cw_schedule(base, True, STEPS, P)]
    gen = torch.Generator().manual_seed(
        1009 * SEED + semi_sup_ab.ARM_KEY[base] + 7000)
    out = []
    for i in range(STEPS):
        if i == P:
            if control != "skip_backfill":
                common.backfill_teacher(state)
            if control == "reset_counter":
                state.step = 0
        semi = i >= P
        for got, want in zip(peek_draws(gen, semi), draws[i]):
            assert np.array_equal(got, want), (arm, i)
        before = port_reading(state)
        with replayed_choice(choices[i]):
            stats = (step if semi else sup_step)(state, labeled, weak, cw[i],
                                                 gen)
        out.append((before, {k: v.numpy() for k, v in stats.items()},
                    port_reading(state)))
    return out


# -- the checks ---------------------------------------------------------------

def measured_alpha(before, after):
    """The EMA alpha a step applied, from its tensors: T_new - S_new =
    alpha (T_old - S_new), median over the elements where T_old - S_new is
    not small."""
    ratios = []
    for k, t_new in after["ema_params"].items():
        s_new, t_old = after["params"][k], before["ema_params"][k]
        d = t_old - s_new
        m = np.abs(d) > 1e-6
        ratios.append((t_new - s_new)[m] / d[m])
    return float(np.median(np.concatenate(ratios)))


def _worst(gaps):
    """[worst gap, its key] of a {key: gap} dict."""
    k = max(gaps, key=gaps.get)
    return [float(gaps[k]), k]


def _relative(got, want, floor):
    """{key: max |got - want| over max(want's largest magnitude, floor)}."""
    return {k: float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()),
                                                    floor)
            for k, w in want.items()}


def step_gaps(i, port_step, jax_step, err_t, names, bn_names):
    """The gaps of step i (0-based), each a dimensionless [worst, where]:
    stats relative to each stat's magnitude; the student's parameters
    over lr; the AdamW moments relative to each tensor's largest magnitude,
    floored at 1e-3 (mu) or 1e-6 (nu) of the largest of all tensors (a bias
    before a train-mode BatchNorm has an analytically zero gradient, whose
    roundoff no scale of its own measures); BN statistics relative to each
    buffer's largest magnitude; the counters 0 when equal; the teacher, in
    the semi phase, over the bound the EMA rule carries from the students'
    gaps (`err_t`, {name: elementwise}, updated in place; <= 1 holds it),
    in the supervised phase its largest change (0: no EMA update); the
    measured EMA alphas' largest distance from the rule's."""
    p_before, p_stats, p_after = port_step
    j_before, j_stats, j_after, _ = jax_step
    j_before = jax_reading(j_before, names, bn_names)
    j_after = jax_reading(j_after, names, bn_names)
    gaps = {}
    assert set(p_stats) == set(j_stats), (i, set(p_stats) ^ set(j_stats))
    gaps["stats"] = _worst({
        k: abs(float(p_stats[k]) - float(v)) / max(abs(float(v)), 1e-12)
        for k, v in j_stats.items()})
    gaps["counters"] = [
        float(not (p_after["step"] == j_after["step"] == i + 1
                   and p_after["count"] == j_after["count"] == i + 1)),
        f"port {p_after['step']}/{p_after['count']}, JAX "
        f"{j_after['step']}/{j_after['count']}"]
    student = {k: np.abs(p_after["params"][k] - j_after["params"][k])
               for k in names}
    gaps["student"] = _worst({k: float(g.max()) / LR
                              for k, g in student.items()})
    for m, floor in (("mu", 1e-3), ("nu", 1e-6)):
        top = max(float(np.abs(v).max()) for v in j_after[m].values())
        gaps[m] = _worst(_relative(p_after[m], j_after[m], floor * top))
    for b in ("bn", "ema_bn"):
        gaps[b] = _worst(_relative(p_after[b], j_after[b], 1e-12))
    if i == P:  # the backfill: the teacher is the student before the step
        for k in names:
            err_t[k] = np.abs(p_before["params"][k] - j_before["params"][k])
    if i >= P:
        alpha = float(min(np.float32(1) - np.float32(1)
                          / (np.float32(j_after["step"]) + np.float32(1)),
                          np.float32(DECAY)))
        gaps["alpha"] = [max(abs(measured_alpha(p_before, p_after) - alpha),
                             abs(measured_alpha(j_before, j_after) - alpha)),
                         f"rule {alpha}"]
        for k in names:
            err_t[k] = alpha * err_t[k] + (1 - alpha) * student[k]
        gaps["teacher"] = _worst({
            k: float((np.abs(p_after["ema_params"][k]
                             - j_after["ema_params"][k])
                      / (err_t[k] + TEACHER_SLACK)).max()) for k in names})
    else:
        gaps["teacher"] = _worst({
            k: float(np.abs(p_after["ema_params"][k]
                            - p_before["ema_params"][k]).max())
            for k in names})
    return gaps


def protocol_gaps(port_run, jax_run):
    names = list(port_run[0][0]["params"])
    bn_names = list(port_run[0][0]["bn"])
    err_t = {}
    return [step_gaps(i, ps, js, err_t, names, bn_names)
            for i, (ps, js) in enumerate(zip(port_run, jax_run))]


def main(path):
    assert jax.config.jax_enable_x64, "run with JAX_ENABLE_X64=1"
    torch.set_num_threads(1)
    out = {}
    with tempfile.TemporaryDirectory() as tmp, oracle_model_ops():
        jax_ab = load_jax_driver(os.path.join(tmp, "ab.json"))
        pools = load_pools()
        jax_steps = make_jax_steps(jax_ab)
        variables = initial_variables(pools)
        for arm in ARMS:
            draws = port_draws(arm[:-3])
            jax_run = run_jax(arm, jax_ab, jax_steps, variables, pools, draws)
            choices = [c for _, _, _, c in jax_run]
            out[arm] = {"stats": [
                {k: float(v) for k, v in s.items()}
                for _, s, _, _ in jax_run]}
            for control in (None,) + CONTROLS:
                port_run = run_port(arm, variables, pools, draws, choices,
                                    control)
                out[arm][control or "port"] = protocol_gaps(port_run,
                                                            jax_run)
                print(arm, control, json.dumps(out[arm][control or "port"]),
                      flush=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1])
