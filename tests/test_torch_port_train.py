"""The port's supervised training slice against the JAX package, on the CPU.

Each piece gets the same numpy inputs on both sides: train-mode BatchNorm
(outputs, gradients, running stats) against flax's nn.BatchNorm; the
Chamfer distance and every `get_loss` stat (and the loss's gradients with
respect to the end points); the ball-query-group backward against jax.vjp;
the LR schedule; the optimiser, fed the same gradients on both sides (not
gradients computed separately: Adam's first step is about lr * sign(g), so
roundoff in a near-zero gradient would become a 2*lr difference); the EMA
rule; and one whole supervised step of the TINY model at dropout 0 (every
stat, grad_norm, the per-parameter gradients and the new BN running stats).
Then the train CLI at the --smoke size on the CPU.

Tolerances: 1e-5 abs + rel for single ops and modules (XLA:CPU and ATen sum
in different orders); the optimiser's parameters after 3 updates 1e-6 abs;
the whole step: stats 1e-3 rel + 1e-4 abs, gradients within 1e-3 of the global
gradient norm, running stats 1e-3: train-mode BatchNorm divides by batch
statistics over few rows and amplifies the per-op drift through the model
(see tests/test_torch_port_fused.py).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen as fnn

from omni_pq_tpu import losses as jlosses
from omni_pq_tpu.models import PQTransformer as JaxPQTransformer
from omni_pq_tpu.ops import ball_query_group as jax_bqg
from omni_pq_tpu.ops.nn_distance import nn_distance as jax_nn_distance
from omni_pq_tpu.train import (OptimizerConfig as JaxOptimizerConfig,
                               TrainFlags as JaxTrainFlags,
                               create_train_state as jax_create_train_state,
                               make_train_step as jax_make_train_step,
                               warmup_cosine as jax_warmup_cosine)
from omni_pq_torch import ops
from omni_pq_torch.cli import train as train_cli
from omni_pq_torch.config import SCANNET_MEAN_SIZES, SMOKE_MODEL, ModelConfig
from omni_pq_torch.data import make_batch
from omni_pq_torch.infer import build_model, load_model
from omni_pq_torch.interop import flax_to_state_dict
from omni_pq_torch.losses import get_loss
from omni_pq_torch.models.pointnet2 import BatchNorm
from omni_pq_torch.models.transformer import dropout
from omni_pq_torch.train import (AdamW, OptimizerConfig, TrainFlags,
                                 TrainState, batch_to_tensors, make_eval_step,
                                 make_train_step, warmup_cosine)
from omni_pq_torch.train.state import StepScalars
from tests.test_torch_port_modules import port_config, randomised_variables
from tests.util import TINY

TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_CFG = dataclasses.replace(TINY, dropout=0.0)
SUP = dict(ema=False, gamma_mixture=False, arkit=False)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


# -- train-mode BatchNorm -----------------------------------------------------

def test_train_mode_batchnorm_matches_flax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 16, 8, 32)) * 2 + 1).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    bias = rng.normal(0, 0.1, 32).astype(np.float32)
    mean = rng.normal(0, 0.2, 32).astype(np.float32)
    var = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}

    def f(x, params):
        y, mut = bn.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, x,
                          mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mut["batch_stats"])
    (_, (y_j, st_j)), (gx_j, gp_j) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(x, variables["params"])

    port = BatchNorm(32)
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias),
                        ("running_mean", mean), ("running_var", var)):
            getattr(port, name).copy_(torch.from_numpy(v))
    port.train()
    xt = torch.from_numpy(x).requires_grad_()
    y_t = port(xt)
    (y_t * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(_np(y_t), y_j, **TOL)
    np.testing.assert_allclose(_np(port.running_mean), st_j["mean"], **TOL)
    np.testing.assert_allclose(_np(port.running_var), st_j["var"], **TOL)
    np.testing.assert_allclose(_np(xt.grad), gx_j, **TOL)
    np.testing.assert_allclose(_np(port.weight.grad), gp_j["scale"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(port.bias.grad), gp_j["bias"],
                               rtol=1e-4, atol=1e-4)
    # eval mode is unchanged: the running stats
    port.eval()
    with torch.no_grad():
        y_e = port(torch.from_numpy(x))
    y_ej = fnn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(
        {"params": variables["params"], "batch_stats": st_j}, x)
    np.testing.assert_allclose(_np(y_e), y_ej, **TOL)


# -- Chamfer distance and the supervised loss ---------------------------------

@pytest.mark.parametrize("mode", ["l2", "l1", "l1smooth"])
def test_nn_distance_matches_jax(mode):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(2, 30, 3)).astype(np.float32)
    b = rng.normal(size=(2, 20, 3)).astype(np.float32)
    kw = {"l2": {}, "l1": {"l1": True}, "l1smooth": {"l1smooth": True,
                                                      "delta": 0.5}}[mode]
    want = jax_nn_distance(jnp.asarray(a), jnp.asarray(b), **kw)
    got = ops.nn_distance(torch.from_numpy(a), torch.from_numpy(b), **kw)
    for g, w in zip(got, want):
        if np.asarray(w).dtype.kind in "iu":
            np.testing.assert_array_equal(_np(g), w)
        else:
            np.testing.assert_allclose(_np(g), w, **TOL)


@pytest.fixture(scope="module")
def loss_inputs():
    """End points of the port's TINY model (train-mode forward, so they are
    what the loss sees in a step) and the labels of 2 synthetic scenes."""
    cfg = ModelConfig(**{**SMOKE_MODEL, "num_points": TINY.num_points,
                         "dropout": 0.0})
    batch = make_batch(np.random.default_rng(2), 2, cfg.num_points)
    model = build_model(cfg, "cpu", seed=3).train()
    with torch.no_grad():
        ep = model(torch.from_numpy(batch["point_clouds"]))
    ep = {k: v.numpy() for k, v in ep.items()}
    labels = {k: v for k, v in batch.items() if k != "point_clouds"}
    return ep, labels


@pytest.mark.parametrize("near,far,pc_loss", [(0.3, 0.6, True),
                                              (1.0, 2.0, True),
                                              (1.0, 2.0, False)])
def test_get_loss_every_stat_and_gradient_matches_jax(loss_inputs, near, far,
                                                      pc_loss):
    ep, labels = loss_inputs
    float_keys = sorted(k for k, v in ep.items() if v.dtype.kind == "f")

    def jax_loss(floats):
        merged = {**ep, **floats, **labels}
        return jlosses.get_loss(merged, SCANNET_MEAN_SIZES, num_layer=2,
                                pc_loss=pc_loss, near=near, far=far)
    (loss_j, stats_j), grads_j = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))({k: ep[k] for k in float_keys})

    floats = {k: torch.from_numpy(ep[k]).requires_grad_() for k in float_keys}
    merged = {**{k: torch.from_numpy(v) for k, v in ep.items()}, **floats,
              **batch_to_tensors(labels, "cpu")}
    loss_t, stats_t = get_loss(merged, SCANNET_MEAN_SIZES, num_layer=2,
                               pc_loss=pc_loss, near=near, far=far)
    loss_t.backward()
    assert set(stats_t) == set(stats_j)
    if near == 1.0:  # positives on both branches, so no stat is trivially 0
        assert _np(stats_t["proposal_center_loss"]) > 0
        assert _np(stats_t["proposal_quad_center_loss"]) > 0
    for k in stats_j:
        np.testing.assert_allclose(_np(stats_t[k]), stats_j[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k in float_keys:
        g = floats[k].grad
        g = np.zeros_like(ep[k]) if g is None else _np(g)
        np.testing.assert_allclose(g, grads_j[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


# -- ball-query-group backward ------------------------------------------------

def test_ball_query_group_backward_matches_jax_vjp():
    rng = np.random.default_rng(4)
    xyz = (rng.uniform(size=(2, 200, 3)) * 2 + 0.5).astype(np.float32)
    ctr = xyz[:, :24].copy()
    ctr[:, 3] += 40.0  # a centre with no point in its ball
    g = rng.normal(size=(2, 24, 16, 3)).astype(np.float32)
    (idx_j, grouped_j), vjp = jax.vjp(
        lambda a, b: jax_bqg(0.3, 16, a, b), jnp.asarray(xyz),
        jnp.asarray(ctr))
    dxyz_j, dctr_j = vjp((np.zeros(idx_j.shape, jax.dtypes.float0), g))

    x = torch.from_numpy(xyz).requires_grad_()
    c = torch.from_numpy(ctr).requires_grad_()
    idx_t, grouped_t = ops.ball_query_group(0.3, 16, x, c)
    grouped_t.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(_np(idx_t), idx_j)
    assert (_np(idx_t)[:, 3] == 0).all()  # the no-hit centre reads xyz[0]
    np.testing.assert_allclose(_np(grouped_t), grouped_j, **TOL)
    np.testing.assert_allclose(_np(x.grad), dxyz_j, **TOL)
    np.testing.assert_allclose(_np(c.grad), dctr_j, **TOL)
    assert np.abs(_np(x.grad)[:, 0]).sum() > 0


# -- schedule, optimiser, EMA -------------------------------------------------

@pytest.mark.parametrize("total,warmup", [(100, 0), (100, 10), (7, 3)])
def test_warmup_cosine_matches_jax(total, warmup):
    want = jax_warmup_cosine(2e-3, total, warmup)
    got = warmup_cosine(2e-3, total, warmup)
    for step in [0, 1, 2, warmup, warmup + 1, total // 2, total - 1, total,
                 total + 5]:
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   err_msg=str(step))


class _TwoGroups(torch.nn.Module):
    """One 'base' and one 'decoder' parameter group, as label_fn splits the
    model's top-level modules."""

    def __init__(self, a, b):
        super().__init__()
        self.backbone = torch.nn.Module()
        self.backbone.w = torch.nn.Parameter(torch.from_numpy(a.copy()))
        self.decoder_layer0 = torch.nn.Module()
        self.decoder_layer0.w = torch.nn.Parameter(torch.from_numpy(b.copy()))


@pytest.mark.parametrize("step_freq,warmup", [(1, 0), (1, 2), (2, 0)])
def test_optimizer_matches_optax_on_the_same_gradients(step_freq, warmup):
    rng = np.random.default_rng(5)
    a = rng.normal(size=(6, 5)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    # gradients with norms above and below the 0.1 clip
    grads = [(rng.normal(size=a.shape) * s, rng.normal(size=b.shape) * s)
             for s in (1.0, 0.005, 0.3, 0.002, 2.0, 0.01)]
    grads = [(ga.astype(np.float32), gb.astype(np.float32))
             for ga, gb in grads][:3 * step_freq]
    kw = dict(total_steps=10, warmup_steps=warmup, step_freq=step_freq)

    jstate = jax_create_train_state(
        {"params": {"backbone": {"w": a}, "decoder_layer0": {"w": b}}},
        JaxOptimizerConfig(**kw), ema=False)
    for ga, gb in grads:
        jstate = jstate.apply_gradients(
            {"backbone": {"w": jnp.asarray(ga)},
             "decoder_layer0": {"w": jnp.asarray(gb)}})

    model = _TwoGroups(a, b)
    opt = AdamW(model.named_parameters(), OptimizerConfig(**kw))
    assert [g["name"] for g in opt.param_groups] == ["base", "decoder"]
    for ga, gb in grads:
        model.backbone.w.grad = torch.from_numpy(ga)
        model.decoder_layer0.w.grad = torch.from_numpy(gb)
        opt.step(StepScalars.holding(opt.step_values(), "cpu"))
    assert opt.count == 3
    np.testing.assert_allclose(_np(model.backbone.w),
                               jstate.params["backbone"]["w"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(_np(model.decoder_layer0.w),
                               jstate.params["decoder_layer0"]["w"], rtol=0,
                               atol=1e-6)


def test_ema_update_matches_jax():
    rng = np.random.default_rng(6)
    a = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    jstate = jax_create_train_state(
        {"params": {"backbone": {"w": a}, "decoder_layer0": {"w": b}}},
        JaxOptimizerConfig(), ema=True)
    state = TrainState(_TwoGroups(a, b), OptimizerConfig(), ema=True)
    for step in range(3):
        ga = rng.normal(size=a.shape).astype(np.float32)
        gb = rng.normal(size=b.shape).astype(np.float32)
        jstate = jstate.apply_gradients(
            {"backbone": {"w": jnp.asarray(ga)},
             "decoder_layer0": {"w": jnp.asarray(gb)}}).ema_update(0.9)
        state.model.backbone.w.grad = torch.from_numpy(ga)
        state.model.decoder_layer0.w.grad = torch.from_numpy(gb)
        state.apply_gradients(StepScalars.holding(
            state.optimizer.step_values(), "cpu"))
        state.ema_update(0.9, StepScalars.holding(
            state.ema_values(0.9, state.step), "cpu"))
    assert state.step == int(jstate.step) == 3
    np.testing.assert_allclose(_np(state.ema_model.backbone.w),
                               jstate.ema_params["backbone"]["w"], atol=1e-6)
    np.testing.assert_allclose(_np(state.ema_model.decoder_layer0.w),
                               jstate.ema_params["decoder_layer0"]["w"],
                               atol=1e-6)


def test_running_stats_over_many_train_forwards_match_flax():
    """The running statistics after 20 train-mode forwards of the TINY
    model (dropout 0) on 20 different batches, against flax's
    `mutable=["batch_stats"]` chain on the same weights and batches: what a
    student's eval reads after a stretch of steps (each update a convex
    combination, so the gap stays that of one forward, held to the whole
    step's 1e-3)."""
    batches = [make_batch(np.random.default_rng(40 + i), 2,
                          TRAIN_CFG.num_points)["point_clouds"]
               for i in range(20)]
    jmodel = JaxPQTransformer(TRAIN_CFG)
    variables = randomised_variables(jmodel, batches[0], seed=9)

    @jax.jit
    def forward(bs, pc):
        _, mut = jmodel.apply({"params": variables["params"],
                               "batch_stats": bs}, pc, train=True,
                              rngs={"dropout": jax.random.PRNGKey(0)},
                              mutable=["batch_stats"])
        return mut["batch_stats"]

    bs = variables["batch_stats"]
    model = load_model(flax_to_state_dict(variables), port_config(TRAIN_CFG),
                       "cpu")
    model.train()
    with torch.no_grad():
        for pc in batches:
            bs = forward(bs, jnp.asarray(pc))
            model(torch.from_numpy(pc))
    want = flax_to_state_dict({"params": variables["params"],
                               "batch_stats": jax.tree.map(np.asarray, bs)})
    first = flax_to_state_dict(variables)
    moved = 0
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(_np(buf), want[name].numpy(),
                                       rtol=1e-3, atol=1e-3, err_msg=name)
            moved += not np.allclose(want[name].numpy(),
                                     first[name].numpy(), atol=1e-3)
    assert moved > 20  # the 20 updates moved the statistics


# -- one whole supervised step ------------------------------------------------

@pytest.fixture(scope="module")
def jax_step():
    """One JAX supervised step (its own make_train_step) on TINY weights with
    BN noise, plus the same loss's gradients from jax.grad."""
    batch = make_batch(np.random.default_rng(7), 2, TRAIN_CFG.num_points)
    jmodel = JaxPQTransformer(TRAIN_CFG)
    variables = randomised_variables(jmodel, batch["point_clouds"], seed=8)
    labeled = {k: jnp.asarray(v) for k, v in batch.items()}
    flags = JaxTrainFlags(**SUP)
    state = jax_create_train_state(variables, JaxOptimizerConfig(), ema=False)
    step = jax_make_train_step(jmodel, TRAIN_CFG, SCANNET_MEAN_SIZES, flags)
    new_state, stats = step(state, labeled, labeled, jax.random.PRNGKey(0),
                            jnp.float32(0.0))

    def loss_fn(params):
        ep, _ = jmodel.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             labeled["point_clouds"], train=True,
                             rngs={"dropout": jax.random.PRNGKey(0)},
                             mutable=["batch_stats"])
        return jlosses.get_loss({**ep, **labeled}, SCANNET_MEAN_SIZES,
                                num_layer=TRAIN_CFG.num_decoder_layers)[0]
    grads = jax.jit(jax.grad(loss_fn))(variables["params"])
    return (batch, variables, jax.tree.map(np.asarray, stats),
            jax.tree.map(np.asarray, grads),
            jax.tree.map(np.asarray, new_state.batch_stats))


def test_whole_supervised_step_matches_jax(jax_step):
    batch, variables, stats_j, grads_j, bn_j = jax_step
    model = load_model(flax_to_state_dict(variables), port_config(TRAIN_CFG),
                       "cpu")
    state = TrainState(model, OptimizerConfig())
    step = make_train_step(model, port_config(TRAIN_CFG), SCANNET_MEAN_SIZES,
                           TrainFlags(**SUP))
    stats_t = step(state, batch_to_tensors(batch, "cpu"))
    assert state.step == 1 and model.training

    assert set(stats_t) == set(stats_j)
    for k in stats_j:
        np.testing.assert_allclose(_np(stats_t[k]), stats_j[k], rtol=1e-3,
                                   atol=1e-4, err_msg=k)

    want = flax_to_state_dict({"params": grads_j,
                               "batch_stats": variables["batch_stats"]})
    norm = float(stats_j["grad_norm"])
    for name, p in model.named_parameters():
        np.testing.assert_allclose(_np(p.grad) / norm,
                                   want[name].numpy() / norm, rtol=0,
                                   atol=1e-3, err_msg=name)

    want_bn = flax_to_state_dict({"params": variables["params"],
                                  "batch_stats": bn_j})
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(_np(buf), want_bn[name].numpy(),
                                       rtol=1e-3, atol=1e-3, err_msg=name)


def test_eval_step_and_flags_the_step_does_not_support():
    """Every flag builds a step (a bfloat16 teacher too, since it is
    ported: tests/test_torch_port_bf16.py); the semi-supervised flags ask
    for the weak batch and the EMA replica they need."""
    cfg = ModelConfig(num_points=512, **SMOKE_MODEL)
    model = build_model(cfg, "cpu", seed=9)
    step = make_train_step(model, cfg, SCANNET_MEAN_SIZES,
                           TrainFlags(teacher_bf16=True))
    with pytest.raises(ValueError, match="ema=True"):
        step(TrainState(model, OptimizerConfig()),
             batch_to_tensors(make_batch(np.random.default_rng(11), 1, 512),
                              "cpu"), {})
    batch = batch_to_tensors(make_batch(np.random.default_rng(11), 1, 512),
                             "cpu")
    for flag in ("ema", "gamma_mixture", "arkit"):
        step = make_train_step(model, cfg, SCANNET_MEAN_SIZES,
                               TrainFlags(**{**SUP, flag: True}))
        with pytest.raises(ValueError, match="weak batch"):
            step(TrainState(model, OptimizerConfig(), ema=True), batch)
    with pytest.raises(ValueError, match="ema=True"):
        make_train_step(model, cfg, SCANNET_MEAN_SIZES, TrainFlags())(
            TrainState(model, OptimizerConfig()), batch, batch)
    state = TrainState(model, OptimizerConfig(), ema=True)
    pc = make_batch(np.random.default_rng(10), 1, 512)["point_clouds"]
    model.train()
    ep = make_eval_step()(state, pc, use_ema=True)
    assert model.training and not state.ema_model.training
    assert ep["last_center"].shape == (1, 16, 3)
    # train-mode dropout needs the caller's generator
    with pytest.raises(ValueError, match="Generator"):
        model(torch.from_numpy(pc))


def test_dropout_keeps_one_minus_p_and_rescales():
    x = torch.ones(200, 500)
    g = torch.Generator().manual_seed(0)
    y = dropout(x, 0.1, True, g)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert torch.equal(dropout(x, 0.1, False, None), x)
    again = dropout(x, 0.1, True, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)  # the masks come from the generator alone


def train_records(log_dir):
    return [r for r in map(json.loads, (log_dir / "metrics.jsonl")
                           .read_text().splitlines())
            if "train/total_loss" in r]


def test_train_cli_smoke_on_cpu(tmp_path):
    """At float32 (--f32); the bfloat16 default is
    tests/test_torch_port_bf16.py's. Without --synthetic_data the CLI reads
    ScanNet from --data_root (tests/test_torch_port_cli.py)."""
    train_cli.main([
        "--smoke", "--synthetic_data", "--num_point", "512", "--device",
        "cpu", "--max_epoch", "1", "--end_proportion", "1.0",
        "--print_freq", "1", "--batch_size", "4", "--pc_loss", "--f32",
        "--log_dir", str(tmp_path)])
    recs = train_records(tmp_path)
    assert [r["step"] for r in recs] == list(range(1, 9))  # 32 scenes / 4
    for r in recs:
        for k in ("train/total_loss", "train/grad_norm", "train/loss",
                  "train/physical_constraints_loss"):
            assert np.isfinite(r[k]), k
    assert json.loads((tmp_path / "config.json").read_text())["pc_loss"]
    with pytest.raises(FileNotFoundError):
        train_cli.main(["--device", "cpu", "--log_dir", str(tmp_path),
                        "--data_root", str(tmp_path / "no_scannet")])


@pytest.mark.parametrize("flags", [["--ema", "--gamma_mixture"],
                                   ["--arkit", "--lambda_arkit_pc_loss",
                                    "0.1"]])
def test_semi_supervised_train_cli_smoke_on_cpu(tmp_path, flags):
    """The semi-supervised flags: a weak synthetic batch each step, the EMA
    teacher with --ema, and the losses' stats in the metrics (at float32,
    --f32; the bfloat16 default is tests/test_torch_port_bf16.py's)."""
    max_f1, max_ema_f1 = train_cli.main([
        "--smoke", "--synthetic_data", "--num_point", "512", "--device",
        "cpu", "--max_epoch", "1", "--end_proportion", "1.0",
        "--print_freq", "1", "--batch_size", "8", "--rng_seed", "3",
        "--f32", "--log_dir", str(tmp_path), *flags])
    recs = train_records(tmp_path)
    assert [r["step"] for r in recs] == list(range(1, 5))  # 32 scenes / 8
    want = (["weighted_consistency_loss", "consistency_loss",
             "gamma_mixture_filter_loss", "gamma_engaged_frac"]
            if "--ema" in flags else ["arkit_pc_loss", "arkit_collisions"])
    for r in recs:
        for k in want + ["total_loss", "grad_norm"]:
            assert np.isfinite(r[f"train/{k}"]), k
    if "--ema" in flags:  # the ramp: epoch 1 of a 1-epoch rampup is full
        assert recs[0]["train/weighted_consistency_loss"] == pytest.approx(
            0.05 * recs[0]["train/consistency_loss"]
            + 0.05 * recs[0]["train/quad_consistency_loss_sum"], rel=1e-5)
    assert np.isfinite(max_f1) and np.isfinite(max_ema_f1)
