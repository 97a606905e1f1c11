"""The port's semi-supervised training slice against the JAX package, on the
CPU: the mean-teacher consistency loss, the gamma-mixture criterion, the
ARKit pc loss, and whole steps of `make_train_step` with them on.

Inputs are made with numpy from a seed and handed to both packages. End
points come from the port's --smoke model in train mode (student on 2
labeled + 2 weak scenes, teacher on their `ema_point_clouds`), with random
flips, z-rotations and scales as the augmentation records, so that the
teacher-to-student alignment is exercised. The criterion's random draw
cannot be reproduced across frameworks (jax.random vs torch.Generator), so
the tests replay JAX's draw (`jax.random.split` as `_scene_metric` does:
one key per scene, split into a gumbel key for the quad and a randint key
for the 10 000 points) and feed it to the port (`choice=`).

Tolerances, with their reasons:
- single losses and their gradients: 1e-5 abs + rel (XLA:CPU and ATen sum
  in other orders); index outputs bitwise; masks exactly equal;
- the fitted gamma mixture: 1e-4 relative (25 EM iterations of Newton steps
  on digamma / trigamma, whose float32 implementations differ);
- a whole step of the TINY model at dropout 0: stats 1e-3 rel + 1e-4 abs,
  every parameter gradient within 1e-3 of the global gradient norm, BN
  running stats (student and teacher) 1e-3, as the supervised whole-step
  test (train-mode BatchNorm over few rows amplifies float32 drift); the
  EMA parameters within 1e-6 of JAX's plus what the EMA rule carries over
  from the two students' updated parameters ((1 - alpha) times their gap):
  Adam's first update is lr * g / (|g| + eps), so parameters whose clipped
  gradient is near eps may move differently in the two packages.
"""
import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_pq_tpu.losses import arkit as jarkit
from omni_pq_tpu.losses import consistency as jcons
from omni_pq_tpu.losses import gamma as jgamma
from omni_pq_tpu.models import PQTransformer as JaxPQTransformer
from omni_pq_tpu.train import (OptimizerConfig as JaxOptimizerConfig,
                               TrainFlags as JaxTrainFlags,
                               create_train_state as jax_create_train_state,
                               make_train_step as jax_make_train_step)
from omni_pq_torch.config import SCANNET_MEAN_SIZES, SMOKE_MODEL, ModelConfig
from omni_pq_torch.data import make_batch
from omni_pq_torch.infer import build_model, load_model
from omni_pq_torch.interop import flax_to_state_dict
from omni_pq_torch.losses import arkit, consistency, gamma
from omni_pq_torch.train import (OptimizerConfig, TrainFlags, TrainState,
                                 batch_to_tensors, make_eval_step,
                                 make_train_step)
from omni_pq_torch.train import step as step_module
from tests.test_torch_port_modules import port_config, randomised_variables
from tests.util import TINY

TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_CFG = dataclasses.replace(TINY, dropout=0.0)
B = 2  # labeled scenes; as many weak ones


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _t(a):
    return torch.from_numpy(np.array(a))


def augment(batch, rng):
    """Random flip / z-rotation / scale records, as the reference's
    augmentation writes them."""
    n = batch["point_clouds"].shape[0]
    theta = rng.uniform(-np.pi, np.pi, n)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.zeros((n, 3, 3), np.float32)
    rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1] = c, -s, s, c
    rot[:, 2, 2] = 1.0
    return dict(batch, flip_x_axis=rng.integers(0, 2, n),
                flip_y_axis=rng.integers(0, 2, n), rot_mat=rot,
                scale=rng.uniform(0.8, 1.2, n).astype(np.float32))


@pytest.fixture(scope="module")
def semi_inputs():
    """Student end points of 2 labeled + 2 weak scenes (train mode), the
    teacher's on their ema clouds, the augmentation records of both
    halves, and the weak half's labels."""
    cfg = ModelConfig(**{**SMOKE_MODEL, "num_points": TINY.num_points,
                         "dropout": 0.0})
    rng = np.random.default_rng(20)
    lab = augment(make_batch(rng, B, cfg.num_points), rng)
    weak = augment(make_batch(rng, B, cfg.num_points), rng)
    model = build_model(cfg, "cpu", seed=21).train()
    with torch.no_grad():
        ep = model(_t(np.concatenate([lab["point_clouds"],
                                      weak["point_clouds"]])))
        ema_ep = model(_t(np.concatenate([lab["ema_point_clouds"],
                                          weak["ema_point_clouds"]])))
    records = {k: np.concatenate([lab[k], weak[k]]) for k in
               ("flip_x_axis", "flip_y_axis", "rot_mat", "scale")}
    return ({k: v.numpy() for k, v in ep.items()},
            {k: v.numpy() for k, v in ema_ep.items()}, records, weak)


def _floats(ep):
    return sorted(k for k, v in ep.items() if v.dtype.kind == "f")


# -- mean-teacher consistency -------------------------------------------------

def test_consistency_helpers_match_jax(semi_inputs):
    ep, ema_ep, rec, _ = semi_inputs
    fx, fy, rot, sc = (rec[k] for k in ("flip_x_axis", "flip_y_axis",
                                        "rot_mat", "scale"))
    assert fx.any() and fy.any() and not fx.all()  # both branches taken
    aligned_j = jcons._align_ema_centers(ema_ep["last_center"], fx, fy, rot,
                                         sc)
    aligned = consistency._align_ema_centers(
        _t(ema_ep["last_center"]), _t(fx), _t(fy), _t(rot), _t(sc))
    np.testing.assert_allclose(_np(aligned), aligned_j, **TOL)

    dist = np.random.default_rng(22).gamma(2.0, 1.0, (4, 16)).astype(
        np.float32)
    np.testing.assert_allclose(_np(consistency._quantile_clip_mean(_t(dist))),
                               jcons._quantile_clip_mean(dist), **TOL)

    scores = jax.nn.softmax(ep["last_objectness_scores"], axis=2)[..., 1]
    want = jcons._center_consistency(ep["last_center"], aligned_j, scores)
    got = consistency._center_consistency(_t(ep["last_center"]), aligned,
                                          _t(np.asarray(scores)))
    np.testing.assert_allclose(_np(got[0]), want[0], **TOL)
    np.testing.assert_array_equal(_np(got[1]), want[1])
    np.testing.assert_allclose(_np(got[2]), want[2], **TOL)
    map_ind = want[1]

    for key, batchmean in (("sem_cls_scores", False), ("quad_scores", True)):
        np.testing.assert_allclose(
            _np(consistency._class_consistency(
                _t(ep[f"last_{key}"]), _t(ema_ep[f"last_{key}"]),
                _t(np.asarray(map_ind)), batchmean=batchmean)),
            jcons._class_consistency(ep[f"last_{key}"], ema_ep[f"last_{key}"],
                                     map_ind, batchmean=batchmean), **TOL)

    size_j = jcons._decode_size(ep["last_size_scores"],
                                ep["last_size_residuals"], SCANNET_MEAN_SIZES)
    size = consistency._decode_size(_t(ep["last_size_scores"]),
                                    _t(ep["last_size_residuals"]),
                                    SCANNET_MEAN_SIZES)
    np.testing.assert_allclose(_np(size), size_j, **TOL)
    conf = np.asarray(want[2])
    np.testing.assert_allclose(
        _np(consistency._size_consistency(size, size * 1.1 + 0.05,
                                          _t(np.asarray(map_ind)), _t(conf))),
        jcons._size_consistency(size_j, size_j * 1.1 + 0.05, map_ind, conf),
        **TOL)
    np.testing.assert_allclose(
        _np(consistency._normal_consistency(
            _t(ep["last_normal_vector"]), _t(ema_ep["last_normal_vector"]),
            _t(np.asarray(map_ind)), _t(conf))),
        jcons._normal_consistency(ep["last_normal_vector"],
                                  ema_ep["last_normal_vector"], map_ind,
                                  conf), **TOL)


def test_decode_size_takes_the_first_of_tied_scores():
    scores = np.zeros((1, 2, 18), np.float32)
    scores[0, 1, [3, 7]] = 1.0  # a tie between classes 3 and 7
    res = np.random.default_rng(23).normal(size=(1, 2, 18, 3)).astype(
        np.float32)
    got = _np(consistency._decode_size(_t(scores), _t(res),
                                       SCANNET_MEAN_SIZES))
    np.testing.assert_array_equal(
        got, np.asarray(jcons._decode_size(scores, res, SCANNET_MEAN_SIZES)))
    np.testing.assert_allclose(got[0, 1], SCANNET_MEAN_SIZES[3] + res[0, 1, 3],
                               rtol=1e-6)


def test_get_consistency_loss_every_stat_and_gradient_matches_jax(
        semi_inputs):
    ep, ema_ep, rec, _ = semi_inputs
    keys = _floats(ep)

    def jax_loss(floats):
        return jcons.get_consistency_loss({**ep, **floats, **rec}, ema_ep,
                                          SCANNET_MEAN_SIZES, num_layer=2)
    (loss_j, stats_j), grads_j = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))({k: ep[k] for k in keys})

    floats = {k: _t(ep[k]).requires_grad_() for k in keys}
    loss, stats = consistency.get_consistency_loss(
        {**floats, **{k: _t(v) for k, v in rec.items()}},
        {k: _t(v) for k, v in ema_ep.items()}, SCANNET_MEAN_SIZES,
        num_layer=2)
    loss.backward()
    np.testing.assert_allclose(_np(loss), loss_j, **TOL)
    assert set(stats) == set(stats_j) and len(stats) == 9
    for k in stats_j:
        np.testing.assert_allclose(_np(stats[k]), stats_j[k], err_msg=k,
                                   **TOL)
    assert any(floats[k].grad is not None for k in keys)
    for k in keys:
        g = floats[k].grad
        g = np.zeros_like(ep[k]) if g is None else _np(g)
        np.testing.assert_allclose(g, grads_j[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


# -- gamma mixture ------------------------------------------------------------

def _mixture_sample(seed, n=4000):
    rng = np.random.default_rng(seed)
    near = rng.gamma(2.0, 1 / 20.0, n // 4)
    far = rng.gamma(3.0, 1.0, n - n // 4)
    return np.concatenate([near, far]).astype(np.float32)


def test_gamma_logpdf_and_fixed_keep_mask_match_jax():
    x = _mixture_sample(24)
    for a, b in ((2.0, 20.0), (3.0, 1.0), (0.7, 2.5)):
        np.testing.assert_allclose(_np(gamma.gamma_logpdf(_t(x), a, b)),
                                   jgamma.gamma_logpdf(x, a, b), **TOL)
    keep = _np(gamma.mixture_keep_mask(_t(x)))
    np.testing.assert_array_equal(keep, jgamma.mixture_keep_mask(x))
    assert 0 < keep.mean() < 1


def test_gamma_mixture_em_and_fitted_keep_mask_match_jax():
    xs = np.stack([_mixture_sample(25), _mixture_sample(26) * 1.5])
    got = gamma.gamma_mixture_em(_t(xs), weight=0.1)  # both rows at once
    for row, x in enumerate(xs):
        want = jgamma.gamma_mixture_em(x, 2.0, 20.0, 3.0, 1.0, 0.1, 25)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g)[row, 0], w, rtol=1e-4)
        keep = _np(gamma.mixture_keep_mask(_t(x), use_fitted=True))
        np.testing.assert_array_equal(
            keep, jgamma.mixture_keep_mask(x, use_fitted=True))
    # the fit moves away from the initial parameters
    assert abs(float(got[1][0, 0]) - 20.0) > 1.0


@pytest.mark.parametrize("q", [0.0, 0.5, 0.85, 1.0])
def test_masked_quantile_matches_jax(q):
    rng = np.random.default_rng(27)
    v = rng.normal(size=(3, 50)).astype(np.float32)
    mask = rng.uniform(size=(3, 50)) < 0.6
    mask[2] = False  # an empty row reads the pad
    got = _np(gamma.masked_quantile(_t(v), _t(mask), q))
    for row in range(3):
        np.testing.assert_allclose(
            got[row], jgamma.masked_quantile(v[row], mask[row], q), **TOL)
    np.testing.assert_allclose(got[:2], [np.quantile(v[r][mask[r]], q)
                                         for r in range(2)], rtol=1e-5)


def _wall_scene(seed, n_quads=6):
    """A synthetic room's weak half as the criterion sees it: its points
    and normals, and quads near its 4 walls (the GT quads with noise) plus
    random ones, so that both engaged and idle scenes occur."""
    rng = np.random.default_rng(seed)
    scene = make_batch(rng, 1, 2048)
    centers = rng.normal(0, 0.3, (n_quads, 3)) + np.array([0.0, 0.0, 1.0])
    normals = rng.normal(size=(n_quads, 3))
    sizes = rng.uniform(0.5, 3.0, (n_quads, 2))
    centers[:4] = scene["gt_quad_centers"][0, :4] + rng.normal(0, 0.03, (4, 3))
    normals[:4] = scene["gt_normal_vectors"][0, :4] + rng.normal(0, 0.05,
                                                                (4, 3))
    sizes[:4] = scene["gt_quad_sizes"][0, :4]
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    scores = rng.normal(0, 1.5, (n_quads, 2))
    return {"last_quad_scores": scores, "last_quad_center": centers,
            "last_normal_vector": normals, "last_quad_size": sizes,
            "point_clouds": scene["point_clouds"][0],
            "vertex_normals": scene["vertex_normals"][0]}


def _stack(scenes):
    return {k: np.stack([s[k] for s in scenes]).astype(np.float32)
            for k in scenes[0]}


@pytest.mark.parametrize("use_fitted", [False, True])
def test_quad_point_mixture_metric_and_gradients_match_jax(use_fitted):
    """One quad per scene (each of 3 scenes' GT wall 0..2, noised) against
    the JAX function per scene; gradients of a mix of the 4 metrics with
    respect to the quad's score, centre, normal and size."""
    scenes = [_wall_scene(30 + i) for i in range(3)]
    rng = np.random.default_rng(33)
    ds = rng.integers(0, 2048, (3, 10000))
    quad = {k: np.stack([s[f"last_{k}"][i] for i, s in enumerate(scenes)])
            .astype(np.float32)
            for k in ("quad_scores", "quad_center", "normal_vector",
                      "quad_size")}
    pc = np.stack([s["point_clouds"][d] for s, d in zip(scenes, ds)])
    pn = np.stack([s["vertex_normals"][d] for s, d in zip(scenes, ds)])
    w = np.array([1.0, 2.0, 3.0, 4.0], np.float32)

    def mix(out):
        return sum(wi * m for wi, m in zip(w, out[:4]))

    leaves = {k: _t(v).requires_grad_() for k, v in quad.items()}
    out = gamma.quad_point_mixture_metric(
        leaves["quad_scores"], leaves["quad_center"], leaves["normal_vector"],
        leaves["quad_size"], _t(pc), _t(pn), use_fitted)
    mix(out).sum().backward()
    assert bool(out[4].any())  # at least one scene passes the 300-point gate
    for i in range(3):
        def f(q):
            return jgamma.quad_point_mixture_metric(
                q["quad_scores"], q["quad_center"], q["normal_vector"],
                q["quad_size"], pc[i], pn[i], use_fitted)
        want = f({k: v[i] for k, v in quad.items()})
        for g, wv in zip(out, want):
            np.testing.assert_allclose(_np(g)[i], wv, **TOL)
        grads = jax.grad(lambda q: mix(f(q)))({k: v[i]
                                               for k, v in quad.items()})
        for k in quad:
            np.testing.assert_allclose(_np(leaves[k].grad)[i], grads[k],
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def jax_choice(rng_gamma, quad_scores, num_points):
    """What JAX's criterion draws from `rng_gamma` (gamma.py:141-155)."""
    conf = np.asarray(jax.nn.softmax(quad_scores, axis=-1)[..., 1]
                      > jgamma.CONF_THRESH)
    ind, ds = [], []
    for b, key in enumerate(jax.random.split(rng_gamma, len(conf))):
        kq, kd = jax.random.split(key)
        g = jax.random.gumbel(kq, conf[b].shape)
        ind.append(int(jnp.argmax(jnp.where(conf[b], g, -jnp.inf))))
        ds.append(np.asarray(jax.random.randint(kd, (10000,), 0, num_points)))
    return np.array(ind), np.stack(ds)


def test_guide_criterion_fed_jax_draw_matches_jax():
    ep = _stack([_wall_scene(40 + i) for i in range(3)])
    key = jax.random.PRNGKey(41)
    quad_keys = [k for k in ep if k.startswith("last_")]

    def jloss(q):
        out = jgamma.gamma_mixture_guide_criterion({**ep, **q}, key)
        return out[1] + 2.0 * out[2] + 3.0 * out[3], out
    (_, want), grads_j = jax.value_and_grad(jloss, has_aux=True)(
        {k: ep[k] for k in quad_keys})
    choice = jax_choice(key, ep["last_quad_scores"], 2048)

    leaves = {k: _t(ep[k]).requires_grad_() for k in quad_keys}
    got = gamma.gamma_mixture_guide_criterion(
        {**leaves, "point_clouds": _t(ep["point_clouds"]),
         "vertex_normals": _t(ep["vertex_normals"])}, choice=choice)
    (got[1] + 2.0 * got[2] + 3.0 * got[3]).backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), w, **TOL)
    assert 0 < float(got[4]) <= 1  # some scene engaged
    for k in quad_keys:
        np.testing.assert_allclose(_np(leaves[k].grad), grads_j[k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_guide_criterion_draws_from_the_generator_only():
    ep = {k: _t(v) for k, v in _stack([_wall_scene(50 + i)
                                       for i in range(2)]).items()}
    a = gamma.gamma_mixture_guide_criterion(
        ep, torch.Generator().manual_seed(5))
    b = gamma.gamma_mixture_guide_criterion(
        ep, torch.Generator().manual_seed(5))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    ind, ds = gamma.draw_choice(ep["last_quad_scores"], 2048,
                                torch.Generator().manual_seed(5))
    conf = torch.softmax(ep["last_quad_scores"], -1)[..., 1] > 0.1
    assert bool(conf[torch.arange(2), ind].all()) and ds.shape == (2, 10000)
    with pytest.raises(ValueError, match="Generator"):
        gamma.gamma_mixture_guide_criterion(ep)


# -- ARKit pc loss ------------------------------------------------------------

def test_arkit_pc_loss_and_collisions_match_jax(semi_inputs):
    ep, _, _, weak = semi_inputs
    labels = {k: weak[k] for k in ("center_label", "size_label",
                                   "num_gt_boxes")}
    labels["num_gt_boxes"] = np.array([labels["num_gt_boxes"][0], 0])
    keys = ["last_quad_center", "last_normal_vector", "last_quad_size",
            "last_quad_scores"]

    def jloss(q):
        return jarkit.get_arkit_pc_loss({**ep, **q}, labels)
    (loss_j, coll_j), grads_j = jax.value_and_grad(jloss, has_aux=True)(
        {k: ep[k] for k in keys})
    leaves = {k: _t(ep[k]).requires_grad_() for k in keys}
    loss, coll = arkit.get_arkit_pc_loss(
        {**{k: _t(v) for k, v in ep.items()}, **leaves},
        batch_to_tensors(labels, "cpu"))
    loss.backward()
    np.testing.assert_allclose(_np(loss), loss_j, **TOL)
    assert float(coll) == float(coll_j) > 0
    for k in keys:
        g = leaves[k].grad
        np.testing.assert_allclose(np.zeros_like(ep[k]) if g is None
                                   else _np(g), grads_j[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


# -- whole steps --------------------------------------------------------------

# (flags, whether the criterion's draw is replayed from JAX)
STEP_CASES = {
    "ema_arkit": dict(ema=True, gamma_mixture=False, arkit=True,
                      lambda_arkit_pc_loss=0.1),
    "ema_gamma": dict(),  # TrainFlags() defaults: ema + gamma_mixture
}
CONSISTENCY_WEIGHT = 0.3


def _rig_last_quad_head(variables):
    """The last decoder layer's quad head made near-constant: every quad
    confident, normals along +x, wide and tall, centred on its query point
    (a seed of the cloud). The gamma criterion then finds >= 300 kept points
    on the synthetic rooms' x walls, so the whole step exercises it."""
    head = variables["params"]["quad_prediction_head1"]
    for name, bias in (("quad_scores_head", [0.0, 3.0]),
                       ("normal_vector_head", [1.0, 0.0, 0.0]),
                       ("size_head", [10.0, 10.0]),
                       ("center_head", [0.0, 0.0, 0.0])):
        head[name] = {"kernel": np.asarray(head[name]["kernel"]) * 0.01,
                      "bias": np.asarray(bias, np.float32)}
    return variables


@pytest.fixture(scope="module", params=sorted(STEP_CASES))
def jax_semi_step(request):
    """One step of JAX's own make_train_step, and the gradients of the loss
    function inside it (taken from its closure, so it is JAX's code)."""
    flags_kw = STEP_CASES[request.param]
    rng = np.random.default_rng(60)
    lab = augment(make_batch(rng, B, TRAIN_CFG.num_points), rng)
    weak = augment(make_batch(rng, B, TRAIN_CFG.num_points), rng)
    jmodel = JaxPQTransformer(TRAIN_CFG)
    variables = _rig_last_quad_head(
        randomised_variables(jmodel, lab["point_clouds"], seed=61))
    flags = JaxTrainFlags(**flags_kw)
    state = jax_create_train_state(variables, JaxOptimizerConfig(), ema=True)
    jl, jw = ({k: jnp.asarray(v) for k, v in b.items()} for b in (lab, weak))
    key = jax.random.PRNGKey(62)
    cw = jnp.float32(CONSISTENCY_WEIGHT)
    step = jax_make_train_step(jmodel, TRAIN_CFG, SCANNET_MEAN_SIZES, flags)
    new_state, stats = step(state, jl, jw, key, cw)
    loss_fn = inspect.getclosurevars(step.__wrapped__).nonlocals["loss_fn"]
    grads, _ = jax.jit(jax.grad(loss_fn, has_aux=True))(
        state.params, state.batch_stats, state.ema_params,
        state.ema_batch_stats, jl, jw, key, cw)
    choice = None
    if flags.gamma_mixture:  # the draw JAX's criterion made in that step
        rng_drop, _, rng_gamma = jax.random.split(key, 3)
        ep, _ = jax.jit(lambda v, x: jmodel.apply(
            v, x, train=True, rngs={"dropout": rng_drop},
            mutable=["batch_stats"]))(
            variables, jnp.concatenate([jl["point_clouds"],
                                        jw["point_clouds"]]))
        choice = jax_choice(rng_gamma, ep["last_quad_scores"][B:],
                            TRAIN_CFG.num_points)
    return dict(flags_kw=flags_kw, lab=lab, weak=weak, variables=variables,
                stats=jax.tree.map(np.asarray, stats),
                grads=jax.tree.map(np.asarray, grads), choice=choice,
                new_state=jax.tree.map(np.asarray, dict(
                    params=new_state.params,
                    batch_stats=new_state.batch_stats,
                    ema_params=new_state.ema_params,
                    ema_batch_stats=new_state.ema_batch_stats)))


def test_whole_semi_supervised_step_matches_jax(jax_semi_step, monkeypatch):
    j = jax_semi_step
    cfg = port_config(TRAIN_CFG)
    model = load_model(flax_to_state_dict(j["variables"]), cfg, "cpu")
    state = TrainState(model, OptimizerConfig(), ema=True)
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    if j["choice"] is not None:
        monkeypatch.setattr(step_module, "gamma_mixture_guide_criterion",
                            functools.partial(
                                gamma.gamma_mixture_guide_criterion,
                                choice=j["choice"]))
    step = make_train_step(model, cfg, SCANNET_MEAN_SIZES,
                           TrainFlags(**j["flags_kw"]))
    stats = step(state, batch_to_tensors(j["lab"], "cpu"),
                 batch_to_tensors(j["weak"], "cpu"),
                 consistency_weight=CONSISTENCY_WEIGHT)
    assert state.step == 1 and model.training
    assert not state.ema_model.training  # back in eval mode after the step

    stats_j = j["stats"]
    assert set(stats) == set(stats_j)
    for k in stats_j:
        np.testing.assert_allclose(_np(stats[k]), stats_j[k], rtol=1e-3,
                                   atol=1e-4, err_msg=k)
    if "gamma_engaged_frac" in stats_j:
        assert stats_j["gamma_engaged_frac"] > 0  # the criterion fired
    if "arkit_collisions" in stats_j:
        assert stats_j["arkit_collisions"] > 0

    bs = j["variables"]["batch_stats"]
    want = flax_to_state_dict({"params": j["grads"], "batch_stats": bs})
    norm = float(stats_j["grad_norm"])
    for name, p in model.named_parameters():
        np.testing.assert_allclose(_np(p.grad) / norm,
                                   want[name].numpy() / norm, rtol=0,
                                   atol=1e-3, err_msg=name)

    new = j["new_state"]
    for mod, params, stats_key in ((model, "params", "batch_stats"),
                                   (state.ema_model, "ema_params",
                                    "ema_batch_stats")):
        want_bn = flax_to_state_dict({"params": new[params],
                                      "batch_stats": new[stats_key]})
        for name, buf in mod.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(_np(buf), want_bn[name].numpy(),
                                           rtol=1e-3, atol=1e-3,
                                           err_msg=f"{stats_key} {name}")
    # the EMA rule at step 1: alpha = min(1 - 1/2, decay) = 0.5
    student_j = flax_to_state_dict({"params": new["params"],
                                    "batch_stats": bs})
    ema_j = flax_to_state_dict({"params": new["ema_params"],
                                "batch_stats": bs})
    student = dict(model.named_parameters())
    for name, e in state.ema_model.named_parameters():
        gap = np.abs(_np(student[name]) - student_j[name].numpy())
        err = np.abs(_np(e) - ema_j[name].numpy())
        assert (err <= 1e-6 + 0.5 * gap).all(), (name, float(err.max()))
        np.testing.assert_allclose(
            _np(e), 0.5 * _np(old[name]) + 0.5 * _np(student[name]),
            rtol=0, atol=1e-6, err_msg=name)
    ep = make_eval_step()(state, j["lab"]["point_clouds"], use_ema=True)
    assert not state.ema_model.training and ep["last_center"].shape[0] == B
