"""The JAX package's float64 references for tests/test_torch_port_float64.py.

Run from the repo root as `JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python -m
tests.torch_float64_reference OUT.npz`, in its own process: 64-bit types are
a process-wide switch of JAX. Every model run here is the JAX package's
`compute_dtype="float64"` route under `interop.oracle_ops.oracle_model_ops()`
(FPS and the ball query decide on float32 copies of the coordinates, the
grouped values keep float64), the route's defined semantics: without the
oracles the package's fused ball_query_group hands a float32 cotangent to
float64 coordinates and `jax.grad` fails. Writes each array the tests
compare with under a flat key:

  ep/<key>, ep32p/<key>  the TINY eval forward on float64 clouds with
                         float64 parameters, and with the same values as
                         float32 parameters (computed in float64)
  w/<key>, loss, grad/<path>  the weighted scalar of end points that
                         tests/test_torch_parity.py's float64 test builds,
                         and its gradients for every parameter
  sup/...                one supervised step of make_train_step
  semi/...               one TrainFlags() step (EMA teacher + gamma mixture),
                         with the criterion's draw (semi/choice_*)
  three_nn/..., cross/...  the unit cases of ops/interpolate.three_nn
"""
from __future__ import annotations

import dataclasses
import inspect
import sys

import jax
import jax.numpy as jnp
import numpy as np

from omni_pq_tpu.config import SCANNET_MEAN_SIZES
from omni_pq_tpu.data.synthetic import make_batch
from omni_pq_tpu.interop.oracle_ops import oracle_model_ops
from omni_pq_tpu.models import PQTransformer
from omni_pq_tpu.ops import three_nn
from omni_pq_tpu.train import (OptimizerConfig, TrainFlags,
                               create_train_state, make_train_step)
from tests.util import TINY

CFG = dataclasses.replace(TINY, dropout=0.0)
CFG64 = dataclasses.replace(CFG, compute_dtype="float64")
B = 2
PREFIXES = ("proposal_", "0head_", "last_")
FIELDS = ("center", "objectness_scores", "sem_cls_scores", "heading_scores",
          "size_scores", "quad_scores", "quad_center", "normal_vector",
          "quad_size")
SUP = dict(ema=False, gamma_mixture=False, arkit=False)
CONSISTENCY_WEIGHT = 0.3


def eval_batch():
    return make_batch(np.random.default_rng(0), B, CFG.num_points)


def scalar_weights(ep):
    """The weights of the scalar sum_k mean(ep[k] * w[k]) (numpy, from a
    seed; the keys of PREFIXES x FIELDS)."""
    rng = np.random.default_rng(17)
    return {p + f: rng.normal(size=np.shape(ep[p + f])).astype(np.float32)
            for p in PREFIXES for f in FIELDS if p + f in ep}


def to64(tree):
    """Every floating leaf of a tree as float64 numpy."""
    return jax.tree.map(lambda x: np.asarray(x, np.float64)
                        if np.asarray(x).dtype.kind == "f" else np.asarray(x),
                        tree)


def floats64(batch):
    """A batch with its floating arrays in float64 (the route's batches)."""
    return {k: (v.astype(np.float64) if v.dtype.kind == "f" else v)
            for k, v in batch.items()}


def cross_case():
    """Random unknown and known points for the cross-term rounding case."""
    rng = np.random.default_rng(31)
    return (rng.uniform(size=(2, 64, 3)) * 4 + 0.5,
            rng.uniform(size=(2, 32, 3)) * 4 + 0.5)


def _three_nn_float32_term(u, k):
    """three_nn's selection with the cross term rounded to float32 from the
    float64 product (numpy): (B, n, 3) indices."""
    cross = np.einsum("bnc,bmc->bnm", u, k).astype(np.float32)
    d2 = np.maximum((u * u).sum(-1)[:, :, None] - 2.0 * cross.astype(
        np.float64) + (k * k).sum(-1)[:, None, :], 0.0)
    return np.argsort(d2, axis=-1, kind="stable")[..., :3]


def near_tie_case():
    """Unknown points each with known points at nearly one distance, where
    choosing by the float32 cross term and by the float64 distance pick
    differently (found by a seeded search): (unknown (4, 1, 3), known
    (4, 5, 3)) float64, one case a batch row."""
    rng = np.random.default_rng(32)
    us, ks = [], []
    while len(us) < 4:
        u = rng.uniform(0.5, 4.5, size=3)
        dirs = rng.normal(size=(5, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        k = u + dirs * (1.0 + 1e-9 * rng.normal(size=(5, 1)))
        direct = np.argsort(((k - u) ** 2).sum(-1), kind="stable")[:3]
        if not np.array_equal(direct,
                              _three_nn_float32_term(u[None, None],
                                                     k[None])[0, 0]):
            us.append(u)
            ks.append(k)
    return np.stack(us)[:, None], np.stack(ks)


def _eval_and_grads(out):
    batch = eval_batch()
    model32 = PQTransformer(CFG)
    model = PQTransformer(CFG64)
    from tests.test_torch_port_modules import randomised_variables
    variables = randomised_variables(model32, batch["point_clouds"], seed=1)
    out.update({f"variables/{'/'.join(p.key for p in path)}": np.asarray(x)
                for path, x in jax.tree_util.tree_flatten_with_path(
                    variables)[0]})
    v64 = to64(variables)
    pc = jnp.asarray(batch["point_clouds"], jnp.float64)
    apply = jax.jit(lambda v, x: model.apply(v, x, train=False))
    ep = jax.tree.map(np.asarray, apply(v64, pc))
    ep32p = jax.tree.map(np.asarray, apply(variables, pc))
    out.update({f"ep/{k}": v for k, v in ep.items()})
    out.update({f"ep32p/{k}": v for k, v in ep32p.items()})
    weights = scalar_weights(ep)
    out.update({f"w/{k}": v for k, v in weights.items()})

    def scalar(params):
        e = model.apply({"params": params,
                         "batch_stats": v64["batch_stats"]}, pc, train=False)
        return sum((e[k] * jnp.asarray(w, jnp.float64)).mean()
                   for k, w in weights.items())
    loss, grads = jax.jit(jax.value_and_grad(scalar))(v64["params"])
    out["loss"] = np.asarray(loss)
    out.update({f"grad/{'/'.join(p.key for p in path)}": np.asarray(g)
                for path, g in jax.tree_util.tree_flatten_with_path(
                    grads)[0]})


def _flat(out, prefix, tree):
    out.update({f"{prefix}/{'/'.join(p.key for p in path)}": np.asarray(x)
                for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]})


def _step(out, prefix, flags, lab, weak, variables):
    """One step of JAX's own make_train_step on float64 state and batches,
    and the gradients of the loss function inside it."""
    model = PQTransformer(CFG64)
    state = create_train_state(to64(variables), OptimizerConfig(),
                               ema=flags.ema)
    jl, jw = ({k: jnp.asarray(v) for k, v in floats64(b).items()}
              for b in (lab, weak))
    key = jax.random.PRNGKey(62)
    cw = jnp.float64(CONSISTENCY_WEIGHT)
    step = make_train_step(model, CFG64, SCANNET_MEAN_SIZES, flags)
    new_state, stats = step(state, jl, jw, key, cw)
    loss_fn = inspect.getclosurevars(step.__wrapped__).nonlocals["loss_fn"]
    grads, _ = jax.jit(jax.grad(loss_fn, has_aux=True))(
        state.params, state.batch_stats, state.ema_params,
        state.ema_batch_stats, jl, jw, key, cw)
    _flat(out, f"{prefix}/variables", variables)
    _flat(out, f"{prefix}/stats", stats)
    _flat(out, f"{prefix}/grads", grads)
    _flat(out, f"{prefix}/new_params", new_state.params)
    _flat(out, f"{prefix}/new_batch_stats", new_state.batch_stats)
    if flags.ema:
        _flat(out, f"{prefix}/new_ema_params", new_state.ema_params)
        _flat(out, f"{prefix}/new_ema_batch_stats", new_state.ema_batch_stats)
    if flags.gamma_mixture:  # the draw JAX's criterion made in that step
        from tests.test_torch_port_semi import jax_choice
        rng_drop, _, rng_gamma = jax.random.split(key, 3)
        ep, _ = jax.jit(lambda v, x: model.apply(
            v, x, train=True, rngs={"dropout": rng_drop},
            mutable=["batch_stats"]))(
            to64(variables), jnp.concatenate([jl["point_clouds"],
                                              jw["point_clouds"]]))
        ind, ds = jax_choice(rng_gamma, ep["last_quad_scores"][B:],
                             CFG.num_points)
        out[f"{prefix}/choice_quad"], out[f"{prefix}/choice_points"] = ind, ds


def step_batches(kind):
    """The (labeled, weak) numpy batches of the "sup" or "semi" step."""
    from tests.test_torch_port_semi import augment
    if kind == "sup":
        lab = make_batch(np.random.default_rng(7), B, CFG.num_points)
        return lab, lab
    rng = np.random.default_rng(60)
    lab = augment(make_batch(rng, B, CFG.num_points), rng)
    return lab, augment(make_batch(rng, B, CFG.num_points), rng)


def step_variables(kind, lab):
    """The flax variables (float32, BN noise) a step starts from; the semi
    step's last quad head rigged so that the gamma criterion fires."""
    from tests.test_torch_port_modules import randomised_variables
    from tests.test_torch_port_semi import _rig_last_quad_head
    model = PQTransformer(CFG)
    if kind == "sup":
        return randomised_variables(model, lab["point_clouds"], seed=8)
    return _rig_last_quad_head(
        randomised_variables(model, lab["point_clouds"], seed=61))


def main(path):
    assert jax.config.jax_enable_x64, "run with JAX_ENABLE_X64=1"
    out = {}
    u, k = cross_case()
    out["cross/jax"] = np.asarray(jax.jit(lambda a, b: jnp.einsum(
        "bnc,bmc->bnm", a, b, preferred_element_type=jnp.float32))(u, k))
    u, k = near_tie_case()
    d2, idx = three_nn(jnp.asarray(u), jnp.asarray(k))
    out["three_nn/dist2"], out["three_nn/idx"] = np.asarray(d2), np.asarray(idx)
    with oracle_model_ops():
        _eval_and_grads(out)
        for kind, flags in (("sup", TrainFlags(**SUP)),
                            ("semi", TrainFlags())):
            lab, weak = step_batches(kind)
            _step(out, kind, flags, lab, weak, step_variables(kind, lab))
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
