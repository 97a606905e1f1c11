"""The port's float64 route (`ModelConfig(compute_dtype="float64")`) against
the JAX package's, on the CPU.

The JAX references are the package's float64 route under
`interop.oracle_ops.oracle_model_ops()`, computed once in a process of their
own with 64-bit types on (tests/torch_float64_reference.py), from seeded
numpy inputs and `randomised_variables` weights (BN noise included); the
tests that need none run while it computes. Bounds:

- TINY eval forward: every end point has JAX's dtype, integer keys bitwise,
  float keys within 1e-9 of each key's largest magnitude; with float64
  parameters and again with float32 parameters computed in float64. In the
  second case eval-mode BatchNorm takes rsqrt(var + eps) * scale in float32
  in both packages (flax's `_normalize` on float32 statistics), and ATen's
  float32 rsqrt differs from XLA:CPU's in the last bit, so the port runs
  with XLA's float32 rsqrt values (`xla_float32_rsqrt`): with ATen's its
  worst key reads 1.7e-6, with XLA's 8e-15 (the float32 statistics
  themselves move JAX's forward by 1.5e-7 from its float64-parameter one).
- the gradients of tests/test_torch_parity.py's weighted scalar of end
  points, for every parameter: within 1e-6 of each leaf's largest
  magnitude (that test's own bound), the scalar within 1e-9 relative;
- the float32 control: the port's float32 route against the same float64
  references must fail both bounds, so that they can be seen to bite;
- one supervised step and one TrainFlags() step (EMA teacher and gamma
  mixture, JAX's draw replayed as tests/test_torch_port_semi.py does): the
  loss within 1e-9 relative, every stat within 1e-9 of its magnitude (the
  class-consistency stats 1e-7: they come from the teacher's float32
  softmax, whose last bits differ between XLA and ATen),
  the gradients within 1e-6 of each leaf's scale (at least 1e-9 of the
  gradient norm: a bias before a train-mode BatchNorm has an analytically
  zero gradient, whose roundoff no scale of its own measures), the
  parameters after
  AdamW and the EMA parameters within lr * (c |g - g_jax| / eps + 1e-9)
  elementwise (Adam's first update moves by at most c / eps a unit of
  gradient, c the clip factor; the 1e-9 of lr is the update's own
  arithmetic, which float32 bias corrections would miss by 3e-8), the BN
  running stats within 1e-9.
- unit cases: FPS and the ball query on float64 input bitwise their
  float32-copy results, the grouped xyz and its gradient float64,
  three_nn's float32 cross term on crafted near-ties, the fused SA-MLP's
  gate off under float64, the exports.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from omni_pq_tpu import config as jconfig
from omni_pq_tpu import evals as jevals
from omni_pq_tpu import ops as jops
from omni_pq_tpu.ops import fused_mlp as jfused
from omni_pq_torch import config as tconfig
from omni_pq_torch import ops
from omni_pq_torch.config import SCANNET_MEAN_SIZES, ModelConfig
from omni_pq_torch.infer import (EVAL_CONFIG, build_model, eval_forward,
                                 evaluate_quad_f1, load_model)
from omni_pq_torch.interop import flax_to_state_dict
from omni_pq_torch.losses import gamma
from omni_pq_torch.models.pointnet2 import (BN_MOMENTUM, BatchNorm,
                                            SAModuleVotes, acc_dtype, linear,
                                            torch_dtype)
from omni_pq_torch.models.transformer import LayerNorm
from omni_pq_torch.ops.nn_distance import huber_loss, smoothl1_loss
from omni_pq_torch.train import (OptimizerConfig, TrainFlags, TrainState,
                                 batch_to_tensors, make_train_step)
from omni_pq_torch.train import step as step_module
from tests.test_torch_port_modules import port_config
from tests.torch_float64_reference import (CFG, CFG64, CONSISTENCY_WEIGHT,
                                           SUP, cross_case, eval_batch,
                                           near_tie_case, step_batches)

ROOT = Path(__file__).resolve().parents[1]
F64 = torch.float64
EP_TOL = 1e-9     # end points: of each key's largest magnitude
GRAD_TOL = 1e-6   # gradients: of each leaf's largest magnitude
LOSS_TOL = 1e-9   # the loss / the scalar, relative
STAT_TOL = 1e-9   # the step's other stats, of each stat's magnitude
UPDATE_TOL = 1e-9  # parameters after a step: of lr (see _update_gaps)
# the class-consistency stats: KL against the teacher's softmax, which both
# packages take in float32 (the teacher's targets are float32-ified), where
# XLA's and ATen's float32 exp and log differ in the last bit
TEACHER_STAT_TOL = 1e-7
BN_TOL = 1e-9     # running stats: of each buffer's largest magnitude
# a train step's leaf below this share of the gradient norm is roundoff (a
# bias before a train-mode BatchNorm, analytically 0): it is held to
# GRAD_TOL of this share, not of its own scale
ROUNDOFF = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _reference_process(tmp_path_factory):
    """The JAX references' process, started with the module's first test so
    that the tests that need no reference (first in the file) run while it
    computes."""
    tmp = tmp_path_factory.mktemp("float64_reference")
    out, log = tmp / "ref.npz", tmp / "reference.log"
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tests.torch_float64_reference", str(out)],
            cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)
    try:
        yield proc, out, log
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the reference process and other test workers
    share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(_reference_process):
    proc, out, log = _reference_process
    rc = proc.wait(timeout=1200)
    assert rc == 0, log.read_text()[-4000:]
    with np.load(out) as z:
        return dict(z)


def _sub(ref, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in ref.items() if k.startswith(prefix + "/")}


def _nest(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _rel(got, want):
    """max |got - want| over want's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _end_point_gaps(ep, want):
    """{float key: its gap (of the key's largest magnitude)}; asserts the
    keys, dtypes and the integer keys bitwise."""
    assert set(ep) == set(want)
    gaps = {}
    for k, w in want.items():
        got = _np(ep[k])
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(got, w, err_msg=k)
        else:
            gaps[k] = _rel(got, w)
    return gaps


def _grad_gaps(model, grads, batch_stats, floor=0.0):
    """{parameter: its gradient's gap (of JAX's leaf's largest magnitude,
    at least `floor`)}; a parameter the scalar does not reach has a zero
    gradient."""
    want = flax_to_state_dict({"params": grads, "batch_stats": batch_stats})
    gaps = {}
    for name, p in model.named_parameters():
        got = np.zeros(p.shape) if p.grad is None else _np(p.grad)
        w = want[name].numpy()
        gaps[name] = float(np.abs(got - w).max()
                           / max(np.abs(w).max(), floor, 1e-30))
    return gaps


def _worst(gaps):
    k = max(gaps, key=gaps.get)
    return k, gaps[k]


@pytest.fixture
def xla_float32_rsqrt(monkeypatch):
    """torch.rsqrt with XLA:CPU's values on float32 tensors (see the module
    docstring); other types unchanged."""
    rs = jax.jit(jax.lax.rsqrt)
    real = torch.rsqrt

    def rsqrt(x):
        if x.dtype != torch.float32:
            return real(x)
        return torch.from_numpy(np.array(rs(x.detach().numpy())))
    monkeypatch.setattr(torch, "rsqrt", rsqrt)


# -- no reference needed ------------------------------------------------------

def test_config_and_ops_exports_match_jax():
    assert tconfig.DEFAULT_MODEL == ModelConfig()
    assert tconfig.DEFAULT_DATASET == tconfig.DatasetConfig()
    assert dataclasses.asdict(tconfig.DEFAULT_MODEL) == dataclasses.asdict(
        jconfig.DEFAULT_MODEL)
    assert dataclasses.asdict(tconfig.DEFAULT_DATASET) == dataclasses.asdict(
        jconfig.DEFAULT_DATASET)
    assert ops.huber_loss is huber_loss and ops.smoothl1_loss is smoothl1_loss
    assert {"huber_loss", "smoothl1_loss"} <= set(ops.__all__)
    x = np.random.default_rng(0).normal(size=(4, 50)) * 2
    for fn, jfn in ((ops.huber_loss, jops.huber_loss),
                    (ops.smoothl1_loss, jops.smoothl1_loss)):
        for delta in (1.0, 0.3):
            np.testing.assert_allclose(
                _np(fn(torch.from_numpy(x), delta)),
                np.asarray(jfn(jnp.asarray(x, jnp.float32), delta)),
                rtol=1e-6, atol=1e-6)


def test_compute_dtypes_and_acc_dtype():
    assert torch_dtype("float64") is F64
    assert [acc_dtype(torch_dtype(n)) for n in
            ("float32", "bfloat16", "float64")] == [torch.float32,
                                                    torch.float32, F64]
    with pytest.raises(ValueError, match="float16"):
        torch_dtype("float16")


def _cloud64(seed, batch=2, n=600):
    """float64 points that float32 cannot hold exactly."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(size=(batch, n, 3))
                            * np.array([4.0, 4.0, 2.5]) + 0.5)


def test_fps_and_ball_query_decide_on_float32_copies():
    xyz = _cloud64(0)
    assert not torch.equal(xyz.float().double(), xyz)
    inds = ops.fps(xyz, 64)
    assert torch.equal(inds, ops.fps(xyz.float(), 64))
    assert torch.equal(ops.fps_plain(xyz, 64), inds)
    centres = ops.gather_points(xyz, inds)
    # one centre outside the room: no point in its ball
    centres[1, 5] = torch.tensor([20.0, 20.0, 20.0], dtype=F64)
    idx32 = ops.ball_query(0.4, 16, xyz.float(), centres.float())
    for fn in (ops.ball_query, ops.ball_query_ref):
        assert torch.equal(fn(0.4, 16, xyz, centres), idx32)
    for fn in (ops.ball_query_group, ops.ball_query_group_plain):
        idx, grouped = fn(0.4, 16, xyz, centres)
        assert torch.equal(idx, idx32) and grouped.dtype == F64
        want = (_np(xyz)[np.arange(2)[:, None, None], _np(idx)]
                - _np(centres)[:, :, None, :])
        np.testing.assert_array_equal(_np(grouped), want)
    assert (idx32[1, 5] == 0).all()
    np.testing.assert_array_equal(_np(grouped[1, 5]),
                                  np.tile(_np(xyz[1, 0] - centres[1, 5]),
                                          (16, 1)))
    feats = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 600, 5)))
    idx, grouped, gf = ops.ball_query_group_feats(0.4, 16, xyz, centres, feats)
    assert torch.equal(idx, idx32) and gf.dtype == F64
    np.testing.assert_array_equal(_np(gf), _np(feats)[np.arange(2)[:, None,
                                                                  None],
                                                      _np(idx)])


def test_grouped_xyz_gradient_is_float64():
    """The grouped values' gradient reaches the points (a scatter-add at
    idx) and the centres (minus the K-sum) in float64."""
    xyz = _cloud64(2).requires_grad_()
    centres = ops.gather_points(xyz.detach(), ops.fps(xyz, 32)
                                ).requires_grad_()
    idx, grouped = ops.ball_query_group(0.5, 8, xyz, centres)
    cot = torch.from_numpy(np.random.default_rng(3).normal(
        size=grouped.shape))
    (grouped * cot).sum().backward()
    assert xyz.grad.dtype == F64 and centres.grad.dtype == F64
    want = np.zeros(xyz.shape)
    np.add.at(want, (np.arange(2)[:, None, None], _np(idx)), _np(cot))
    np.testing.assert_allclose(_np(xyz.grad), want, rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(_np(centres.grad), -_np(cot).sum(2),
                               rtol=1e-14, atol=1e-14)


def test_fused_sa_is_gated_off_under_float64():
    assert ops.fused_mlp_supports(16, (128, 256), torch.float32)
    for K, widths in ((16, (128, 256)), (64, (128, 128, 256))):
        assert not ops.fused_mlp_supports(K, widths, F64)
        assert not jfused.supports(K, widths, "float64")
    cfg = dataclasses.replace(port_config(CFG64), backbone_width=2,
                              backbone_nsamples=(16, 16, 16, 16),
                              vote_aggregation_nsample=16)
    pc = eval_batch()["point_clouds"]
    unfused = build_model(cfg, "cpu", seed=4)
    fused = build_model(dataclasses.replace(cfg, fused_sa=True), "cpu",
                        seed=4)
    sa = [m for m in fused.modules() if isinstance(m, SAModuleVotes)]
    assert len(sa) == 5 and all(m.fuse and not m.fused for m in sa)
    assert ops.fused_mlp_supports(16, sa[0].mlp_channels, torch.float32)
    want, got = eval_forward(unfused, pc), eval_forward(fused, pc)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_float32_modules_unchanged_and_float32_parameters_cast_up():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(3, 7, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=8).astype(np.float32))
    assert torch.equal(linear(x, w, b, torch.float32), F.linear(x, w, b))
    got = linear(x.double(), w, b, F64)
    assert got.dtype == F64
    assert torch.equal(got, F.linear(x.double(), w.double(), b.double()))
    ln, ref_ln = LayerNorm(16, eps=1e-5), torch.nn.LayerNorm(16, eps=1e-5)
    scale, shift = rng.uniform(0.5, 1.5, 16), rng.normal(size=16)
    with torch.no_grad():
        for m in (ln, ref_ln):
            m.weight.copy_(torch.from_numpy(scale))
            m.bias.copy_(torch.from_numpy(shift))
    assert torch.equal(ln(x), ref_ln(x))
    got = ln(x.double())
    assert got.dtype == F64
    assert torch.equal(got, ref_ln.double()(x.double()))


def test_float32_running_stats_take_float64_batch_statistics():
    """Train mode on float64 input with float32 parameters and running
    stats: the output is float64 and the running stats become float64, as
    a flax variable takes the promoted type of its update."""
    bn = BatchNorm(6).train()
    x = _cloud64(4, 2, 50)[..., :3].repeat(1, 1, 2)
    old = bn.running_mean.clone(), bn.running_var.clone()
    y = bn(x)
    mean = x.mean(dim=(0, 1))
    var = (x * x).mean(dim=(0, 1)) - mean * mean
    assert y.dtype == F64 and bn.running_mean.dtype == F64
    m = BN_MOMENTUM
    assert torch.equal(bn.running_mean, m * old[0] + (1 - m) * mean)
    assert torch.equal(bn.running_var, m * old[1] + (1 - m) * var)


def test_remat_sa_under_float64_is_the_same_step():
    """remat_sa recomputes the float64 SA chain in the backward: the same
    gradients and running stats, moved once."""
    pc = torch.from_numpy(eval_batch()["point_clouds"]).double()
    outs = []
    for remat in (False, True):
        torch.manual_seed(0)
        sa = SAModuleVotes(64, 0.4, 16, 0, [32, 64], normalize_xyz=True,
                           dtype=F64, remat=remat).double().train()
        with torch.no_grad():
            for p in sa.parameters():
                p.normal_(0.0, 0.3)
        _, f, _ = sa(pc)
        f.square().sum().backward()
        outs.append(({n: p.grad for n, p in sa.named_parameters()},
                     dict(sa.named_buffers()), f.dtype))
    (g0, b0, d0), (g1, b1, d1) = outs
    assert d0 == d1 == F64
    for n in g0:
        assert g1[n].dtype == F64 and torch.equal(g0[n], g1[n]), n
    for n in b0:
        assert torch.equal(b0[n], b1[n]), n


# -- three_nn ------------------------------------------------------------------

def test_three_nn_cross_term_is_the_rounded_float64_product(ref):
    """XLA computes the float64 cross term of JAX's three_nn in float64 and
    rounds the result to float32 (preferred_element_type=float32); it does
    not round the operands. The port takes the same term."""
    u, k = cross_case()
    want = ref["cross/jax"]
    assert want.dtype == np.float32
    rounded_result = np.einsum("bnc,bmc->bnm", u, k).astype(np.float32)
    rounded_operands = np.einsum("bnc,bmc->bnm", u.astype(np.float32),
                                 k.astype(np.float32))
    np.testing.assert_array_equal(want, rounded_result)
    assert (want != rounded_operands).mean() > 0.2
    port = torch.bmm(torch.from_numpy(u),
                     torch.from_numpy(k).transpose(1, 2)).float()
    np.testing.assert_array_equal(_np(port), want)


def test_three_nn_near_tie_picks_what_jax_picks(ref):
    u, k = (torch.from_numpy(a) for a in near_tie_case())
    dist2, idx = ops.three_nn(u, k)
    np.testing.assert_array_equal(_np(idx), ref["three_nn/idx"])
    assert dist2.dtype == F64
    np.testing.assert_allclose(_np(dist2), ref["three_nn/dist2"], rtol=1e-14,
                               atol=0)
    # choosing by the float64 distances themselves picks otherwise
    _, direct = ops.three_nn_ref(u, k)
    assert (direct != idx).any(dim=-1).all()


# -- the TINY forward and its gradients ----------------------------------------

def _eval_variables(ref, dtype):
    v = _nest(_sub(ref, "variables"))
    return jax.tree.map(lambda a: a.astype(dtype), v)


@pytest.mark.parametrize("params", ["float64", "float32"])
def test_eval_forward_matches_jax(ref, params, request):
    if params == "float32":
        request.getfixturevalue("xla_float32_rsqrt")
    dt = np.float64 if params == "float64" else np.float32
    model = load_model(flax_to_state_dict(_eval_variables(ref, dt)),
                       port_config(CFG64), "cpu")
    assert {p.dtype for p in model.parameters()} == {torch.from_numpy(
        np.zeros(0, dt)).dtype}
    ep = eval_forward(model, eval_batch()["point_clouds"])
    want = _sub(ref, "ep" if params == "float64" else "ep32p")
    assert sum(v.dtype == np.float64 for v in want.values()) == 59
    assert sum(v.dtype == np.int32 for v in want.values()) == 4
    gaps = _end_point_gaps(ep, want)
    key, gap = _worst(gaps)
    print(f"{params} parameters: worst end point {key} {gap:.3e}")
    assert gap <= EP_TOL, (key, gap)


def _weighted_scalar(model, ref, dtype):
    pc = torch.as_tensor(eval_batch()["point_clouds"], dtype=dtype)
    model.zero_grad()
    ep = model(pc)
    return ep, sum((ep[k] * torch.from_numpy(w).to(dtype)).mean()
                   for k, w in _sub(ref, "w").items())


def test_gradients_match_jax(ref):
    variables = _eval_variables(ref, np.float64)
    model = load_model(flax_to_state_dict(variables), port_config(CFG64),
                       "cpu")
    _, loss = _weighted_scalar(model, ref, F64)
    loss.backward()
    assert abs(float(loss) - float(ref["loss"])) <= LOSS_TOL * abs(
        float(ref["loss"]))
    gaps = _grad_gaps(model, _nest(_sub(ref, "grad")),
                      variables["batch_stats"])
    assert all(p.grad.dtype == F64 for p in model.parameters()
               if p.grad is not None)
    key, gap = _worst(gaps)
    print(f"worst gradient leaf {key} {gap:.3e} of its scale")
    assert gap <= GRAD_TOL, (key, gap)


def test_float32_control_fails_both_bounds(ref):
    """The float32 route on the float32 parameters, held to the float64
    references with the same bounds: both fail."""
    variables = _eval_variables(ref, np.float32)
    model = load_model(flax_to_state_dict(variables), port_config(CFG),
                       "cpu")
    ep, loss = _weighted_scalar(model, ref, torch.float32)
    loss.backward()
    want = _sub(ref, "ep")
    assert {k for k, v in ep.items() if v.dtype == torch.float32} == {
        k for k, v in want.items() if v.dtype == np.float64}
    ep_gap = _worst({k: _rel(_np(ep[k]), w) for k, w in want.items()
                     if w.dtype.kind == "f"})
    grad_gap = _worst(_grad_gaps(model, _nest(_sub(ref, "grad")),
                                 variables["batch_stats"]))
    print(f"float32 control: end point {ep_gap}, gradient {grad_gap}")
    assert ep_gap[1] > EP_TOL and grad_gap[1] > GRAD_TOL


def test_decode_of_float64_end_points_matches_jax(ref):
    model = load_model(flax_to_state_dict(_eval_variables(ref, np.float64)),
                       port_config(CFG64), "cpu")
    batch = eval_batch()
    got = evaluate_quad_f1(eval_forward(model, batch["point_clouds"]), batch)
    merged = {**_sub(ref, "ep"), **batch}
    _, mask, corners = jevals.parse_quad_predictions(merged, EVAL_CONFIG,
                                                     "last_")
    np.testing.assert_array_equal(got["pred_mask"], mask)
    for a, b in zip(got["pred_corners"], corners):
        assert len(a) == len(b)
        if b:
            np.testing.assert_allclose(np.stack(a), np.stack(b), rtol=1e-9,
                                       atol=1e-9)


# -- whole steps -----------------------------------------------------------------

def _run_step(ref, kind, flags, monkeypatch):
    variables = _nest(_sub(ref, f"{kind}/variables"))
    v64 = jax.tree.map(lambda a: a.astype(np.float64), variables)
    model = load_model(flax_to_state_dict(v64), port_config(CFG64), "cpu")
    state = TrainState(model, OptimizerConfig(), ema=flags.ema)
    if flags.gamma_mixture:
        choice = (ref[f"{kind}/choice_quad"], ref[f"{kind}/choice_points"])
        monkeypatch.setattr(step_module, "gamma_mixture_guide_criterion",
                            functools.partial(
                                gamma.gamma_mixture_guide_criterion,
                                choice=choice))
    lab, weak = step_batches(kind)
    step = make_train_step(model, port_config(CFG64), SCANNET_MEAN_SIZES,
                           flags)
    stats = step(state, batch_to_tensors(lab, "cpu", F64),
                 batch_to_tensors(weak, "cpu", F64),
                 consistency_weight=CONSISTENCY_WEIGHT)
    return state, stats, v64["batch_stats"]


def _update_gaps(params, want, grads, state, grad_norm):
    """{parameter: its largest gap to JAX's value after the step (`want`),
    over the bound lr * (c |g - g_jax| / eps + UPDATE_TOL)}: Adam's first
    update u = c g / (c |g| + eps) (c the clip factor) moves by at most
    c / eps per unit of gradient, so a gradient gap (held by its own bound)
    reaches the parameter through that factor, and anything beyond it is
    the update's own arithmetic (the bias corrections, the clip, the
    decay). `params` are the student's or the EMA replica's, by name."""
    opt = state.optimizer
    lr = {id(p): g["schedule"](0) for g in opt.param_groups
          for p in g["params"]}
    eps = opt.param_groups[0]["eps"]
    c = min(1.0, opt.clip_norm / grad_norm)
    gaps = {}
    for name, p in state.model.named_parameters():
        bound = lr[id(p)] * (c * np.abs(_np(p.grad) - grads[name].numpy())
                             / eps + UPDATE_TOL)
        gaps[name] = float((np.abs(_np(params[name]) - want[name].numpy())
                            / bound).max())
    return gaps


def _assert_step(ref, kind, state, stats, batch_stats):
    model = state.model
    stats_j = _sub(ref, f"{kind}/stats")
    assert set(stats) == set(stats_j)
    assert stats["total_loss"].dtype == F64
    loss_gap = _rel(_np(stats["total_loss"]), stats_j["total_loss"])
    stat_gaps = {k: abs(float(stats[k]) - float(v)) / max(abs(float(v)),
                                                          1e-12)
                 for k, v in stats_j.items()}
    teacher_gap = _worst({k: stat_gaps.pop(k) for k in list(stat_gaps)
                          if "class_consistency" in k} or {"-": 0.0})
    stat_gap = _worst(stat_gaps)
    grad_norm = float(stats_j["grad_norm"])
    grads_j = _nest(_sub(ref, f"{kind}/grads"))
    grad_gap = _worst(_grad_gaps(model, grads_j, batch_stats,
                                 ROUNDOFF * grad_norm))
    want_g = flax_to_state_dict({"params": grads_j,
                                 "batch_stats": batch_stats})
    want = flax_to_state_dict({"params": _nest(_sub(ref, f"{kind}/new_params")),
                               "batch_stats": _nest(_sub(
                                   ref, f"{kind}/new_batch_stats"))})
    upd_gap = _worst(_update_gaps(dict(model.named_parameters()), want,
                                  want_g, state, grad_norm))
    bn = {n: b for n, b in model.named_buffers()
          if n.endswith(("running_mean", "running_var"))}
    assert all(b.dtype == F64 for b in bn.values())
    bn_gap = _worst({n: _rel(b, want[n]) for n, b in bn.items()})
    gaps = dict(loss=loss_gap, stat=stat_gap, teacher_stat=teacher_gap,
                grad=grad_gap, update=upd_gap, bn=bn_gap)
    if state.ema_model is not None:
        want_ema = flax_to_state_dict({
            "params": _nest(_sub(ref, f"{kind}/new_ema_params")),
            "batch_stats": _nest(_sub(ref, f"{kind}/new_ema_batch_stats"))})
        gaps["ema"] = _worst(_update_gaps(
            dict(state.ema_model.named_parameters()), want_ema, want_g,
            state, grad_norm))
        gaps["ema_bn"] = _worst({n: _rel(b, want_ema[n]) for n, b in
                                 state.ema_model.named_buffers()
                                 if n in bn})
    print(f"{kind} step gaps: {gaps}")
    assert loss_gap <= LOSS_TOL and stat_gap[1] <= STAT_TOL
    assert teacher_gap[1] <= TEACHER_STAT_TOL
    assert grad_gap[1] <= GRAD_TOL and upd_gap[1] <= 1.0
    assert bn_gap[1] <= BN_TOL
    if "ema" in gaps:
        assert gaps["ema"][1] <= 1.0 and gaps["ema_bn"][1] <= BN_TOL


def test_supervised_step_matches_jax(ref, monkeypatch):
    state, stats, bs = _run_step(ref, "sup", TrainFlags(**SUP), monkeypatch)
    _assert_step(ref, "sup", state, stats, bs)


def test_semi_step_matches_jax(ref, monkeypatch):
    state, stats, bs = _run_step(ref, "semi", TrainFlags(), monkeypatch)
    assert float(stats["gamma_engaged_frac"]) > 0  # the criterion fired
    _assert_step(ref, "semi", state, stats, bs)
