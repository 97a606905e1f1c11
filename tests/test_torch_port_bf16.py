"""The port's bfloat16 compute route (`ModelConfig.compute_dtype="bfloat16"`)
against the JAX package's, on the CPU.

The JAX side runs once, in a process of its own
(`tests/torch_bf16_reference.py`, with `--xla_allow_excess_precision=false`:
XLA:CPU otherwise drops some bfloat16 roundings the JAX code asks for, e.g.
a Dense-with-bias output feeding a float32 BatchNorm, measured 0.8-1.3x the
noise floor below at the backbone and voting keys). It writes the bfloat16
results, the float32 results on the same inputs and weights, and the
vote-aggregation FPS picks of each bfloat16 run. The port runs here on the
same numpy inputs and weights (`flax_to_state_dict`).

Tolerances are fractions of the bfloat16 noise floor, which the reference
measures in every run: for each output, the JAX bfloat16 route against the
JAX float32 route, as a norm-relative gap |j16 - j32| / |j32| and an
elementwise gap max|j16 - j32|. The port's bfloat16 result is held to JAX's
at a stated fraction of each, written below. The two packages round at the
same places; they differ where a float32 value before a rounding to
bfloat16 differs in its last bits (a sum in another order), which flips that
rounding by one bfloat16 ulp now and then. Two primitives differ in every
last bit: XLA:CPU's rsqrt is its own approximation (it differs from ATen's
on ~36 % of float32 inputs), so the BatchNorm multipliers and LayerNorms
differ by an ulp in a third of the channels and flip roundings across whole
channels; measured with them as they are, the port's whole forward sits at
0.7-1.8x the floor at every key. The tests therefore replay XLA's rsqrt
values into the port (`torch.rsqrt` returns them, with torch's gradient)
and its LayerNorm arithmetic (flax's fast variance), as the other port tests
replay JAX's random draws, and replay JAX's vote-aggregation picks where the
port's own differ (counted and printed). Measured with the replays (the
ratios of each output's gap to its floor):
- the fused chain (plain and Pallas): pooled <= 0.02 norm, one flipped ulp
  at most (elementwise <= 1.0); held at 0.1 and 1.0;
- single modules (voting, heads, attention, a decoder layer): norm <= 0.3;
  held at 0.5 norm and 1.5 elementwise (a flipped ulp of an output is as
  large as the floor's largest elementwise gap); each test also runs its
  module in float32 (the control), which reads ~1.0 of the floor and must
  fall outside the 0.5;
- the whole eval forward: backbone, voting, vote aggregation and proposal
  keys norm <= 0.3, elementwise <= 0.86, held at 0.5 and 1.5; the decoder's
  keys (`{i}head_`, `last_`) norm up to 0.96, elementwise up to 1.56
  (attention over 16 random queries amplifies each flip), each held at 1.5
  and 2.5 (a gross fault), and their median norm ratio (0.57 unfused, 0.53
  fused) at 0.75, which the control, the decoder and heads in float32
  (median 0.98), must exceed;
- train steps: train-mode BatchNorm takes batch statistics, sums in
  another order on each side, whose last bits flip roundings across the
  next layer (the port's train-mode features sit at 0.2-0.4 of the floor
  from sa2 on), and a single scalar's own floor is one random sample (the
  bfloat16 and float32 errors of a loss cancel or add by chance). So a
  step's floor is the largest relative gap |j16 - j32| / |j16| over its
  stats (the supervised step: 4.3 %, grad_norm; the EMA-teacher step's
  consistency stats: 13 %), and the largest gap over all BN running
  statistics it writes:
  - the supervised step with a bfloat16 student: every stat within 1.0 of
    that relative floor (measured 0.91, grad_norm: a gross fault only, since
    a float32 student passes it too); the median over the stats of the gap
    over that stat's own gap |j16 - j32| within 0.5 (measured 0.23; a few
    stats whose own gap is small by chance read 3-7), and the BN running
    stats within 0.5 of theirs (measured 0.10). The control, the same step
    with a float32 student, reads 1.00 on both and must fail them;
  - the EMA-teacher step with a bfloat16 teacher: the consistency stats
    against JAX's (its float32 student against its bfloat16 teacher, as
    its step with teacher_bf16 computes them: equal to that step's to the
    last bit) within 0.5 of their floor (against JAX's float32 teacher;
    measured 0.25), the teacher's BN running stats within 0.5 (measured
    0.38); the float32 rest of the step is tests/test_torch_port_semi.py's;
- dtypes: every end point has the dtype JAX gives it.
"""
import contextlib
import dataclasses
import json
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

from omni_pq_tpu.models import PQTransformer as JaxPQTransformer
from omni_pq_tpu.ops import fused_mlp as jfused
from omni_pq_torch import ops
from omni_pq_torch.cli import infer as infer_cli
from omni_pq_torch.cli import train as train_cli
from omni_pq_torch.config import SCANNET_MEAN_SIZES, SMOKE_MODEL, ModelConfig
from omni_pq_torch.data import make_scene
from omni_pq_torch.infer import build_model, eval_forward, load_model
from omni_pq_torch.interop import flax_to_state_dict
from omni_pq_torch.models import (MultiHeadAttention, PredictHead,
                                  QuadPredictHead, TransformerDecoderLayer,
                                  VotingModule)
from omni_pq_torch.models.pointnet2 import with_compute_dtype
from omni_pq_torch.ops import fused_mlp as tfused
from omni_pq_torch.train import (OptimizerConfig, TrainFlags, TrainState,
                                 batch_to_tensors, make_train_step)
from tests.test_torch_port_modules import port_config
from tests.torch_bf16_reference import CFG, CHAIN_SHAPES, EPS, chain_inputs

ROOT = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16
# fractions of the noise floor (norm-relative, elementwise); see above
CHAIN_FRACTION = (0.1, 1.0)
MODULE_FRACTION = (0.5, 1.5)
FORWARD_FRACTION = (0.5, 1.5)
DECODER_FRACTION = (1.5, 2.5)
DECODER_MEDIAN = 0.75  # the decoder keys' median norm-relative ratio
STEP_FRACTIONS = (1.0, 0.5)  # supervised step, EMA-teacher step
SUP_STEP_MEDIAN = 0.5  # the supervised step's median ratio to a stat's own
SUP_STEP_BN = 0.5  # the supervised step's BN running stats


@pytest.fixture(scope="module", autouse=True)
def _reference_process(tmp_path_factory):
    """The JAX references' process, started with the module's first test so
    that the tests that need no reference (the gate, the weight bridge, the
    dtype switch, the CLIs: first in the file) run while it computes."""
    tmp = tmp_path_factory.mktemp("bf16_reference")
    out, log = tmp / "ref.npz", tmp / "reference.log"
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    env["JAX_PLATFORMS"] = "cpu"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tests.torch_bf16_reference", str(out)],
            cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)
    try:
        yield proc, out, log
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def ref(_reference_process):
    """The JAX references, computed once in their own process."""
    proc, out, log = _reference_process
    rc = proc.wait(timeout=1200)
    assert rc == 0, log.read_text()[-4000:]
    with np.load(out) as z:
        return dict(z)


def _sub(ref, prefix):
    """{rest of the key: array} of the keys under `prefix/`; a bfloat16
    array (stored as float32) keeps its '@bf16' mark."""
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


def _variables(ref):
    return _nest(_sub(ref, "variables"))


def _np(t):
    t = t.detach() if torch.is_tensor(t) else t
    if torch.is_tensor(t):
        return t.float().numpy() if t.is_floating_point() else t.numpy()
    return np.asarray(t)


def _gaps(got, want):
    """(norm-relative gap, largest elementwise gap) of got against want."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = got - want
    return (float(np.linalg.norm(d) / max(np.linalg.norm(want), 1e-30)),
            float(np.abs(d).max()) if d.size else 0.0)


def _assert_within_floor(what, got, want, floor_ref, fraction):
    """got (the port, bfloat16) against want (JAX, bfloat16) within the
    fractions of the floor, want against floor_ref (JAX, float32)."""
    rel, worst = _gaps(got, want)
    f_rel, f_worst = _gaps(want, floor_ref)
    assert rel <= fraction[0] * f_rel + 1e-7 and \
        worst <= fraction[1] * f_worst + 1e-7, (
            f"{what}: gap {rel:.3e} / {worst:.3e} against the floor "
            f"{f_rel:.3e} / {f_worst:.3e} (fractions {fraction})")


@pytest.fixture
def xla_primitives(monkeypatch):
    """torch.rsqrt with XLA:CPU's rsqrt values (torch's gradient) and
    LayerNorm in flax's arithmetic with it: see the module docstring."""
    rs = jax.jit(jax.lax.rsqrt)
    real = torch.rsqrt

    def rsqrt(x):
        got = real(x)
        val = torch.from_numpy(np.array(rs(
            x.detach().float().numpy()))).to(x.dtype)
        return got + (val - got).detach()

    def layer_norm(x, shape, weight=None, bias=None, eps=1e-5):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp_min((x * x).mean(-1, keepdim=True) - mean * mean,
                              0.0)
        return (x - mean) * (rsqrt(var + eps) * weight) + bias
    monkeypatch.setattr(torch, "rsqrt", rsqrt)
    monkeypatch.setattr(F, "layer_norm", layer_norm)


class _Picks:
    """The port's ops.fps returning given picks at given calls (counted
    from 1), and keeping what its own picks would have been."""

    def __init__(self, monkeypatch, picks):
        self.picks, self.n, self.moved = picks, 0, 0
        real = ops.fps

        def fps(xyz, npoint):
            self.n += 1
            own = real(xyz, npoint)
            if self.n not in self.picks:
                return own
            want = torch.from_numpy(self.picks[self.n])
            self.moved += int((own != want).sum())
            return want
        monkeypatch.setattr(ops, "fps", fps)


# -- the gate ----------------------------------------------------------------

@pytest.mark.parametrize("K,channels,dtype", [
    (16, (128, 256), "bfloat16"), (48, (128, 128, 256), "bfloat16"),
    (24, (128, 256), "bfloat16"), (24, (128, 256), "float32"),
    (8, (128,), "bfloat16"), (32, (288, 288), "bfloat16"),
    (16, (128, 256), "float16"), (16, (128, 256), "float64")])
def test_gate_matches_jax(K, channels, dtype):
    """The port routes to the fused kernels exactly what JAX's `supports`
    does: float32 at K % 8, bfloat16 at K % 16, widths % 128."""
    assert tfused.supports(K, channels, getattr(torch, dtype)) is \
        jfused.supports(K, channels, getattr(jnp, dtype))


@pytest.mark.parametrize("a_shape,b_shape,transposed", [
    ((2, 3, 5, 4), (4, 6), False), ((2, 3, 5, 4), (2, 3, 4, 6), False),
    ((7, 4), (6, 4), True)])
def test_f32_sum_matmul_function_gradients(a_shape, b_shape, transposed):
    """The autograd Function that a bfloat16 product runs on the card
    (`ops.matmul.matmul`, and `linear` as x @ w.T): its forward is
    torch.matmul's and its two backward products are the gradients
    (gradcheck, float64 on the CPU)."""
    from omni_pq_torch.ops.matmul import _Matmul
    gen = torch.Generator().manual_seed(0)
    a, b = (torch.randn(*shape, generator=gen, dtype=torch.float64,
                        requires_grad=True) for shape in (a_shape, b_shape))

    def fn(a, b):
        return _Matmul.apply(a, b.T if transposed else b)
    torch.testing.assert_close(
        fn(a, b), torch.matmul(a, b.T if transposed else b), rtol=0, atol=0)
    assert torch.autograd.gradcheck(fn, (a, b))


# -- weights, the dtype switch, the CLIs --------------------------------------

def test_bridge_carries_float32_weights_unchanged():
    """A bfloat16 JAX model keeps float32 parameters and BN state, so the
    weight bridge carries them as they are: the same state_dict as the
    float32 model's, every tensor float32, and a bfloat16 port model
    holds exactly those tensors."""
    pc = np.zeros((1, 256, 3), np.float32) + 1.0
    cfg = dataclasses.replace(CFG, num_points=256)
    v16, v32 = (jax.jit(JaxPQTransformer(dataclasses.replace(
        cfg, compute_dtype=d)).init)(jax.random.PRNGKey(0), pc)
        for d in ("bfloat16", "float32"))
    sd16 = flax_to_state_dict(jax.tree.map(np.asarray, v16))
    sd32 = flax_to_state_dict(jax.tree.map(np.asarray, v32))
    assert set(sd16) == set(sd32)
    for k, t in sd16.items():
        assert t.dtype == sd32[k].dtype and torch.equal(t, sd32[k]), k
        assert not t.is_floating_point() or t.dtype == torch.float32, k
    model = load_model(sd16, port_config(dataclasses.replace(
        cfg, compute_dtype="bfloat16")), "cpu")
    for k, t in model.state_dict().items():
        assert torch.equal(t, sd16[k]), k


def test_with_compute_dtype_switches_and_restores():
    """with_compute_dtype switches every module that has a compute dtype
    (and only those: the output heads and position embeddings stay without
    one), and restores them on exit, also after an error."""
    model = build_model(ModelConfig(num_points=512, **SMOKE_MODEL), "cpu")
    had = {n: m.compute_dtype for n, m in model.named_modules()
           if hasattr(m, "compute_dtype")}
    assert model.proposal.center_head.compute_dtype is None
    assert model.vote.conv1.compute_dtype == torch.float32
    with pytest.raises(RuntimeError, match="inside"):
        with with_compute_dtype(model, BF16):
            assert model.vote.conv1.compute_dtype == BF16
            assert model.backbone.sa1.mlp_module.layer0.bn.bn.compute_dtype \
                == BF16
            assert model.vote.bn1.compute_dtype is None  # float32 output
            assert model.proposal.center_head.compute_dtype is None
            raise RuntimeError("inside")
    assert {n: m.compute_dtype for n, m in model.named_modules()
            if hasattr(m, "compute_dtype")} == had
    assert isinstance(model.vote, VotingModule)
    assert {type(model.decoder[0]), type(model.proposal),
            type(model.quad_proposal), type(model.decoder[0].self_attn)} == {
        TransformerDecoderLayer, PredictHead, QuadPredictHead,
        MultiHeadAttention}


def test_infer_cli_computes_in_bf16_on_cpu(tmp_path, monkeypatch):
    """cli.infer builds its model at bfloat16 compute, with or without
    --bf16 (as the JAX infer CLI), and writes its detections."""
    cfg = ModelConfig(num_points=512, **SMOKE_MODEL)
    torch.save(build_model(cfg, "cpu", seed=2).state_dict(),
               tmp_path / "w.pth")
    np.save(tmp_path / "scene.npy",
            make_scene(np.random.default_rng(0), 2000)["point_clouds"])
    seen = []
    from omni_pq_torch import infer as infer_module
    real = infer_module.load_model

    def spy(sd, cfg, device):
        seen.append(cfg.compute_dtype)
        return real(sd, cfg, device)
    monkeypatch.setattr(infer_module, "load_model", spy)
    for extra in ([], ["--bf16"]):
        out = tmp_path / f"det{len(extra)}.json"
        quads, objects = infer_cli.main([
            "--checkpoint_path", str(tmp_path / "w.pth"),
            "--input", str(tmp_path / "scene.npy"), "--output", str(out),
            "--num_point", "512", "--smoke", "--device", "cpu",
            "--quad_conf", "0.0", "--obj_conf", "0.0", *extra])
        assert json.loads(out.read_text())["quads"] == quads
        assert len(quads) > 0
    assert seen == ["bfloat16", "bfloat16"]


@pytest.mark.parametrize("flags,dtype,teacher", [
    ([], "bfloat16", False), (["--bf16"], "bfloat16", False),
    (["--f32"], "float32", False),
    (["--ema", "--teacher_bf16"], "bfloat16", True),
    (["--f32", "--ema", "--teacher_bf16"], "float32", True)])
def test_train_cli_bf16_flags_on_cpu(tmp_path, monkeypatch, flags, dtype,
                                     teacher):
    """cli.train computes in bfloat16 unless --f32, as the JAX CLI; its
    --teacher_bf16 reaches TrainFlags. One epoch at the --smoke size:
    finite losses."""
    from omni_pq_torch import data as data_pkg
    from omni_pq_torch import train as train_pkg
    seen = {}
    real_step = train_pkg.make_train_step

    def spy(model, cfg, mean_size_arr, tflags):
        seen.update(dtype=cfg.compute_dtype, teacher=tflags.teacher_bf16,
                    model=next(m.compute_dtype for m in model.modules()
                               if getattr(m, "compute_dtype", None)
                               is not None))
        return real_step(model, cfg, mean_size_arr, tflags)
    monkeypatch.setattr(train_pkg, "make_train_step", spy)
    # 4 scenes an epoch (2 steps) instead of 32: bfloat16 on the CPU is slow
    real_ds = data_pkg.SyntheticDataset
    monkeypatch.setattr(data_pkg, "SyntheticDataset",
                        lambda n, *a, **kw: real_ds(4, *a, **kw))
    train_cli.main([
        "--smoke", "--synthetic_data", "--num_point", "512", "--device",
        "cpu", "--max_epoch", "1", "--end_proportion", "1.0",
        "--print_freq", "1", "--batch_size", "2", "--pc_loss",
        "--log_dir", str(tmp_path), *flags])
    assert seen == {"dtype": dtype, "teacher": teacher,
                    "model": getattr(torch, dtype)}
    last = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()
            if "train/total_loss" in line][-1]
    assert (np.isfinite(last["train/total_loss"])
            and np.isfinite(last["train/grad_norm"]))


# -- the fused chain ---------------------------------------------------------

@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("name", sorted(CHAIN_SHAPES))
def test_fused_chain_bf16_matches_jax(ref, name, mode):
    """The port's plain bfloat16 chain and its fused op (on the CPU the
    plain version inside the autograd Function, backward by recompute)
    against JAX's plain_mlp_pool and its Pallas kernel in interpret mode:
    pooled output (bfloat16), batch statistics, and the gradients of
    sum(pooled * cot)."""
    g, ks, ss, bs, rm, rv, cot = chain_inputs(name)
    train = mode == "train"
    base = f"chain/{name}/{mode}"
    j16, j32 = (_sub(ref, f"{base}/plain/{d}") for d in ("bfloat16",
                                                          "float32"))
    pallas = _sub(ref, f"{base}/pallas/bfloat16")
    t = lambda a: torch.from_numpy(a).requires_grad_()  # noqa: E731
    for fn in (tfused.plain_mlp_pool, "op"):
        leaves = [t(g)] + [t(a) for a in ks + ss + bs]
        L = len(ks)
        args = (leaves[0], leaves[1:1 + L], leaves[1 + L:1 + 2 * L],
                leaves[1 + 2 * L:], [torch.from_numpy(a) for a in rm],
                [torch.from_numpy(a) for a in rv])
        if fn == "op":
            pooled, means, variances = ops.fused_mlp_pool(
                *args, train=train, eps=EPS, dtype=BF16)
        else:
            pooled, means, variances = fn(*args, train, EPS, BF16)
        assert pooled.dtype == BF16
        (pooled.float() * torch.from_numpy(cot)).sum().backward()
        for want in (j16, pallas):
            _assert_within_floor(f"{name} {mode} pooled", _np(pooled),
                                 want["out/0@bf16"], j32["out/0"],
                                 CHAIN_FRACTION)
            for i in range(len(means)):
                for j, got in ((1, means[i]), (2, variances[i])):
                    _assert_within_floor(
                        f"{name} {mode} stat {j}/{i}", _np(got),
                        want[f"out/{j}/{i}"], j32[f"out/{j}/{i}"],
                        CHAIN_FRACTION)
        assert len(means) == (L if train else 0)
        grads = [leaves[0].grad] + [a.grad for a in leaves[1:]]
        keys = (["grads/0"] + [f"grads/{p}/{i}" for p in (1, 2, 3)
                               for i in range(L)])
        for k, got in zip(keys, grads):
            _assert_within_floor(f"{name} {mode} {k}", _np(got), j16[k],
                                 j32[k], MODULE_FRACTION)


# -- single modules ----------------------------------------------------------

@pytest.fixture(scope="module")
def port_model(ref):
    """The port's bfloat16 model on the reference's variables."""
    cfg = port_config(dataclasses.replace(CFG, compute_dtype="bfloat16"))
    return load_model(flax_to_state_dict(_variables(ref)), cfg, "cpu")


@pytest.mark.parametrize("module", ["vote", "mha", "decoder_layer", "head",
                                    "quad_head"])
def test_module_bf16_matches_jax(ref, port_model, xla_primitives, module):
    """Each bfloat16 module of the model on its own parameters: every
    output against JAX's bfloat16 module within a fraction of the floor,
    and with JAX's dtype; the same module computing in float32 is outside
    that fraction (a control: the bound tells the two apart)."""
    x = {k: torch.from_numpy(v) for k, v in _sub(ref, "module/in").items()}
    m = port_model

    def run():
        if module == "vote":
            out = m.vote(x["seed_xyz"], x["seed_feat"].to(BF16))
            return {"0": out[0], "1": out[1]}
        if module == "mha":
            return {"out": m.decoder[0].multihead_attn(x["q"], x["kv"],
                                                       x["kv"])}
        if module == "decoder_layer":
            return {"out": m.decoder[0](x["q"], x["kv"], x["qpos"],
                                        x["kpos"])}
        head = m.proposal if module == "head" else m.quad_proposal
        return head(x["head_in"], x["base"], "p_")[2]
    with torch.no_grad():
        got = run()
    j16, j32 = (_sub(ref, f"module/{d}/{module}") for d in ("bf16", "f32"))
    assert {k.removesuffix("@bf16") for k in j16} == set(got)
    for k, t in got.items():
        bf = f"{k}@bf16" in j16  # JAX's output is bfloat16
        assert (t.dtype == BF16) == bf, (module, k, t.dtype)
        _assert_within_floor(f"{module} {k}", _np(t),
                             j16[f"{k}@bf16" if bf else k], j32[k],
                             MODULE_FRACTION)
    # the control: the same module computing in float32 falls outside the
    # norm-relative bound at some output
    part = {"vote": m.vote, "mha": m.decoder[0].multihead_attn,
           "decoder_layer": m.decoder[0], "head": m.proposal,
           "quad_head": m.quad_proposal}[module]
    with torch.no_grad(), with_compute_dtype(part, torch.float32):
        ctrl = run()
    assert any(
        _gaps(_np(t), j16.get(k, j16.get(f"{k}@bf16")))[0]
        > MODULE_FRACTION[0] * _gaps(j16.get(k, j16.get(f"{k}@bf16")),
                                     j32[k])[0]
        for k, t in ctrl.items()), f"{module}: float32 passes the bound"


# -- the whole eval forward --------------------------------------------------

def _decoder_key(k):
    return k.startswith("last_") or k.split("_")[0].endswith("head")


def _decoder_median(ep, j16, j32):
    """The median over the decoder's float keys of the port's norm-relative
    gap to JAX's bfloat16 over the floor's (those with a floor)."""
    ratios = []
    for k, t in ep.items():
        if t.is_floating_point() and _decoder_key(k):
            want = j16.get(k, j16.get(f"{k}@bf16"))
            floor = _gaps(want, j32[k])[0]
            if floor > 0:
                ratios.append(_gaps(_np(t), want)[0] / floor)
    return float(np.median(ratios))


@pytest.mark.parametrize("route", ["unfused", "fused"])
def test_eval_forward_bf16_matches_jax(ref, xla_primitives, monkeypatch,
                                       route):
    """The whole bfloat16 eval forward, fused and unfused: every end point
    with JAX's dtype, indices bitwise, floats within a fraction of the
    floor (JAX's vote-aggregation picks replayed; how many of the port's own
    picks differ is printed)."""
    cfg = port_config(dataclasses.replace(CFG, compute_dtype="bfloat16",
                                          fused_sa=route == "fused"))
    model = load_model(flax_to_state_dict(_variables(ref)), cfg, "cpu")
    assert [n for n, mod in model.named_modules()
            if getattr(mod, "fused", False)] == (
        [f"backbone.sa{i}" for i in range(1, 5)] if route == "fused" else [])
    base = f"forward/{route}"
    picks = _Picks(monkeypatch, {6: ref[f"{base}/picks"]})
    before = ops.fused_mlp_pool.launches
    ep = eval_forward(model, ref["pc"])
    assert ops.fused_mlp_pool.launches == before  # the CPU launches nothing
    print(f"[bf16 forward {route}] vote-aggregation picks of the port's own "
          f"that differ from JAX's: {picks.moved} of "
          f"{ref[f'{base}/picks'].size}; JAX float32's own that differ from "
          f"its bfloat16's: {int(ref[f'{base}/float32_own_picks_moved'])}")
    dtypes = dict(s.split("=") for s in ref[f"{base}/dtypes"])
    assert set(ep) == set(dtypes)
    j16, j32 = _sub(ref, f"{base}/bf16"), _sub(ref, f"{base}/f32")
    for k, t in ep.items():
        assert str(t.dtype).removeprefix("torch.") == dtypes[k], k
        want = j16.get(k, j16.get(f"{k}@bf16"))
        if not t.is_floating_point():
            np.testing.assert_array_equal(t.numpy(), want, err_msg=k)
            continue
        frac = DECODER_FRACTION if _decoder_key(k) else FORWARD_FRACTION
        _assert_within_floor(k, _np(t), want, j32[k], frac)
    assert _decoder_median(ep, j16, j32) <= DECODER_MEDIAN
    # the control: the decoder and its heads computing in float32 put the
    # decoder keys' median outside the bound
    with contextlib.ExitStack() as stack:
        for part in (model.decoder, model.prediction_heads,
                     model.prediction_quad_heads):
            stack.enter_context(with_compute_dtype(part, torch.float32))
        ctrl = eval_forward(model, ref["pc"])
    assert _decoder_median(ctrl, j16, j32) > DECODER_MEDIAN


# -- train steps --------------------------------------------------------------

def _batch(ref, which):
    return batch_to_tensors(_sub(ref, f"batch/{which}"), "cpu")


def _relative_floor(j16, j32, keys):
    """The step's bfloat16 noise floor: the largest relative gap between
    JAX's bfloat16 and float32 values of `keys` (those not 0)."""
    return max(abs(float(j16[k]) - float(j32[k])) / abs(float(j16[k]))
               for k in keys if float(j16[k]) != 0)


def _assert_step_stats(stats, j16, floor, fraction, keys):
    for k in keys:
        gap = abs(float(stats[k]) - float(j16[k]))
        assert gap <= fraction * floor * abs(float(j16[k])) + 1e-6, (
            k, float(stats[k]), float(j16[k]), floor)


def _assert_bn_within_floor(model, bn16, bn32, fraction):
    """Every BN running statistic the step wrote within `fraction` of the
    step's floor for them: the largest gap between JAX's bfloat16 and
    float32 steps over all of them."""
    names = [n for n, _ in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    floor = max(float((bn16[n] - bn32[n]).abs().max()) for n in names)
    bufs = dict(model.named_buffers())
    gap = max(float((bufs[n] - bn16[n]).abs().max()) for n in names)
    assert gap <= fraction * floor, (gap, floor)


def _sup_step(ref, monkeypatch, compute_dtype):
    """The model and stats of one supervised step (the TINY model at
    `compute_dtype`, dropout 0) from the reference's weights and batch."""
    cfg = port_config(dataclasses.replace(CFG, compute_dtype=compute_dtype))
    model = load_model(flax_to_state_dict(_variables(ref)), cfg, "cpu")
    state = TrainState(model, OptimizerConfig())
    step = make_train_step(model, cfg, SCANNET_MEAN_SIZES,
                           TrainFlags(ema=False, gamma_mixture=False,
                                      arkit=False))
    _Picks(monkeypatch, {6: ref["sup/picks"]})
    return model, step(state, _batch(ref, "labeled"))


def _median_own_ratio(stats, j16, j32):
    """The median over the stats JAX's two routes give apart of the port's
    gap to JAX's bfloat16 value over that stat's own floor."""
    return float(np.median([
        abs(float(stats[k]) - float(j16[k]))
        / abs(float(j32[k]) - float(j16[k]))
        for k in j16 if float(j32[k]) != float(j16[k])]))


def test_supervised_step_bf16_student_matches_jax(ref, xla_primitives,
                                                  monkeypatch):
    """One supervised step with a bfloat16 student: every stat within
    STEP_FRACTIONS[0] of the step's relative floor (a gross fault), the
    median of the stats' gaps over their own floors within SUP_STEP_MEDIAN,
    and the BN running statistics within SUP_STEP_BN of their floor. The
    control, the same step with a float32 student, is outside both of the
    latter (the bounds tell the two apart)."""
    model, stats = _sup_step(ref, monkeypatch, "bfloat16")
    j16, j32 = _sub(ref, "sup/bf16/stats"), _sub(ref, "sup/f32/stats")
    assert set(stats) == set(j16)
    floor = _relative_floor(j16, j32, j16)
    _assert_step_stats(stats, j16, floor, STEP_FRACTIONS[0], j16)
    assert _median_own_ratio(stats, j16, j32) <= SUP_STEP_MEDIAN
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)
    params = _variables(ref)["params"]
    bn16, bn32 = (flax_to_state_dict({"params": params, "batch_stats": _nest(
        _sub(ref, f"sup/{d}/batch_stats"))}) for d in ("bf16", "f32"))
    _assert_bn_within_floor(model, bn16, bn32, SUP_STEP_BN)
    model32, stats32 = _sup_step(ref, monkeypatch, "float32")
    assert _median_own_ratio(stats32, j16, j32) > SUP_STEP_MEDIAN
    with pytest.raises(AssertionError):
        _assert_bn_within_floor(model32, bn16, bn32, SUP_STEP_BN)


def test_semi_step_teacher_bf16_matches_jax(ref, xla_primitives,
                                            monkeypatch):
    """One EMA-teacher step (TrainFlags(ema=True), consistency weight 0.05,
    no gamma draw) with teacher_bf16: a float32 student, the teacher's
    train-mode forward at bfloat16 compute on the same float32 EMA
    parameters and BN state. Its consistency stats against JAX's float32
    student and bfloat16 teacher (the consistency loss JAX's step takes
    with teacher_bf16), within a fraction of their floor (the same student
    against JAX's float32 teacher), and the running stats the teacher
    writes, against its floor likewise."""
    cfg = port_config(CFG)
    model = load_model(flax_to_state_dict(_variables(ref)), cfg, "cpu")
    state = TrainState(model, OptimizerConfig(), ema=True)
    step = make_train_step(model, cfg, SCANNET_MEAN_SIZES,
                           TrainFlags(ema=True, gamma_mixture=False,
                                      arkit=False, teacher_bf16=True))
    _Picks(monkeypatch, {6: ref["semi/student_picks"],
                         12: ref["semi/teacher_picks"]})
    teacher_dtypes = []
    hook = state.ema_model.backbone.sa1.register_forward_hook(
        lambda mod, i, o: teacher_dtypes.append(o[1].dtype))
    stats = step(state, _batch(ref, "labeled"), _batch(ref, "weak"),
                 consistency_weight=0.05)
    hook.remove()
    assert teacher_dtypes == [BF16]
    # the teacher is float32 again after the step
    assert all(mod.compute_dtype == torch.float32
               for mod in state.ema_model.modules()
               if getattr(mod, "compute_dtype", None) is not None)
    assert all(bool(torch.isfinite(v)) for v in stats.values())
    c16, c32 = (_sub(ref, f"semi/cons_{d}_teacher") for d in ("bf16", "f32"))
    assert set(c16) <= set(stats)
    floor = _relative_floor(c16, c32, c16)
    _assert_step_stats(stats, c16, floor, STEP_FRACTIONS[1], c16)
    params = _variables(ref)["params"]
    bn16, bn32 = (flax_to_state_dict({"params": params, "batch_stats": _nest(
        _sub(ref, f"semi/teacher_{d}_batch_stats"))}) for d in ("bf16",
                                                                 "f32"))
    _assert_bn_within_floor(state.ema_model, bn16, bn32, STEP_FRACTIONS[1])
