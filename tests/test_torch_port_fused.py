"""The port's fused SA-MLP op (omni_pq_torch.ops.fused_mlp) against the JAX
package's, on the CPU.

The same numpy inputs go through the JAX `plain_mlp_pool` and the JAX
`fused_mlp_pool` (its Pallas kernel in interpret mode) and through the
port's `plain_mlp_pool` and `fused_mlp_pool` (which takes the plain version
for CPU tensors), in eval and train mode: pooled output, batch statistics
and the gradients of a fixed linear functional of the output. Then
SAModuleVotes and the whole PQTransformer with fused_sa=True at a small
config whose SA widths pass the gate (backbone_width=2: 128..512 channels).

The train mode's pass plan (`ops.fused_mlp.pass_plan`: one GEMM pass a
layer over stored pre-activations, BN + ReLU on load, a_1 recomputed from
the grouped rows where C0 is tiny, the last pass keeping each centre's max
and min) is run by a test-local torch model of its dataflow, which must be
bitwise equal to the plain version, and its cost (chains of products,
scratch bytes) is checked at the four full-width SA shapes.

Tolerances: 1e-5 abs + rel between the two plain versions (the same
arithmetic, summed in another order by XLA:CPU and ATen); 5e-5 abs against
the Pallas kernel (its stats reduce per tile), as tests/test_fused_mlp.py
holds it to its own plain version; gradients 1e-4 abs + rel; the whole
model 1e-4 abs + rel in eval mode, as tests/test_torch_port_model.py, and
1e-3 in train mode: there BatchNorm divides by batch statistics over as few
as B*K = 32 rows (the heads), which amplifies the per-op float32 drift
through the chain (measured 2.5e-4 at most on this config; the unfused
TINY model drifts further, 5.7e-3, for the same reason).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_pq_tpu.models import PQTransformer as JaxPQTransformer
from omni_pq_tpu.models.pointnet2 import SAModuleVotes as JaxSAModuleVotes
from omni_pq_tpu.ops import fused_mlp as jfused
from omni_pq_torch import ops
from omni_pq_torch.infer import load_model
from omni_pq_torch.interop import flax_to_state_dict
from omni_pq_torch.models.pointnet2 import SAModuleVotes
from omni_pq_torch.ops import fused_mlp as tfused
from tests.test_torch_port_modules import port_config, randomised_variables
from tests.util import TINY, tiny_cloud

EPS = 1e-5
PLAIN_TOL = dict(rtol=1e-5, atol=1e-5)

# (B, S, K, C0, widths): even tiles, and rows the Pallas kernel pads (R=9)
SHAPES = {"even": (2, 24, 16, 4, (128, 256)),
          "padded": (1, 9, 16, 3, (128, 256)),
          "three_layers": (2, 8, 8, 19, (128, 128, 256))}


def _inputs(name, seed=0, signs=False):
    """signs: BN scales of both signs and exact zeros (+0 and -0), so that
    the pool of the train mode's pass plan takes minima too."""
    B, S, K, C0, widths = SHAPES[name]
    r = np.random.default_rng(seed)
    f = lambda *s: r.normal(size=s).astype(np.float32)  # noqa: E731
    grouped = f(B, S, K, C0)
    ks, ss, bs, rm, rv = [], [], [], [], []
    cin = C0
    for c in widths:
        ks.append(f(cin, c) / np.float32(np.sqrt(cin)))
        scale = r.uniform(0.5, 1.5, c).astype(np.float32)
        if signs:
            scale[1::3] *= -1
            scale[2], scale[5] = 0.0, -0.0
        ss.append(scale)
        bs.append((0.1 * f(c)).astype(np.float32))
        rm.append((0.2 * f(c)).astype(np.float32))
        rv.append(r.uniform(0.5, 1.5, c).astype(np.float32))
        cin = c
    cot = f(B, S, widths[-1])  # cotangent of the pooled output
    return grouped, ks, ss, bs, rm, rv, cot


def _jax_side(name, train):
    """JAX plain and fused (interpret mode): outputs and the gradients of
    sum(pooled * cot) w.r.t. (grouped, kernels, scales, biases)."""
    grouped, ks, ss, bs, rm, rv, cot = _inputs(name)

    def run(fn):
        def loss(g, k, s, b):
            pooled, means, variances = fn(g, k, s, b)
            return jnp.sum(pooled * cot), (pooled, means, variances)
        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3), has_aux=True))(grouped, ks, ss, bs)
        return jax.tree.map(np.asarray, (out, grads))

    plain = run(lambda g, k, s, b: jfused.plain_mlp_pool(
        g, k, s, b, rm, rv, train, EPS, jnp.float32))
    fused = run(lambda g, k, s, b: jfused.fused_mlp_pool(
        g, k, s, b, rm, rv, train=train, eps=EPS, dtype=jnp.float32))
    return plain, fused


def _torch_side(name, train, fn):
    grouped, ks, ss, bs, rm, rv, cot = _inputs(name)
    t = lambda a: torch.from_numpy(a).requires_grad_()  # noqa: E731
    g, k, s, b = t(grouped), [t(a) for a in ks], [t(a) for a in ss], \
        [t(a) for a in bs]
    pooled, means, variances = fn(
        g, k, s, b, [torch.from_numpy(a) for a in rm],
        [torch.from_numpy(a) for a in rv], train)
    (pooled * torch.from_numpy(cot)).sum().backward()
    grads = (g.grad, [a.grad for a in k], [a.grad for a in s],
             [a.grad for a in b])
    return (pooled, means, variances), grads


@pytest.fixture(scope="module", params=[(n, m) for n in SHAPES
                                        for m in (False, True)],
                ids=lambda p: f"{p[0]}-{'train' if p[1] else 'eval'}")
def case(request):
    name, train = request.param
    return name, train, _jax_side(name, train)


def _compare(got, want, tol):
    (g_out, g_grads), (w_out, w_grads) = got, want
    g_pooled, g_means, g_vars = g_out
    w_pooled, w_means, w_vars = w_out
    np.testing.assert_allclose(g_pooled.detach().numpy(), w_pooled, **tol)
    assert len(g_means) == len(w_means) and len(g_vars) == len(w_vars)
    for a, b in zip(list(g_means) + list(g_vars), list(w_means) + list(w_vars)):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-5,
                                   atol=1e-5)
    flat_g = [g_grads[0]] + [x for part in g_grads[1:] for x in part]
    flat_w = [w_grads[0]] + [x for part in w_grads[1:] for x in part]
    for a, b in zip(flat_g, flat_w):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4)


def test_plain_version_matches_jax_plain(case):
    name, train, (jplain, _) = case
    got = _torch_side(name, train, lambda *a: tfused.plain_mlp_pool(
        *a, EPS))
    _compare(got, jplain, PLAIN_TOL)


def test_fused_op_on_cpu_matches_jax_fused_kernel(case):
    """The port's fused_mlp_pool (CPU: the plain version inside the autograd
    Function, backward by recompute) against the Pallas kernel in interpret
    mode with its custom VJP."""
    name, train, (_, jfusedout) = case
    before = ops.fused_mlp_pool.launches
    got = _torch_side(name, train, lambda g, k, s, b, rm, rv, tr:
                      ops.fused_mlp_pool(g, k, s, b, rm, rv, train=tr,
                                         eps=EPS))
    assert ops.fused_mlp_pool.launches == before  # CPU: no kernel launch
    _compare(got, jfusedout, dict(rtol=5e-5, atol=5e-5))


@pytest.mark.parametrize("K,channels,dtype,want", [
    (16, (128, 256), torch.float32, True),
    (64, (128, 128, 256), torch.float32, True),
    (16, (288, 288), torch.float32, False),   # vote_aggregation
    (12, (128,), torch.float32, False),       # K % 8
    (16, (128,), torch.float64, False),       # float64 runs
    (64, (128, 128, 256), torch.bfloat16, True),  # bfloat16, K % 16 == 0
])
def test_supports_gate(K, channels, dtype, want):
    """The JAX gate's cases (tests/test_fused_mlp.py::test_supports_gate):
    the port routes the same shapes and dtypes as the JAX package (more
    bfloat16 cases in tests/test_torch_port_bf16.py)."""
    assert tfused.supports(K, channels, dtype) is want
    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64,
           torch.bfloat16: jnp.bfloat16}[dtype]
    assert jfused.supports(K, channels, jdt) is want


# a small PQTransformer whose SA layers all pass the gate
FUSED_CFG = dataclasses.replace(TINY, backbone_width=2, fused_sa=True,
                                backbone_nsamples=(16, 16, 8, 8),
                                dropout=0.0)


def _noised(variables, rng):
    """BN statistics and affine parameters from numpy noise (not 0/1)."""
    def noise(path, x):
        name, coll = path[-1].key, path[0].key
        x = np.asarray(x)
        if coll == "batch_stats":
            return (rng.normal(0, 0.2, x.shape) if name == "mean"
                    else rng.uniform(0.5, 1.5, x.shape)).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(noise, variables)


def _bn_stats(sd):
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("train", [False, True])
def test_sa_module_fused_matches_jax(train):
    """SAModuleVotes(fused=True) on both sides, same variables: outputs and
    (train) the running statistics the fused path writes back."""
    rng = np.random.default_rng(3)
    xyz = tiny_cloud(rng, n=64)
    feats = rng.normal(size=(2, 64, 5)).astype(np.float32)
    kw = dict(npoint=16, radius=0.8, nsample=16, mlp_channels=[128, 256],
              normalize_xyz=True)
    jmod = JaxSAModuleVotes(fused=True, **kw)
    v = _noised(jmod.init(jax.random.PRNGKey(4), xyz, feats, train=True),
                np.random.default_rng(4))
    (nx, nf, ni), mut = jax.jit(lambda v: jmod.apply(
        v, xyz, feats, train=train, mutable=["batch_stats"]))(v)
    port = SAModuleVotes(16, 0.8, 16, 5, [128, 256], normalize_xyz=True,
                         fused=True)
    assert port.fused
    sd = {}
    for i in range(2):
        node = v["params"]["mlp"]
        sd[f"mlp_module.layer{i}.conv.weight"] = torch.from_numpy(
            np.asarray(node[f"layer{i}"]["kernel"]).T[..., None, None].copy())
        sd[f"mlp_module.layer{i}.bn.bn.weight"] = torch.from_numpy(
            np.asarray(node[f"bn{i}"]["scale"]))
        sd[f"mlp_module.layer{i}.bn.bn.bias"] = torch.from_numpy(
            np.asarray(node[f"bn{i}"]["bias"]))
        st = v["batch_stats"]["mlp"][f"bn{i}"]
        sd[f"mlp_module.layer{i}.bn.bn.running_mean"] = torch.from_numpy(
            np.asarray(st["mean"]))
        sd[f"mlp_module.layer{i}.bn.bn.running_var"] = torch.from_numpy(
            np.asarray(st["var"]))
        sd[f"mlp_module.layer{i}.bn.bn.num_batches_tracked"] = torch.tensor(0)
    port.load_state_dict(sd)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(xyz), torch.from_numpy(feats))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ni))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(nx))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(nf), rtol=5e-5,
                               atol=5e-5)
    for i in range(2):
        st = mut["batch_stats"]["mlp"][f"bn{i}"]
        bn = port.mlp_module[i].bn.bn
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(st["mean"]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(st["var"]), rtol=1e-5,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def fused_model_outputs():
    pc = tiny_cloud(np.random.default_rng(5))
    jmodel = JaxPQTransformer(FUSED_CFG)
    variables = randomised_variables(jmodel, pc, seed=6)
    fwd = jax.jit(lambda v, x, train: jmodel.apply(
        v, x, train=train, mutable=["batch_stats"]), static_argnums=2)
    out = {train: jax.tree.map(np.asarray, fwd(variables, pc, train))
           for train in (False, True)}
    return pc, variables, out


@pytest.mark.parametrize("train", [False, True])
def test_whole_model_fused_matches_jax(fused_model_outputs, train):
    """PQTransformer(fused_sa=True) eval and train forward: every end_points
    key, and in train mode every BN running statistic afterwards; the four
    SA layers take the fused op, vote_aggregation (288 wide) does not."""
    pc, variables, out = fused_model_outputs
    ep_j, mut = out[train]
    model = load_model(flax_to_state_dict(variables), port_config(FUSED_CFG),
                       "cpu")
    fused = [n for n, m in model.named_modules()
             if isinstance(m, SAModuleVotes) and m.fused]
    assert fused == ["backbone.sa1", "backbone.sa2", "backbone.sa3",
                     "backbone.sa4"]
    model.train(train)
    with torch.no_grad():
        ep_t = model(torch.from_numpy(pc))
    assert set(ep_t) == set(ep_j)
    for k, want in ep_j.items():
        got = ep_t[k].numpy()
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            tol = 1e-3 if train else 1e-4
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                       err_msg=k)
    if train:
        want_sd = _bn_stats(flax_to_state_dict(
            {"params": variables["params"],
             "batch_stats": mut["batch_stats"]}))
        got_sd = _bn_stats(model.state_dict())
        assert set(got_sd) == set(want_sd)
        for k in want_sd:
            np.testing.assert_allclose(got_sd[k].numpy(),
                                       want_sd[k].numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=k)


def _pass_model(grouped, weights, scales, biases, eps):
    """The train mode's pass plan as torch ops on the CPU, with the plain
    version's products (torch.matmul on the (B, S, K, C) shapes) and stats
    ops: each pass reads what the plan says it reads (the grouped rows, the
    stored a_j with BN + ReLU on load, or a_1 recomputed from the grouped
    rows), stores only what the plan stores, and the last keeps each
    centre's max and min of a_L, from which the pool takes the BN + ReLU of
    the max where mul >= 0 and of the min where mul's sign bit is set.
    Returns (pooled, means, vars, the passes' sources and stores)."""
    chans = [grouped.shape[-1]] + [w.shape[1] for w in weights]
    stored, means, variances, muls, trace = {}, [], [], [], []
    h = lambda j, a: torch.relu(  # noqa: E731
        (a - means[j - 1]) * muls[j - 1] + biases[j - 1])
    for p in tfused.pass_plan(chans):
        j = p.layer
        if p.source == "x":
            lhs = grouped
        elif p.source == "x@W0":
            lhs = h(1, torch.matmul(grouped, weights[0]))
        else:
            lhs = h(j, stored.pop(j))  # read once, then freed
        a = torch.matmul(lhs, weights[j])
        mu = a.mean(dim=(0, 1, 2))
        var = torch.clamp_min((a * a).mean(dim=(0, 1, 2)) - mu * mu, 0.0)
        means.append(mu)
        variances.append(var)
        muls.append(tfused.bn_mul(var, scales[j], eps))
        if p.store:
            stored[j + 1] = a
        if p.extremes:
            ext = a.amax(dim=2), a.amin(dim=2)
        trace.append((p.source, p.store, p.extremes))
    assert not stored  # every stored a_j was read by the next pass
    sel = torch.where(torch.signbit(muls[-1]), ext[1], ext[0])
    pooled = torch.relu((sel - means[-1]) * muls[-1] + biases[-1])
    return pooled, tuple(means), tuple(variances), trace


@pytest.mark.parametrize("signs", [False, True], ids=["scales_pos",
                                                      "scales_signed"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_pass_plan_model_matches_plain_and_jax(name, signs):
    """The pass plan's dataflow, as torch ops, is bitwise the plain train
    mode (the same products and stats ops; the pool from extremes is exact,
    since BN + ReLU is monotone in a), and within this file's tolerance of
    the JAX package's fused_mlp_pool(train=True) (its Pallas kernel in
    interpret mode) on the same numpy inputs; with BN scales of both signs
    and exact zeros too."""
    grouped, ks, ss, bs, rm, rv, _ = _inputs(name, signs=signs)
    t = [torch.from_numpy(a) for a in ks], [torch.from_numpy(a) for a in ss], \
        [torch.from_numpy(a) for a in bs]
    g = torch.from_numpy(grouped)
    pooled, means, variances, trace = _pass_model(g, *t, EPS)
    want = tfused.plain_mlp_pool(g, *t, (), (), True, EPS)
    assert torch.equal(pooled, want[0])
    for a, b in zip(means + variances, want[1] + want[2]):
        assert torch.equal(a, b)
    L, C0 = len(ks), grouped.shape[-1]
    recompute = L >= 2 and C0 <= tfused.RECOMPUTE_MAX_C0
    assert trace[0] == ("x", L > 1 and not recompute, L == 1)
    if recompute:
        assert trace[1][0] == "x@W0"
    assert [x[2] for x in trace] == [False] * (L - 1) + [True]
    jout = jax.jit(lambda: jfused.fused_mlp_pool(
        grouped, ks, ss, bs, rm, rv, train=True, eps=EPS,
        dtype=jnp.float32))()
    jpooled, jmeans, jvars = jax.tree.map(np.asarray, jout)
    np.testing.assert_allclose(pooled.numpy(), jpooled, rtol=5e-5, atol=5e-5)
    for a, b in zip(means + variances, tuple(jmeans) + tuple(jvars)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)


# the full-width SA layers at the reference's train batch (B=3): (S, K,
# widths), and the scratch the plan keeps alive at most (bytes)
FULL_WIDTH_SA = {"sa1": (2048, 64, (3, 128, 128, 256), 201326592),
                 "sa2": (1024, 32, (259, 256, 256, 512), 201326592),
                 "sa3": (512, 16, (515, 256, 256, 512), 50331648),
                 "sa4": (256, 16, (515, 256, 256, 512), 25165824)}


@pytest.mark.parametrize("layer", sorted(FULL_WIDTH_SA))
def test_pass_plan_costs_at_full_width(layer):
    """One chain of products (1.008 at sa1, whose a_1 is recomputed from
    the xyz rows instead of stored), and at most two stored pre-activations
    alive: a_2 alone at sa1, a_1 + a_2 at sa2-sa4."""
    S, K, chans, scratch = FULL_WIDTH_SA[layer]
    rows = 3 * S * K
    ops_n, peak = tfused.plan_costs(chans, rows)
    chain = 2 * rows * sum(a * b for a, b in zip(chans[:-1], chans[1:]))
    assert 1.0 <= ops_n / chain <= 1.01
    assert peak == scratch
    plan = tfused.pass_plan(chans)
    assert [p.source for p in plan] == (
        ["x", "x@W0", "a"] if layer == "sa1" else ["x", "a", "a"])
    assert [p.store for p in plan] == (
        [False, True, False] if layer == "sa1" else [True, True, False])
