"""The port's module surface off the PQTransformer's path against the JAX
package's, on the CPU: SAModuleMSG, GroupAllModule, LFPModuleMSG,
PointsObjClsModule, general_sampling, MultiHeadAttention("self"),
ModelConfig.remat_sa, the legacy teacher and distance losses, metric_util,
the scalar box / quad helpers, the viz helpers and DatasetConfig.

Inputs come from a numpy seed; each JAX module's variables (BN statistics
and affine parameters from numpy noise, not 0/1) are carried into the port
by the `omni_pq_torch.interop` writers of the new modules. Modules run in
eval and train mode: outputs, the gradients of a fixed linear functional of
the outputs with respect to the parameters, and the running statistics
afterwards.

Tolerances: 1e-5 abs + rel for module outputs and running statistics
(XLA:CPU and ATen sum matmuls and reductions in other orders), as
tests/test_torch_port_modules.py; 1e-4 abs + rel for parameter gradients,
as tests/test_torch_port_fused.py; indices bitwise. remat_sa against the
same port model without it: bitwise (the recompute repeats the same
arithmetic); the JAX remat_sa=True model's eval forward: 1e-4 abs + rel, as
tests/test_torch_port_model.py. The teacher losses: rtol 1e-5 (atol 1e-6,
as tests/test_torch_port_train.py's get_loss). calc_distance_vertically:
indices bitwise, distances 1e-6 abs + rel. The gamma crossover: ATen's
lgamma differs from XLA's in the last bits on most inputs, and the
bisection's sign test near the root reads the log-pdf difference f, a sum of
terms much larger than f itself, so a float32 root is only determined to
within the rounding of those terms over the slope: each side's root must lie
within 2^-20 (8 float32 ulps) of the sum of the terms' magnitudes over
|f'(root)| of the float64 root of the same parameters (measured: at most
7 % and 15 % of that bound over 3000 parameter sets), and the two within
that bound of each other (12 %). In the whole distance loss, the fitted
mixture also differs in the last bits (the EM's sums run in another
order): its parameters within 1e-4 relative (measured 1e-5); the roots
may then differ by as much as the float64 roots of the two mixtures do,
plus each side's rounding bound; the keep masks may differ only at points
whose |distance| lies between the two roots (within 1e-6); nothing else is
loosened.
metric_util, the box / quad helpers, the viz helpers and the
spectral clustering's sample, normals, spectrum and K: exactly equal.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_pq_tpu import config as jconfig
from omni_pq_tpu import evals as jevals
from omni_pq_tpu import losses as jlosses
from omni_pq_tpu.evals import box_ops as jbox, quad as jquad
from omni_pq_tpu.losses import distance as jdist, gamma as jgamma
from omni_pq_tpu.models import PQTransformer as JaxPQTransformer
from omni_pq_tpu.models import pointnet2 as jp2, transformer as jtr
from omni_pq_tpu.utils import viz as jviz
from omni_pq_torch import config as tconfig
from omni_pq_torch import evals as tevals
from omni_pq_torch import interop, losses as tlosses
from omni_pq_torch.config import SCANNET_MEAN_SIZES, SMOKE_MODEL, ModelConfig
from omni_pq_torch.data import make_batch
from omni_pq_torch.evals import box_ops as tbox, quad as tquad
from omni_pq_torch.infer import build_model, load_model
from omni_pq_torch.losses import distance as tdist, gamma as tgamma
from omni_pq_torch.models import (GroupAllModule, LFPModuleMSG,
                                  MultiHeadAttention, PointsObjClsModule,
                                  SAModuleMSG, SAModuleVotes,
                                  general_sampling, pointnet2 as tp2)
from omni_pq_torch.train import (OptimizerConfig, TrainFlags, TrainState,
                                 batch_to_tensors, make_train_step)
from omni_pq_torch.utils import viz as tviz
from tests.test_torch_port_modules import port_config, randomised_variables
from tests.util import TINY, tiny_cloud

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU ops: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores (OpenMP threads spin while they wait)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _x(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


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


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def compare_module(jmod, writer, port, args, train, seed=0):
    """`jmod` (flax) and `port` (torch, its state_dict from `writer` of the
    flax variables) on the same numpy `args` (None passes through): outputs
    (indices bitwise, floats TOL); the gradients of sum(out * cotangent)
    over the float outputs with respect to every parameter (GRAD_TOL); in
    train mode the running statistics afterwards (TOL)."""
    rng = np.random.default_rng(seed)
    variables = _noised(jmod.init(jax.random.PRNGKey(seed), *args,
                                  train=train), rng)
    stats = variables.get("batch_stats", {})

    def fwd(params):
        out, mut = jmod.apply({"params": params, "batch_stats": stats}, *args,
                              train=train, mutable=["batch_stats"])
        return _as_tuple(out), mut

    outs_j, _ = fwd(variables["params"])
    cots = [_x(rng, *o.shape) if jnp.issubdtype(o.dtype, jnp.floating)
            else None for o in outs_j]

    def loss(params):
        outs, mut = fwd(params)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)
                   if c is not None), mut
    grads_j, mut_j = jax.jit(jax.grad(loss, has_aux=True))(
        variables["params"])

    port.load_state_dict(writer(variables))
    port.train(train)
    outs_t = _as_tuple(port(*[None if a is None else torch.from_numpy(a)
                              for a in args]))
    assert len(outs_t) == len(outs_j)
    for i, (g, w) in enumerate(zip(outs_t, outs_j)):
        w = np.asarray(w)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(_np(g), w, err_msg=f"output {i}")
        else:
            np.testing.assert_allclose(_np(g), w, err_msg=f"output {i}",
                                       **TOL)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs_t, cots)
        if c is not None).backward()
    want = writer({"params": grads_j,
                   "batch_stats": mut_j.get("batch_stats", stats)})
    for name, p in port.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None else _np(p.grad)
        np.testing.assert_allclose(g, _np(want[name]), err_msg=name,
                                   **GRAD_TOL)
    for name, b in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(_np(b), _np(want[name]), err_msg=name,
                                       **TOL)
    return outs_t


# -- SAModuleMSG, GroupAllModule, LFPModuleMSG --------------------------------

MSG = dict(npoint=16, radii=(0.4, 0.8), nsamples=(8, 16),
           mlps=((16, 32), (16, 24)), normalize_xyz=True)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("with_features", [True, False],
                         ids=["features", "xyz"])
def test_sa_module_msg_matches_jax(train, with_features):
    rng = np.random.default_rng(1)
    xyz = tiny_cloud(rng, n=96)
    feats = _x(rng, 2, 96, 5) if with_features else None
    port = SAModuleMSG(MSG["npoint"], MSG["radii"], MSG["nsamples"],
                       5 if with_features else 0, MSG["mlps"],
                       normalize_xyz=True)
    outs = compare_module(jp2.SAModuleMSG(**MSG),
                          interop.sa_module_msg_state_dict, port,
                          (xyz, feats), train)
    assert outs[1].shape == (2, 16, 32 + 24)


def test_sa_modules_take_given_centre_indices():
    """`inds` replaces the FPS in SAModuleMSG and SAModuleVotes, as in the
    JAX modules."""
    rng = np.random.default_rng(2)
    xyz, feats = tiny_cloud(rng, n=64), _x(rng, 2, 64, 4)
    inds = np.stack([rng.permutation(64)[:16] for _ in range(2)]).astype(
        np.int32)
    jmsg = jp2.SAModuleMSG(use_xyz=False, **MSG)
    port = SAModuleMSG(MSG["npoint"], MSG["radii"], MSG["nsamples"], 4,
                       MSG["mlps"], normalize_xyz=True, use_xyz=False)
    out = compare_module(
        jmsg, interop.sa_module_msg_state_dict, port, (xyz, feats, inds),
        train=False)
    np.testing.assert_array_equal(_np(out[2]), inds)
    jvotes = jp2.SAModuleVotes(npoint=16, radius=0.8, nsample=8,
                               mlp_channels=[16, 32], normalize_xyz=True)
    port = SAModuleVotes(16, 0.8, 8, 4, [16, 32], normalize_xyz=True)
    # SAModuleVotes has GroupAllModule's layout: flax `mlp` -> `mlp_module`
    out = compare_module(jvotes, interop.group_all_state_dict, port,
                         (xyz, feats, inds), train=True)
    np.testing.assert_array_equal(_np(out[2]), inds)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", ["features", "xyz_only", "no_xyz"])
def test_group_all_module_matches_jax(train, case):
    rng = np.random.default_rng(3)
    xyz = tiny_cloud(rng, n=48)
    feats = None if case == "xyz_only" else _x(rng, 2, 48, 6)
    use_xyz = case != "no_xyz"
    port = GroupAllModule(0 if feats is None else 6, [16, 32],
                          use_xyz=use_xyz)
    outs = compare_module(jp2.GroupAllModule([16, 32], use_xyz=use_xyz),
                          interop.group_all_state_dict, port, (xyz, feats),
                          train)
    assert outs[0].shape == (2, 1, 32)


LFP = dict(radii=(0.4, 0.8), nsamples=(8, 4), mlps=((16, 16), (24, 16)),
           post_mlp=(24,))


def _lfp_inputs(rng):
    """Sources xyz1 (2, 48, 3), target centres xyz2 (2, 20, 3), not drawn
    from xyz1, one of them far outside the cloud: a centre with no hit."""
    xyz1 = tiny_cloud(rng, n=48)
    xyz2 = tiny_cloud(rng, n=20)
    xyz2[1, 7] += 50.0
    return xyz1, xyz2


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("skip", [True, False], ids=["skip", "no_skip"])
def test_lfp_module_msg_matches_jax(train, skip):
    from omni_pq_torch.ops.reference import ball_query_ref
    rng = np.random.default_rng(4)
    xyz1, xyz2 = _lfp_inputs(rng)
    f1 = _x(rng, 2, 48, 8)
    f2 = _x(rng, 2, 20, 6) if skip else None
    hits = ball_query_ref(0.8, 4, torch.from_numpy(xyz1),
                          torch.from_numpy(xyz2))
    d2 = ((xyz2[1, 7][None] - xyz1[1]) ** 2).sum(-1)
    assert d2.min() > 0.8 ** 2 and int(hits[1, 7].max()) == 0  # no hit
    port = LFPModuleMSG(LFP["radii"], LFP["nsamples"], 8, 6 if skip else 0,
                        LFP["mlps"], LFP["post_mlp"])
    outs = compare_module(jp2.LFPModuleMSG(**LFP),
                          interop.lfp_module_msg_state_dict, port,
                          (xyz2, xyz1, f2, f1), train)
    assert outs[0].shape == (2, 20, 2 * 24)


def test_lfp_module_rejects_scales_of_other_widths():
    with pytest.raises(ValueError, match="share post_mlp"):
        LFPModuleMSG((0.4, 0.8), (8, 4), 8, 6, ((16, 16), (16, 24)), (24,))


# -- PointsObjClsModule, general_sampling, self-type attention ----------------

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_points_obj_cls_module_matches_jax(train):
    rng = np.random.default_rng(5)
    feats = _x(rng, 2, 40, 32)
    outs = compare_module(jtr.PointsObjClsModule(32),
                          interop.points_obj_cls_state_dict,
                          PointsObjClsModule(32), (feats,), train)
    assert outs[0].shape == (2, 40, 1)


def test_general_sampling_matches_jax():
    rng = np.random.default_rng(6)
    xyz, feats = tiny_cloud(rng, n=64), _x(rng, 2, 64, 7)
    inds = rng.integers(0, 64, (2, 20)).astype(np.int32)
    want = jtr.general_sampling(xyz, feats, inds)
    got = general_sampling(*map(torch.from_numpy, (xyz, feats, inds)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_self_type_attention_matches_jax():
    """attention_type="self": out_proj of query - attention output."""
    rng = np.random.default_rng(7)
    q, kv = _x(rng, 2, 12, 32), _x(rng, 2, 20, 32)
    port = MultiHeadAttention(32, 4, attention_type="self")
    out = compare_module(
        jtr.MultiHeadAttention(32, 4, attention_type="self"),
        interop.mha_state_dict, port, (q, kv, kv), train=False)[0]
    plain = MultiHeadAttention(32, 4)
    plain.load_state_dict(port.state_dict())
    with torch.no_grad():
        other = plain(*map(torch.from_numpy, (q, kv, kv)))
    assert not torch.allclose(out, other)


# -- remat_sa -----------------------------------------------------------------

REMAT_CFG = dict(SMOKE_MODEL, num_points=TINY.num_points, dropout=0.1)
# backbone_width 2: every SA layer passes the fused gate
REMAT_FUSED_CFG = dict(REMAT_CFG, backbone_width=2,
                       backbone_nsamples=(16, 16, 8, 8), fused_sa=True)


@contextlib.contextmanager
def counted_checkpoints():
    """Count the SA layers' calls of torch.utils.checkpoint."""
    real, calls = tp2.checkpoint, []

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    tp2.checkpoint = counting
    try:
        yield calls
    finally:
        tp2.checkpoint = real


def _semi_step(cfg_kw, remat, lab, weak, ctx=contextlib.nullcontext):
    cfg = ModelConfig(**dict(cfg_kw, remat_sa=remat))
    model = build_model(cfg, "cpu", seed=5)
    state = TrainState(model, OptimizerConfig(), ema=True)
    step = make_train_step(model, cfg, SCANNET_MEAN_SIZES, TrainFlags())
    with counted_checkpoints() as calls, ctx():
        stats = step(state, lab, weak,
                     generator=torch.Generator().manual_seed(7),
                     consistency_weight=0.3)
    return (stats, {n: p.grad for n, p in model.named_parameters()},
            dict(model.named_buffers()), dict(model.named_parameters()),
            dict(state.ema_model.named_buffers())), len(calls)


def _assert_bitwise(a, b):
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k


@pytest.mark.parametrize("cfg_kw", [REMAT_CFG, REMAT_FUSED_CFG],
                         ids=["unfused", "fused"])
def test_remat_sa_step_is_bitwise_the_step_without_it(cfg_kw):
    """The semi step with remat_sa: the same stats, gradients, parameters
    after the update and BN running stats of student and teacher, bitwise;
    so the recompute moved no running statistic a second time. The unfused
    SA layers (4 + vote aggregation) checkpoint; on the fused route only
    the one the gate leaves unfused (vote aggregation, 32 wide) does."""
    rng = np.random.default_rng(1)
    lab, weak = (batch_to_tensors(make_batch(rng, 2, TINY.num_points), "cpu")
                 for _ in range(2))
    plain, n_plain = _semi_step(cfg_kw, False, lab, weak)
    remat, n_remat = _semi_step(cfg_kw, True, lab, weak)
    assert n_plain == 0 and n_remat == (1 if cfg_kw.get("fused_sa") else 5)
    _assert_bitwise(remat, plain)


def test_remat_sa_forward_and_backward_are_bitwise():
    """A train-mode forward with remat_sa: every end point, the gradients of
    a linear functional of them, and the running stats (moved once)."""
    pc = torch.from_numpy(tiny_cloud(np.random.default_rng(8)))
    out = []
    for remat in (False, True):
        model = build_model(ModelConfig(**dict(REMAT_CFG, remat_sa=remat)),
                            "cpu", seed=3).train()
        ep = model(pc, generator=torch.Generator().manual_seed(4))
        gen = torch.Generator().manual_seed(5)
        sum((v * torch.randn(v.shape, generator=gen)).sum()
            for v in ep.values() if v.requires_grad).backward()
        out.append(({k: v.detach() for k, v in ep.items()},
                    {n: p.grad for n, p in model.named_parameters()},
                    dict(model.named_buffers())))
    _assert_bitwise(out[1], out[0])
    moved = [k for k, v in out[0][2].items()
             if k.endswith("running_mean") and bool(v.abs().sum() > 0)]
    assert len(moved) > 20


@pytest.fixture
def world_one_group():
    """A world-1 gloo process group in this process, for the test."""
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_remat_sa_in_data_parallel_is_bitwise_the_plain_step(world_one_group):
    """Inside parallel.data_parallel on a group of one rank, the remat
    step's recompute takes the forward's context (the global statistics'
    all-reduce again, the running stats not moved again): bitwise the step
    without remat and without the context."""
    from omni_pq_torch import parallel
    rng = np.random.default_rng(2)
    lab, weak = (batch_to_tensors(make_batch(rng, 2, TINY.num_points), "cpu")
                 for _ in range(2))
    plain, _ = _semi_step(REMAT_CFG, False, lab, weak)
    remat, n = _semi_step(REMAT_CFG, True, lab, weak, parallel.data_parallel)
    assert n == 5
    _assert_bitwise(remat, plain)


def test_remat_recompute_takes_the_forward_context(world_one_group,
                                                  monkeypatch):
    """A forward inside parallel.data_parallel whose backward runs outside
    it: the recompute still takes the global statistics (one all-reduce a
    BatchNorm more than the plain backward, which only all-reduces the
    statistics' cotangents), the gradients are the plain ones bitwise and
    the running stats moved once."""
    import torch.distributed as dist
    from omni_pq_torch import parallel
    rng = np.random.default_rng(20)
    xyz, feats = (torch.from_numpy(a) for a in (tiny_cloud(rng, n=64),
                                                _x(rng, 2, 64, 4)))
    real, calls = dist.all_reduce, []

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(dist, "all_reduce", counting)
    out = []
    for remat in (False, True):
        torch.manual_seed(0)
        port = SAModuleVotes(16, 0.8, 8, 4, [16, 32], normalize_xyz=True,
                             remat=remat)
        for p in port.parameters():
            p.data.normal_()
        port.train()
        with parallel.data_parallel():
            pooled = port(xyz, feats)[1]
        n_forward = len(calls)
        pooled.square().sum().backward()
        out.append(({n: p.grad for n, p in port.named_parameters()},
                    dict(port.named_buffers()), n_forward,
                    len(calls) - n_forward))
        calls.clear()
    _assert_bitwise(out[1][:2], out[0][:2])
    assert out[0][2] == out[1][2] == 2  # one a BatchNorm
    assert out[0][3] == 2 and out[1][3] == 4


def test_remat_sa_module_train_matches_jax_remat():
    """JAX's SAModuleVotes(remat=True) and the port's, train mode: outputs,
    parameter gradients through the recompute, running stats."""
    rng = np.random.default_rng(9)
    xyz, feats = tiny_cloud(rng, n=64), _x(rng, 2, 64, 4)
    jmod = jp2.SAModuleVotes(npoint=16, radius=0.8, nsample=8,
                             mlp_channels=[16, 32], normalize_xyz=True,
                             remat=True)
    port = SAModuleVotes(16, 0.8, 8, 4, [16, 32], normalize_xyz=True,
                         remat=True)
    with counted_checkpoints() as calls:
        compare_module(jmod, interop.group_all_state_dict, port,
                       (xyz, feats), train=True)
    assert len(calls) == 1


def test_remat_sa_model_matches_jax_remat_model():
    """The JAX PQTransformer with remat_sa=True and the port's, the same
    variables, eval forward: every end point (as
    tests/test_torch_port_model.py)."""
    cfg = dataclasses.replace(TINY, remat_sa=True)
    pc = tiny_cloud(np.random.default_rng(10))
    jmodel = JaxPQTransformer(cfg)
    variables = randomised_variables(jmodel, pc, seed=1)
    want = jax.tree.map(np.asarray, jax.jit(jmodel.apply)(variables, pc))
    model = load_model(interop.flax_to_state_dict(variables),
                       port_config(cfg), "cpu")
    assert model.cfg.remat_sa and model.backbone.sa1.remat
    with torch.no_grad():
        got = model(torch.from_numpy(pc))
    assert set(got) == set(want)
    for k, w in want.items():
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(_np(got[k]), w, err_msg=k)
        else:
            np.testing.assert_allclose(_np(got[k]), w, rtol=1e-4, atol=1e-4,
                                       err_msg=k)


# -- the legacy teacher losses ------------------------------------------------

@pytest.fixture(scope="module")
def teacher_inputs():
    """Student and teacher end points of two port TINY models (train-mode
    forward) and the labels of 2 synthetic scenes, with a rotation and
    flips of the teacher's frame."""
    cfg = ModelConfig(**dict(REMAT_CFG, dropout=0.0))
    batch = make_batch(np.random.default_rng(11), 2, cfg.num_points)
    pc = torch.from_numpy(batch["point_clouds"])
    eps = []
    for seed in (3, 4):
        model = build_model(cfg, "cpu", seed=seed).train()
        with torch.no_grad():
            eps.append({k: v.numpy() for k, v in model(pc).items()})
    labels = {k: v for k, v in batch.items() if k != "point_clouds"}
    angle = np.array([0.7, -1.9])
    c, s = np.cos(angle), np.sin(angle)
    rot = np.zeros((2, 3, 3), np.float32)
    rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1] = c, -s, s, c
    rot[:, 2, 2] = 1.0
    labels.update(rot_mat=rot, flip_x_axis=np.array([1, 0]),
                  flip_y_axis=np.array([0, 1]),
                  use_gt=np.array([False, True]))
    return eps[0], eps[1], labels


def _close(got, want, what):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6, err_msg=what)


def test_get_loss_teacher_matches_jax(teacher_inputs):
    ep, ema_ep, labels = teacher_inputs
    want = jax.jit(lambda a, b: jlosses.get_loss_teacher(a, b, num_layer=2))(
        {**ep, **labels}, ema_ep)
    tl = batch_to_tensors(labels, "cpu")
    got = tlosses.get_loss_teacher(
        {**{k: torch.from_numpy(v) for k, v in ep.items()}, **tl},
        {k: torch.from_numpy(v) for k, v in ema_ep.items()}, num_layer=2)
    assert float(got) > 0
    _close(got, want, "teacher_loss")
    centers = tlosses.teacher._unrotate(
        torch.from_numpy(ema_ep["last_quad_center"]), tl["flip_x_axis"],
        tl["flip_y_axis"], tl["rot_mat"])
    _close(centers, jlosses.teacher._unrotate(
        ema_ep["last_quad_center"], labels["flip_x_axis"],
        labels["flip_y_axis"], labels["rot_mat"]), "_unrotate")


@pytest.mark.parametrize("lambda_teacher", [0.0, 1.0])
def test_get_loss_mean_teacher_matches_jax(teacher_inputs, lambda_teacher):
    ep, ema_ep, labels = teacher_inputs
    loss_j, stats_j = jax.jit(lambda a, b: jlosses.get_loss_mean_teacher(
        a, b, SCANNET_MEAN_SIZES, num_layer=2,
        lambda_teacher=lambda_teacher))({**ep, **labels}, ema_ep)
    loss_t, stats_t = tlosses.get_loss_mean_teacher(
        {**{k: torch.from_numpy(v) for k, v in ep.items()},
         **batch_to_tensors(labels, "cpu")},
        {k: torch.from_numpy(v) for k, v in ema_ep.items()},
        SCANNET_MEAN_SIZES, num_layer=2, lambda_teacher=lambda_teacher)
    assert set(stats_t) == set(stats_j)
    _close(loss_t, loss_j, "loss")
    for k in stats_j:
        _close(stats_t[k], stats_j[k], k)
    if lambda_teacher == 0.0:
        assert float(loss_t) == float(stats_t["gt_loss"])


# -- the legacy distance losses -----------------------------------------------

def _wall_scenes(rng, B=3, N=1500, Q=6):
    """Scenes with layout points (label 1) near the walls x = 0 and x = 4,
    other labels elsewhere, and quads on those walls; 1 in 5 quad rows
    masked out."""
    pts = rng.uniform(0, 4, (B, N, 3)).astype(np.float32)
    wall = rng.uniform(size=(B, N)) < 0.5
    pts[..., 0] = np.where(wall, rng.choice([0.0, 4.0], (B, N))
                           + rng.normal(0, 0.03, (B, N)), pts[..., 0])
    labels = np.where(wall, 1, rng.integers(10, 20, (B, N))).astype(np.int32)
    labels[:, :20] = 8  # some doors
    corners = np.zeros((B, Q, 4, 3), np.float32)
    for b in range(B):
        for q in range(Q):
            xw = [0.0, 4.0][q % 2] + rng.normal(0, 0.02)
            y0, y1 = np.sort(rng.uniform(0, 4, 2))
            corners[b, q] = [[xw, y0, 2.5], [xw, y1, 2.5], [xw, y0, 0.0],
                             [xw, y1, 0.0]]
    mask = rng.uniform(size=(B, Q)) < 0.8
    return pts, labels, corners, mask


@pytest.mark.parametrize("masked", [True, False])
def test_calc_distance_vertically_matches_jax(masked):
    pts, _, corners, mask = _wall_scenes(np.random.default_rng(12), B=1)
    corners[0, 2] += np.random.default_rng(13).normal(0, 0.5, (4, 3))
    qmask = mask[0] if masked else None
    want = jdist.calc_distance_vertically(pts[0], corners[0], qmask)
    got = tlosses.calc_distance_vertically(
        torch.from_numpy(pts[0]), torch.from_numpy(corners[0]),
        None if qmask is None else torch.from_numpy(qmask))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), rtol=1e-6,
                               atol=1e-6)


def test_calc_distance_vertically_keeps_the_init_where_no_quad_reaches():
    pts = np.full((4, 3), 50.0, np.float32)
    corners = np.array([[[0, 0, 1], [0, 1, 1], [0, 0, 0], [0, 1, 0]]],
                       np.float32)
    dist, idx = tlosses.calc_distance_vertically(
        torch.from_numpy(pts), torch.from_numpy(corners),
        torch.tensor([False]))
    assert (_np(dist) == 10.0).all() and (_np(idx) == 1.0).all()


def _root64(a1, b1, a2, b2, w, iters=100):
    """The crossover of `_pdf_crossover`, bisected in float64."""
    from scipy.special import gammaln
    a1, b1, a2, b2, w = (np.asarray(v, np.float64)
                         for v in (a1, b1, a2, b2, w))

    def mode(a, b):
        return np.maximum(a - 1.0, 1e-3) / np.maximum(b, 1e-6)

    def logpdf(x, a, b):
        return a * np.log(b) - gammaln(a) + (a - 1) * np.log(x) - b * x
    lo = np.minimum(mode(a1, b1), mode(a2, b2)) * 1e-3 + 1e-6
    hi = np.maximum(mode(a1, b1), mode(a2, b2)) * 4.0 + 1e-3
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        right = (np.log(w) + logpdf(mid, a1, b1) - np.log1p(-w)
                 - logpdf(mid, a2, b2)) > 0
        lo, hi = np.where(right, mid, lo), np.where(right, hi, mid)
    return 0.5 * (lo + hi)


def _crossover_bound(root, a1, b1, a2, b2, w):
    """2^-20 of the sum of the magnitudes of the log-pdf difference's terms
    at `root`, over the magnitude of its slope there (float64)."""
    from scipy.special import gammaln
    x, a1, b1, a2, b2, w = (np.asarray(v, np.float64)
                            for v in (root, a1, b1, a2, b2, w))
    terms = (np.abs(np.log(w)) + np.abs(np.log1p(-w))
             + sum(np.abs(a * np.log(b)) + np.abs(gammaln(a))
                   + np.abs((a - 1) * np.log(x)) + np.abs(b * x)
                   for a, b in ((a1, b1), (a2, b2))))
    return 2.0 ** -20 * terms / np.abs((a1 - a2) / x - b1 + b2)


def test_pdf_crossover_matches_jax_within_its_rounding_bound():
    rng = np.random.default_rng(14)
    n = 500
    params = [rng.uniform(*r, n).astype(np.float32)
              for r in ((0.5, 4), (5, 60), (2, 14), (5, 30), (0.1, 0.95))]
    want = np.asarray(jax.jit(jax.vmap(jdist._pdf_crossover))(*params))
    got = _np(tdist._pdf_crossover(*map(torch.from_numpy, params)))
    exact = _root64(*params)
    bound = _crossover_bound(exact, *params)
    for root in (got, want):
        assert (np.abs(root.astype(np.float64) - exact) <= bound).all()
    assert (np.abs(got.astype(np.float64) - want) <= bound).all()


def _roots(pts, labels, corners, mask):
    """Each side's fitted mixture and crossover root per scene, from its
    own functions (the steps of distance_loss_gamma_mixture)."""
    lay = np.isin(labels, jdist.LAYOUT_CLASSES)
    jax_side = []
    for b in range(pts.shape[0]):
        dist, _ = jdist.calc_distance_vertically(pts[b], corners[b], mask[b])
        d_abs = jnp.abs(jnp.where(lay[b], dist, 1.0)) + 1e-12
        mean = (jnp.sum(jnp.where(lay[b], d_abs, 0.0))
                / jnp.maximum(jnp.sum(lay[b]), 1))
        fit = jgamma.gamma_mixture_em(jnp.where(lay[b], d_abs, mean), 2.0,
                                      40.0, 10.0, 20.0, 0.5, 20)
        jax_side.append((np.array(fit),
                         float(jdist._pdf_crossover(*fit))))
    lay_t = torch.from_numpy(lay)
    dist, _ = tdist._distance_vertically(*map(torch.from_numpy,
                                              (pts, corners, mask)))
    d_abs = torch.where(lay_t, dist, 1.0).abs() + 1e-12
    mean = (torch.where(lay_t, d_abs, 0.0).sum(-1, keepdim=True)
            / lay_t.sum(-1, keepdim=True).clamp_min(1))
    fit = tgamma.gamma_mixture_em(torch.where(lay_t, d_abs, mean), 2.0, 40.0,
                                  10.0, 20.0, 0.5, 20)
    return (np.stack([f for f, _ in jax_side]),
            np.array([r for _, r in jax_side]),
            torch.cat(fit, dim=-1).numpy(),
            tdist._pdf_crossover(*fit)[:, 0].numpy())


def test_distance_loss_gamma_mixture_matches_jax():
    pts, labels, corners, mask = _wall_scenes(np.random.default_rng(15))
    loss_j, aux_j = jax.jit(jdist.distance_loss_gamma_mixture)(
        pts, labels, corners, mask)
    loss_t, aux_t = tlosses.distance_loss_gamma_mixture(
        *map(torch.from_numpy, (pts, labels, corners, mask)))
    np.testing.assert_array_equal(_np(aux_t["layout_mask"]),
                                  np.asarray(aux_j["layout_mask"]))
    np.testing.assert_array_equal(_np(aux_t["idx_array"]),
                                  np.asarray(aux_j["idx_array"]))
    np.testing.assert_allclose(_np(aux_t["distance"]),
                               np.asarray(aux_j["distance"]), rtol=1e-6,
                               atol=1e-6)
    fit_j, root_j, fit_t, root_t = _roots(pts, labels, corners, mask)
    np.testing.assert_allclose(fit_t, fit_j, rtol=1e-4)
    # the roots: as far apart as the two mixtures' float64 roots, plus
    # each side's rounding
    exact_t, exact_j = _root64(*fit_t.T), _root64(*fit_j.T)
    bound = (np.abs(exact_t - exact_j) + _crossover_bound(exact_t, *fit_t.T)
             + _crossover_bound(exact_j, *fit_j.T))
    assert (np.abs(root_t.astype(np.float64) - root_j) <= bound).all()
    # keep masks may differ only between the two roots
    keep_t, keep_j = _np(aux_t["keep_mask"]), np.asarray(aux_j["keep_mask"])
    d_abs = np.abs(np.asarray(aux_j["distance"]))
    band = np.abs(root_t - root_j)[:, None] + 1e-6
    assert (keep_t == keep_j)[np.abs(d_abs - root_j[:, None]) > band].all()
    n_diff = int((keep_t != keep_j).sum())
    assert keep_j.sum(-1).min() > 100
    np.testing.assert_allclose(
        float(loss_t), float(loss_j),
        rtol=1e-5 + 2 * n_diff / keep_j.sum(-1).min())


@pytest.mark.parametrize("dump", [False, True])
def test_spectral_layout_clustering_matches_jax(tmp_path, dump):
    pts, labels, _, _ = _wall_scenes(np.random.default_rng(16), B=1, N=800)
    kw = dict(n_select=300, seed=3)
    paths = [str(tmp_path / f"{side}.txt") if dump else None
             for side in ("jax", "port")]
    want = jdist.spectral_layout_clustering(pts[0], labels[0],
                                            dump_path=paths[0], **kw)
    got = tdist.spectral_layout_clustering(pts[0], labels[0],
                                           dump_path=paths[1], **kw)
    assert got["K"] == want["K"] > 0
    for k in ("selected", "normals", "eigenvalues"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    try:
        import sklearn  # noqa: F401 -- the labels need it on both sides
        np.testing.assert_array_equal(got["labels"], want["labels"])
    except ImportError:
        assert (got["labels"] == 0).all()
    if dump:
        assert open(paths[1]).read() == open(paths[0]).read()


# -- metric_util, box and quad helpers, viz, DatasetConfig --------------------

def _boxes(rng, n, conf=False):
    b = np.concatenate([rng.uniform(0, 3, (n, 3)),
                        rng.uniform(0.2, 1.5, (n, 3))], axis=1)
    if conf:
        b = np.concatenate([b, rng.uniform(size=(n, 1))], axis=1)
    return b


def test_metric_util_matches_jax_exactly():
    rng = np.random.default_rng(17)
    labels, pred = _boxes(rng, 12), _boxes(rng, 15, conf=True)
    pred[:6, :6] = labels[:6] + rng.normal(0, 0.05, (6, 6))
    for a, b in zip(pred[:, :6], labels):
        assert tevals.calc_iou(a, b) == jevals.calc_iou(a, b)
    for t in (0.25, 0.5):
        assert (tevals.single_scene_precision_recall(labels, pred, t, 0.3)
                == jevals.single_scene_precision_recall(labels, pred, t, 0.3))
    lb = np.stack([labels, _boxes(rng, 12)])
    pb = np.stack([pred, _boxes(rng, 15, conf=True)])
    lm = (rng.uniform(size=(2, 12)) < 0.7).astype(float)
    pm = (rng.uniform(size=(2, 15)) < 0.8).astype(float)
    for masks in ((None, None), (lm, pm)):
        assert (tevals.multi_scene_precision_recall(lb, pb, 0.25, 0.1, *masks)
                == jevals.multi_scene_precision_recall(lb, pb, 0.25, 0.1,
                                                       *masks))
    assert tevals.precision_recall(0, 0, 0) == (0.0, 0.0)


def test_scalar_box_and_quad_helpers_match_jax_exactly():
    rng = np.random.default_rng(18)
    for _ in range(5):
        size, angle, center = (rng.uniform(0.2, 2, 3), rng.uniform(-3, 3),
                               rng.normal(size=3))
        np.testing.assert_array_equal(tbox.roty(angle), jbox.roty(angle))
        np.testing.assert_array_equal(tevals.get_3d_box(size, angle, center),
                                      jevals.get_3d_box(size, angle, center))
        np.testing.assert_allclose(
            tbox.get_3d_box_batch(size, angle, center),
            tbox.get_3d_box(size, angle, center), rtol=1e-12, atol=1e-12)
        w, h, n = rng.uniform(0.5, 3), rng.uniform(1, 3), rng.normal(size=3)
        np.testing.assert_array_equal(tevals.get_verts(center, w, h, n),
                                      jquad.get_verts(center, w, h, n))
        np.testing.assert_allclose(tquad.get_verts_batch(center, w, h, n),
                                   tquad.get_verts(center, w, h, n),
                                   rtol=1e-12, atol=1e-12)


def test_viz_helpers_match_jax_exactly(tmp_path):
    rng = np.random.default_rng(19)
    values = rng.normal(size=50)
    np.testing.assert_array_equal(tviz.heat_colors(values),
                                  jviz.heat_colors(values))
    labels = rng.integers(0, 20, 50)
    np.testing.assert_array_equal(tviz.label_palette(labels),
                                  jviz.label_palette(labels))
    pts = rng.normal(size=(30, 3))
    colors = rng.integers(0, 256, (30, 3)).astype(np.float64)
    for cols in (None, colors):
        a, b = tmp_path / "port" / "pc.txt", tmp_path / "jax" / "pc.txt"
        tviz.dump_pc(pts, str(a), cols)
        jviz.dump_pc(pts, str(b), cols)
        assert a.read_bytes() == b.read_bytes()


def test_dataset_config_matches_jax():
    t, j = tconfig.DatasetConfig(), jconfig.DatasetConfig()
    assert tconfig.SCANNET_TYPES == jconfig.SCANNET_TYPES
    assert (t.max_num_obj, t.max_num_quad) == (j.max_num_obj, j.max_num_quad)
    np.testing.assert_array_equal(t.mean_size_arr, j.mean_size_arr)
    res = np.array([0.1, -0.2, 0.05])
    for c in range(18):
        np.testing.assert_array_equal(t.class2size(c, res),
                                      j.class2size(c, res))
        assert t.class2angle(c, 0.3) == j.class2angle(c, 0.3)
        np.testing.assert_array_equal(
            t.param2obb(np.ones(3), 0, 0.1, c, res),
            j.param2obb(np.ones(3), 0, 0.1, c, res))
    # remat_sa included: a JAX config converts field by field
    assert {f.name for f in dataclasses.fields(jconfig.ModelConfig)} == {
        f.name for f in dataclasses.fields(ModelConfig)}


def test_the_jax_package_surface_has_port_counterparts():
    """Every name the JAX losses and evals export, and each module of the
    ported surface, is importable from the same subpackage of the port."""
    for jmod, tmod in ((jlosses, tlosses), (jevals, tevals)):
        missing = [n for n in jmod.__all__ if not hasattr(tmod, n)]
        assert not missing, (tmod.__name__, missing)
    from omni_pq_torch import models as tmodels
    for name in ("SAModuleMSG", "GroupAllModule", "LFPModuleMSG",
                 "PointsObjClsModule", "general_sampling"):
        assert hasattr(tmodels, name), name
    for name in ("heat_colors", "label_palette", "dump_pc"):
        assert hasattr(tviz, name), name
    assert hasattr(tlosses, "spectral_layout_clustering")
