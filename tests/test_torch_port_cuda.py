"""The port's CUDA kernels on the card, against their plain versions.

Marked `cuda`; each test skips (in its fixture) when torch sees no card.
Run on a machine with a card and nvcc, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX, which that machine lacks;
this file imports only torch, numpy and the port.) Tolerance for fps and
ball query: none. Each must equal its plain version bitwise, indices and
grouped xyz alike, and the --smoke forward through them must equal the one
through the plain versions. The fused SA-MLP kernel sums its products in
another order than cuBLAS: pooled outputs and batch means within 1e-4 abs +
rel of the plain version, batch variances within 1e-4 rel + 1e-5 abs; its
train stats are bitwise the same from run to run. The ball-query-group
backward on the card equals the CPU's to 1e-5 (index_add_ adds in no fixed
order on the card). `ball_query_group_feats` (its feature rows a byte copy)
equals its plain version bitwise in float32 and bfloat16, and its backward
the CPU's to 1e-6 of the gradient's norm. One full-width semi-supervised step runs on the card
with finite stats and the launch counts of its two forwards.
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

from omni_pq_torch import ops
from omni_pq_torch.config import SMOKE_MODEL, ModelConfig
from omni_pq_torch.data import make_batch
from omni_pq_torch.data.spatial import spatial_sort
from omni_pq_torch.infer import build_model, eval_forward

fps_module = importlib.import_module("omni_pq_torch.ops.fps")
from omni_pq_torch.ops.fused_mlp import kernel_mlp_pool, plain_mlp_pool

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cuda(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)


@functools.lru_cache(maxsize=None)
def _scenes(B):
    """B synthetic 40 000-point scenes (Morton-ordered), seed 0."""
    return make_batch(np.random.default_rng(0), B)["point_clouds"]


def _twins(r, B, half):  # point n and n + half coincide: ties across slices
    a = r.uniform(0.5, 5, (B, half, 3))
    return np.concatenate([a, a], 1)


# (points, npoint, the cluster size P the kernel takes)
FPS_CASES = {
    "near_ties": lambda r: (r.uniform(0.5, 5, (2, 5000, 3)), 512, 16),
    "zero_padding": lambda r: (np.concatenate(
        [r.normal(size=(2, 450, 3)) + 2.0, np.zeros((2, 150, 3))], 1), 128,
        1),
    "n_below_npoint": lambda r: (r.normal(size=(3, 40, 3)) + 2.0, 64, 1),
    "partial_warp": lambda r: (r.normal(size=(2, 33, 3)) + 2.0, 8, 1),
    "sa1_scale": lambda r: (_scenes(2), 2048, 16),
    "sa1_b16": lambda r: (_scenes(16), 2048, 16),
    "train_b3": lambda r: (_scenes(3), 2048, 16),
    "train_b6": lambda r: (_scenes(6), 2048, 16),
    # N not a multiple of P x threads: a partial last slice
    "ragged_slices": lambda r: (r.uniform(0.5, 5, (3, 39997, 3)), 256, 16),
    "ragged_b16": lambda r: (r.uniform(0.5, 5, (16, 40013, 3)), 128, 16),
    # every point the same: every step ties everywhere (the parity banks)
    "all_ties": lambda r: (np.full((3, 40000, 3), [1.5, -2.0, 0.7]), 64, 16),
    "all_ties_small": lambda r: (np.full((2, 1500, 3), [1.5, -2.0, 0.7]), 64,
                                 1),
    "cross_slice_ties": lambda r: (_twins(r, 3, 20000), 256, 16),
    # a cluster that picks only index 0 (no step), and more picks than
    # points with zero padding
    "cluster_npoint_one": lambda r: (r.uniform(0.5, 5, (2, 5000, 3)), 1, 16),
    "cluster_n_below_npoint": lambda r: (np.concatenate(
        [r.normal(size=(2, 2000, 3)) + 2.0, np.zeros((2, 100, 3))], 1), 2500,
        16),
    "cross_slice_ties_b16": lambda r: (_twins(r, 16, 20000), 256, 16),
}


@pytest.mark.parametrize("case", sorted(FPS_CASES))
def test_fps_kernel_equals_plain(dev, case):
    xyz, npoint, P = FPS_CASES[case](np.random.default_rng(0))
    x = _cuda(xyz, dev)
    assert fps_module.cluster_plan(x.shape[1])[0] == P
    got = ops.fps(x, npoint)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (x.shape[0], npoint)
    assert torch.equal(got, ops.fps_plain(x, npoint))
    if case.startswith("all_ties"):
        assert (got == 0).all()
    if case.startswith("cross_slice_ties"):
        assert (got < 20000).all()


def _shells(r, B=2, N=2048, S=128, radius=0.4):
    ctr = r.uniform(1, 4, (B, S, 3))
    base = ctr[np.arange(B)[:, None], r.integers(0, S, (B, N))]
    dirs = r.normal(size=(B, N, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return base + dirs * radius * (1 + r.normal(scale=1e-6, size=(B, N, 1))), ctr


def _bq_case(name, r):
    if name == "shells_k64":  # points within ~1 ULP of the radius
        xyz, ctr = _shells(r)
        return xyz, ctr, 0.4, 64
    if name == "shells_k64_morton":  # the same, above 2048 points: boxes
        xyz, ctr = _shells(r, N=4096)
        return np.stack([x[spatial_sort(x)] for x in xyz]), ctr, 0.4, 64
    if name == "sa1_b16":
        pc = _scenes(16)
        return pc, pc[:, ::19][:, :2048], 0.2, 64
    if name == "fps_ordered":  # sa2's input: an unsorted cloud
        pc = _scenes(2)[:, :8000]
        sub = np.stack([p[ops.fps_ref(torch.from_numpy(p[None]), 2048)[0]]
                        for p in pc])
        return sub, sub[:, :1024], 0.4, 32
    if name in ("table_at_shared_cap", "table_in_global"):
        # a box table just within and just beyond a block's shared memory
        # (227 KB: 9685 chunks, so 309 920 points), in a Morton-ordered
        # 10 x 10 x 3 m room (~100 points a ball of radius 0.2)
        N = 309920 if name == "table_at_shared_cap" else 309921
        xyz = r.random((1, N, 3), dtype=np.float32) * np.float32([10, 10, 3])
        xyz = xyz[:, spatial_sort(xyz[0])]
        return xyz, xyz[:, r.permutation(N)[:256]], 0.2, 32
    if name == "rows_above_grid_y":  # more batch rows than a grid's y extent
        xyz = r.random((65537, 2085, 3), dtype=np.float32)
        return xyz, xyz[:, :2], 0.2, 8
    if name == "partial_last_chunk":
        xyz = r.uniform(size=(2, 4001, 3)) * 3
        xyz = np.stack([x[spatial_sort(x)] for x in xyz])
        return xyz, xyz[:, ::7][:, :250].copy(), 0.3, 32
    xyz = r.uniform(size=(2, 2000, 3)) * 3
    ctr = xyz[:, ::8][:, :250].copy()
    if name == "no_hit_centres":
        ctr[:, ::3] += 50.0
        return xyz, ctr, 0.4, 16
    if name == "overflowing":
        return xyz, ctr, 5.0, 40  # every ball holds all points; K > 32
    if name == "sa1_scale":
        pc = make_batch(r, 2)["point_clouds"]
        return pc, pc[:, ::20][:, :2048], 0.2, 64
    return xyz, ctr, 0.4, 16


@pytest.mark.parametrize("case", ["plain", "no_hit_centres", "overflowing",
                                  "shells_k64", "shells_k64_morton",
                                  "fps_ordered", "partial_last_chunk",
                                  "sa1_scale", "sa1_b16", "table_at_shared_cap",
                                  "table_in_global", "rows_above_grid_y"])
def test_ball_query_kernel_equals_plain(dev, case):
    xyz, ctr, radius, k = _bq_case(case, np.random.default_rng(1))
    x, c = _cuda(xyz, dev), _cuda(ctr, dev)
    idx, grouped = ops.ball_query_group(radius, k, x, c)
    torch.cuda.synchronize()
    idx_p, grouped_p = ops.ball_query_group_plain(radius, k, x, c)
    assert torch.equal(idx, idx_p)
    assert torch.equal(grouped, grouped_p)
    assert torch.equal(ops.ball_query(radius, k, x, c), idx_p)


def test_wrappers_count_launches_and_check_inputs(dev):
    x = _cuda(np.random.default_rng(2).normal(size=(2, 300, 3)) + 2.0, dev)
    before = (ops.fps.launches, ops.ball_query_group.launches,
              ops.ball_query.launches)
    ops.fps(x, 16)
    ops.ball_query_group(0.5, 8, x, x[:, :16].contiguous())
    ops.ball_query(0.5, 8, x, x[:, :16].contiguous())
    assert (ops.fps.launches, ops.ball_query_group.launches,
            ops.ball_query.launches) == tuple(n + 1 for n in before)
    with pytest.raises(ValueError, match="float32"):
        ops.fps(x.double(), 16)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fps(x.transpose(0, 1), 16)
    cap = fps_module.max_points()  # a 16-CTA cluster's registers
    assert cap == 16 * 512 * 16
    assert fps_module.cluster_plan(cap)[0] == 16
    assert fps_module.cluster_plan(cap + 1)[0] == 0
    big = torch.ones(1, cap + 1, 3, device=dev)
    with pytest.raises(ValueError, match="N <="):
        ops.fps(big, 16)
    line = big[:, :-1] * 1e-3 * torch.arange(  # the largest row it takes
        cap, device=dev)[None, :, None]
    assert torch.equal(ops.fps(line, 32), ops.fps_plain(line, 32))
    with pytest.raises(ValueError, match="contiguous"):
        ops.ball_query_group(0.5, 8, x, x[:, ::2])


def test_smoke_forward_through_kernels_equals_plain(dev):
    cfg = ModelConfig(num_points=2048, **SMOKE_MODEL)
    pc = make_batch(np.random.default_rng(3), 2, cfg.num_points)[
        "point_clouds"]
    model = build_model(cfg, dev, seed=1)
    ops.fps.launches = ops.ball_query_group.launches = 0
    ep = eval_forward(model, pc)
    torch.cuda.synchronize()
    assert (ops.fps.launches, ops.ball_query_group.launches) == (6, 5)
    with ops.plain_versions():
        ep_plain = eval_forward(model, pc)
    assert set(ep) == set(ep_plain)
    for k in ep:
        assert torch.equal(ep[k], ep_plain[k]), k
    cpu = eval_forward(build_model(cfg, "cpu", seed=1), pc)
    for k in ep:
        if k.endswith("_inds"):
            assert torch.equal(ep[k].cpu(), cpu[k]), k


# (B, S, K, C0, widths): the four full-width SA layers at a few centres, a
# partial last tile, a single layer and a K above 32
FUSED_CASES = {
    "sa1": (2, 40, 64, 3, (128, 128, 256)),
    "sa2": (2, 24, 32, 259, (256, 256, 512)),
    "sa3": (2, 17, 16, 515, (256, 256, 512)),
    "k8_one_layer": (3, 5, 8, 20, (128,)),
    "k24": (1, 9, 24, 7, (128, 256)),
}


def _fused_inputs(case, dev, seed=0):
    B, S, K, C0, widths = FUSED_CASES[case]
    r = np.random.default_rng(seed)
    grouped = _cuda(r.normal(size=(B, S, K, C0)), dev)
    ws, ss, bs, rm, rv = [], [], [], [], []
    cin = C0
    for c in widths:
        ws.append(_cuda(r.normal(size=(cin, c)) / np.sqrt(cin), dev))
        ss.append(_cuda(r.uniform(0.5, 1.5, c), dev))
        bs.append(_cuda(r.normal(0, 0.1, c), dev))
        rm.append(_cuda(r.normal(0, 0.2, c), dev))
        rv.append(_cuda(r.uniform(0.5, 1.5, c), dev))
        cin = c
    return grouped, ws, ss, bs, rm, rv


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_mlp_kernel_matches_plain(dev, case, train):
    args = _fused_inputs(case, dev)
    got = kernel_mlp_pool(*args, train, 1e-5)
    torch.cuda.synchronize()
    want = plain_mlp_pool(*args, train, 1e-5)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
    assert len(got[1]) == len(want[1]) == (len(args[1]) if train else 0)
    for a, b in zip(got[1], want[1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for a, b in zip(got[2], want[2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    if train:  # fixed-order reductions: the same bits every run
        again = kernel_mlp_pool(*args, train, 1e-5)
        for a, b in zip(got[1] + got[2], again[1] + again[2]):
            assert torch.equal(a, b)
        assert torch.equal(got[0], again[0])


def test_fused_mlp_gradients_on_card_match_cpu(dev):
    args = _fused_inputs("sa2", dev, seed=1)
    cpu = [args[0].cpu()] + [[t.cpu() for t in ts] for ts in args[1:]]
    grads = []
    for grouped, ws, ss, bs, rm, rv in (args, cpu):
        leaves = [grouped.requires_grad_()] + [
            t.requires_grad_() for t in ws + ss + bs]
        pooled, _, _ = ops.fused_mlp_pool(grouped, ws, ss, bs, train=True)
        (pooled.sin().sum()).backward()
        grads.append([t.grad.cpu() for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)


def test_fused_mlp_wrapper_counts_and_checks(dev):
    grouped, ws, ss, bs, rm, rv = _fused_inputs("k8_one_layer", dev)
    before = ops.fused_mlp_pool.launches
    ops.fused_mlp_pool(grouped, ws, ss, bs, rm, rv, train=False)
    ops.fused_mlp_pool(grouped, ws, ss, bs, train=True)
    assert ops.fused_mlp_pool.launches == before + 2
    with pytest.raises(ValueError, match="K % 8"):
        ops.fused_mlp_pool(grouped[:, :, :6].contiguous(), ws, ss, bs, rm,
                           rv, train=False)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_mlp_pool(grouped.transpose(1, 2), ws, ss, bs, rm, rv,
                           train=False)


@pytest.mark.parametrize("case", ["no_hit_centres", "overflowing"])
def test_ball_query_group_backward_on_card_matches_cpu(dev, case):
    xyz, ctr, radius, k = _bq_case(case, np.random.default_rng(4))
    g = np.random.default_rng(5).normal(size=ctr.shape[:2] + (k, 3))
    grads = []
    for d in (dev, torch.device("cpu")):
        x = _cuda(xyz, dev).to(d).requires_grad_()
        c = _cuda(ctr, dev).to(d).requires_grad_()
        _, grouped = ops.ball_query_group(radius, k, x, c)
        grouped.backward(_cuda(g, dev).to(d))
        grads.append((x.grad.cpu(), c.grad.cpu()))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-5,
                               atol=1e-5)


FUSED_SMOKE = dict(SMOKE_MODEL, backbone_width=2,
                   backbone_nsamples=(16, 16, 8, 8))


def test_fused_forward_and_train_step_on_card(dev):
    """The --smoke shapes at backbone width 2 (128..512 channels), so every
    SA layer passes the gate: 4 fused calls a forward, eval and train, and
    a supervised step through them close to the unfused route's."""
    from omni_pq_torch.config import SCANNET_MEAN_SIZES
    from omni_pq_torch.train import (OptimizerConfig, batch_to_tensors,
                                     TrainState, make_train_step)
    cfg = ModelConfig(num_points=2048, dropout=0.0, **FUSED_SMOKE)
    batch = make_batch(np.random.default_rng(6), 2, cfg.num_points)
    fused = build_model(dataclasses.replace(cfg, fused_sa=True), dev, seed=2)
    plain = build_model(cfg, dev, seed=2)
    ops.fused_mlp_pool.launches = 0
    ep = eval_forward(fused, batch["point_clouds"])
    assert ops.fused_mlp_pool.launches == 4
    ep_ref = eval_forward(plain, batch["point_clouds"])
    for k in ("sa1_features", "sa2_features", "sa3_features",
              "sa4_features", "fp2_features"):
        torch.testing.assert_close(ep[k], ep_ref[k], rtol=1e-4, atol=1e-4)
    labeled = batch_to_tensors(batch, dev)
    stats = []
    for model in (plain, fused):
        state = TrainState(model, OptimizerConfig())
        step = make_train_step(model, model.cfg, SCANNET_MEAN_SIZES)
        ops.fused_mlp_pool.launches = 0
        stats.append(step(state, labeled))
        assert ops.fused_mlp_pool.launches == (4 if model is fused else 0)
    for k in ("total_loss", "grad_norm"):
        torch.testing.assert_close(stats[1][k], stats[0][k], rtol=1e-3,
                                   atol=1e-4)


# (N, S, K, C, dtype, element offset of the features' storage): every
# vector width of the row copy (16, 8, 4, 2 bytes), no-hit centres, K > 32,
# and a row long enough for the chunk-box query
FEATS_CASES = {
    "c128_f32": (2000, 250, 16, 128, torch.float32, 0),
    "c130_f32_k40": (2000, 250, 40, 130, torch.float32, 0),
    "c7_f32_offset": (800, 64, 16, 7, torch.float32, 1),
    "c64_bf16": (2000, 250, 8, 64, torch.bfloat16, 0),
    "c5_bf16_offset": (600, 40, 8, 5, torch.bfloat16, 1),
    "c64_f32_chunk_boxes": (4000, 250, 16, 64, torch.float32, 0),  # N > 2048
}


def _feats_inputs(case, dev, seed=0):
    n, s, k, c, dtype, offset = FEATS_CASES[case]
    r = np.random.default_rng(seed)
    xyz = r.uniform(size=(2, n, 3)) * 3
    ctr = xyz[:, ::n // s][:, :s].copy()
    ctr[:, ::5] += 50.0  # no hit: idx 0, feature row 0
    store = torch.from_numpy(r.normal(size=2 * n * c + offset)).to(
        device=dev, dtype=dtype)
    feats = store[offset:].view(2, n, c)  # data `offset` elements in
    return _cuda(xyz, dev), _cuda(ctr, dev), feats, k


@pytest.mark.parametrize("case", sorted(FEATS_CASES))
def test_ball_query_group_feats_kernel_equals_plain(dev, case):
    x, c, f, k = _feats_inputs(case, dev)
    before = ops.ball_query_group_feats.launches
    got = ops.ball_query_group_feats(0.4, k, x, c, f)
    torch.cuda.synchronize()
    assert ops.ball_query_group_feats.launches == before + 1
    want = ops.ball_query_group_feats_plain(0.4, k, x, c, f)
    assert got[2].dtype == f.dtype
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (got[0][:, ::5] == 0).all()


def test_ball_query_group_feats_backward_on_card_matches_cpu(dev):
    x, c, f, k = _feats_inputs("c130_f32_k40", dev, seed=1)
    r = np.random.default_rng(2)
    g = r.normal(size=tuple(c.shape[:2]) + (k, 3))
    gf = r.normal(size=tuple(c.shape[:2]) + (k, f.shape[2]))
    grads = []
    for d in (dev, torch.device("cpu")):
        leaves = [t.detach().to(d).requires_grad_() for t in (x, c, f)]
        _, grouped, gfeat = ops.ball_query_group_feats(0.4, k, *leaves)
        torch.autograd.backward([grouped, gfeat],
                                [_cuda(g, dev).to(d), _cuda(gf, dev).to(d)])
        grads.append([t.grad.cpu() for t in leaves])
    # index_add_ adds in no fixed order on the card, and row 0 sums the
    # 40 slots of every no-hit centre: hold each gradient to 1e-6 of its norm
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.norm())


def test_full_width_semi_supervised_step_on_card(dev):
    """TrainFlags() (ema + gamma mixture, fixed criterion) at the full
    ModelConfig() width on 3 labeled + 3 weak scenes: finite stats, and the
    student's and the teacher's forwards each launch 6 FPS and 5
    ball-query-group kernels."""
    from omni_pq_torch.config import SCANNET_MEAN_SIZES
    from omni_pq_torch.train import (OptimizerConfig, TrainFlags, TrainState,
                                     batch_to_tensors, make_train_step)
    cfg = ModelConfig()
    model = build_model(cfg, dev, seed=3)
    state = TrainState(model, OptimizerConfig(), ema=True)
    step = make_train_step(model, cfg, SCANNET_MEAN_SIZES, TrainFlags())
    lab, weak = (batch_to_tensors(make_batch(np.random.default_rng(s), 3,
                                             cfg.num_points), dev)
                 for s in (4, 5))
    gen = torch.Generator(dev).manual_seed(0)
    ops.fps.launches = ops.ball_query_group.launches = 0
    stats = step(state, lab, weak, generator=gen, consistency_weight=0.05)
    torch.cuda.synchronize()
    assert (ops.fps.launches, ops.ball_query_group.launches) == (12, 10)
    for k, v in stats.items():
        assert bool(torch.isfinite(v)), k
    assert "weighted_consistency_loss" in stats and "gamma_engaged_frac" in stats
