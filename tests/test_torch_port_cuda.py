"""The port's CUDA kernels on the card, against their plain versions.

Marked `cuda`; each test skips (in its fixture) when torch sees no card.
Run on a machine with a card and nvcc, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX, which that machine lacks;
this file imports only torch, numpy and the port.) Tolerance for fps and
ball query: none. Each must equal its plain version bitwise, indices and
grouped xyz alike, and the --smoke forward through them must equal the one
through the plain versions. The fused SA-MLP kernels sum their products in
another order than cuBLAS: pooled outputs and batch means within 1e-4 abs +
rel of the plain version, batch variances within 1e-4 rel + 1e-5 abs; the
train mode's pooled output and stats are bitwise the same from run to run,
and its scratch stays within the pass plan's. The ball-query-group
backward on the card equals the CPU's within the error bound of a sum
taken in another order (index_add_ adds in no fixed order on the card).
`ball_query_group_feats` (its feature rows a byte copy)
equals its plain version bitwise in float32 and bfloat16, and its backward
the CPU's to 1e-6 of the gradient's norm. Under a world-1 process group
the fused train mode's statistics, added over the ranks between two
launches, are bitwise those without a group. One full-width semi-supervised step runs on the card
with finite stats and the launch counts of its two forwards. SAModuleMSG
(fps and the idx-only ball query) and LFPModuleMSG (ball_query_group around
centres outside the cloud) on the kernels equal their plain path bitwise;
the remat_sa step equals the step without it: the same launches, the BN
running stats bitwise, stats and gradients within 1e-5. The float64 route
(--smoke widths) launches FPS and the idx-only ball query on float32 copies
of its coordinates, equals its plain path bitwise and the CPU within 1e-9
of each end point's largest magnitude.
"""
import contextlib
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
        ops.fps(x.half(), 16)
    with pytest.raises(ValueError, match="float32"):
        ops.ball_query(0.5, 8, x.half(), x[:, :16].half())
    # float64 coordinates (the float64 route) go through the kernels on
    # their float32 copies: one launch each, the float32 result
    before = (ops.fps.launches, ops.ball_query.launches)
    assert torch.equal(ops.fps(x.double(), 16), ops.fps(x, 16))
    ctr = x[:, :16].contiguous()
    assert torch.equal(ops.ball_query(0.5, 8, x.double(), ctr.double()),
                       ops.ball_query(0.5, 8, x, ctr))
    assert (ops.fps.launches, ops.ball_query.launches) == (
        before[0] + 2, before[1] + 2)
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
# partial last tile, a single layer and a K above 32; the train mode's pass
# tile holds 128 rows (120 at K = 24), so sa3 (544 rows), k8_one_layer
# (120), k24 (216) and k24_tiles (1200: 10 tiles of 120) end in a partial
# or a whole last tile; a K above 128 (segments of 40 rows); the full-width
# sa4 call at B=3; "_signed": BN scales of both signs and exact zeros, so
# that the train mode's pool takes minima
FUSED_CASES = {
    "sa1": (2, 40, 64, 3, (128, 128, 256)),
    "sa1_signed": (2, 40, 64, 3, (128, 128, 256)),
    "sa2": (2, 24, 32, 259, (256, 256, 512)),
    "sa3": (2, 17, 16, 515, (256, 256, 512)),
    "sa3_signed": (2, 17, 16, 515, (256, 256, 512)),
    "sa4_full_width": (3, 256, 16, 515, (256, 256, 512)),
    "k8_one_layer": (3, 5, 8, 20, (128,)),
    "k8_signed": (2, 11, 8, 4, (128, 132)),
    "k24": (1, 9, 24, 7, (128, 256)),
    "k24_tiles": (2, 25, 24, 36, (128, 256)),
    "k200": (1, 3, 200, 5, (128, 128)),
}


def _fused_inputs(case, dev, seed=0, table=None):
    B, S, K, C0, widths = (FUSED_CASES if table is None else table)[case]
    r = np.random.default_rng(seed)
    grouped = _cuda(r.normal(size=(B, S, K, C0)), dev)
    ws, ss, bs, rm, rv = [], [], [], [], []
    cin = C0
    for c in widths:
        ws.append(_cuda(r.normal(size=(cin, c)) / np.sqrt(cin), dev))
        scale = r.uniform(0.5, 1.5, c)
        if case.endswith("_signed"):
            scale[1::3] *= -1
            scale[2], scale[5] = 0.0, -0.0
        ss.append(_cuda(scale, dev))
        bs.append(_cuda(r.normal(0, 0.1, c), dev))
        rm.append(_cuda(r.normal(0, 0.2, c), dev))
        rv.append(_cuda(r.uniform(0.5, 1.5, c), dev))
        cin = c
    return grouped, ws, ss, bs, rm, rv


def _train_scratch_bytes(grouped, ws):
    """What a train-mode call may allocate beyond its inputs: the pass
    plan's stored pre-activations, the largest pass's column sums, the last
    pass's extremes, the pooled output, and 64 KiB for the per-channel
    vectors (means, variances, multipliers) and the allocator's 512-byte
    rounding."""
    from omni_pq_torch.ops.fused_mlp import pass_tile, plan_costs
    B, S, K, C0 = grouped.shape
    chans = [C0] + [w.shape[1] for w in ws]
    rows = B * S * K
    tile_rows, seg = pass_tile(K)
    psum = 4 * -(-rows // tile_rows) * 2 * max(chans[1:])
    ext = 4 * 2 * rows // seg * chans[-1]
    return plan_costs(chans, rows)[1] + psum + ext + 4 * B * S * chans[-1] \
        + 65536


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_mlp_kernel_matches_plain(dev, case, train):
    args = _fused_inputs(case, dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    got = kernel_mlp_pool(*args, train, 1e-5)
    torch.cuda.synchronize()
    if train:  # no scratch beyond the pass plan's
        rise = torch.cuda.max_memory_allocated(dev) - before
        assert rise <= _train_scratch_bytes(args[0], args[1]), rise
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


def _kernel_launches(fn):
    """{kernel name: launches} of the fused SA-MLP kernels in one call of
    fn, from torch.profiler (which may drop a record now and then: each
    kernel is counted over 10 calls and rounded)."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.key_averages():
        m = re.search(r"::(fused_mlp(?:_bf16)?|mlp_pass(?:_bf16)?|mlp_stats"
                      r"|mlp_pool)_kernel\b", e.key)
        if m and e.device_type == DeviceType.CUDA:
            counts[m.group(1)] = counts.get(m.group(1), 0) + e.count
    return {k: round(v / 10) for k, v in counts.items()}


def test_fused_mlp_wrapper_counts_and_checks(dev):
    """One count a call on the card; an eval call is one chained-kernel
    launch, a train call L passes, L stats launches and one pool launch."""
    grouped, ws, ss, bs, rm, rv = _fused_inputs("k8_one_layer", dev)
    before = ops.fused_mlp_pool.launches
    ops.fused_mlp_pool(grouped, ws, ss, bs, rm, rv, train=False)
    ops.fused_mlp_pool(grouped, ws, ss, bs, train=True)
    assert ops.fused_mlp_pool.launches == before + 2
    assert _kernel_launches(lambda: ops.fused_mlp_pool(
        grouped, ws, ss, bs, rm, rv, train=False)) == {"fused_mlp": 1}
    g3, ws3, ss3, bs3, _, _ = _fused_inputs("sa2", dev)
    assert _kernel_launches(lambda: ops.fused_mlp_pool(
        g3, ws3, ss3, bs3, train=True)) == {
            "mlp_pass": 3, "mlp_stats": 3, "mlp_pool": 1}
    with pytest.raises(ValueError, match="K % 8"):
        ops.fused_mlp_pool(grouped[:, :, :6].contiguous(), ws, ss, bs, rm,
                           rv, train=False)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_mlp_pool(grouped.transpose(1, 2), ws, ss, bs, rm, rv,
                           train=False)


# The eval mode at K where a chained tile no longer fits in shared memory
# (sa2's widths from K = 120): it runs the pass plan with the running
# statistics (L passes and a pool launch, no chained kernel, no stats).
FUSED_EVAL_LARGE_K = {
    "k128_sa2": (1, 6, 128, 259, (256, 256, 512)),
    "k200_sa2": (1, 4, 200, 259, (256, 256, 512)),
    # xyz only (C0 = 3): a_1 recomputed, so 2 passes
    "k256_xyz": (1, 3, 256, 3, (256, 256, 512)),
}


@pytest.mark.parametrize("case", sorted(FUSED_EVAL_LARGE_K))
def test_fused_mlp_eval_at_large_k_matches_plain(dev, case):
    from omni_pq_torch.ops.fused_mlp import eval_chained, pass_plan
    _, _, K, C0, widths = FUSED_EVAL_LARGE_K[case]
    args = _fused_inputs(case, dev, table=FUSED_EVAL_LARGE_K)
    chans = [C0, *widths]
    assert not eval_chained(chans, K)
    got = kernel_mlp_pool(*args, False, 1e-5)
    torch.cuda.synchronize()
    want = plain_mlp_pool(*args, False, 1e-5)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
    assert got[1] == got[2] == ()
    passes = len(pass_plan(chans, train=False))
    assert _kernel_launches(lambda: kernel_mlp_pool(*args, False, 1e-5)) == {
        "mlp_pass": passes, "mlp_pool": 1}


# The bfloat16 mode (K % 16 == 0), against the plain bfloat16 version (cuBLAS
# with float32 sums). The kernels sum each product in another order, which
# flips a rounding of af to bfloat16 now and then (one bfloat16 ulp,
# 2^-8 relative); a flip moves the next layer's sums by one term's ulp and
# may flip roundings there, so a flip's trace stays a few bfloat16 ulps of
# the values it touches, on a small share of them. Bounds (chip_smoke.py's,
# which sit between the kernels' readings and a control's at the model's
# shapes): the pooled output within 2^-9 of its norm (norm-relative), every
# element within 2^-5 of the output's largest magnitude (a gross bound);
# batch means within 2^-12 x (1 + |mean|) and variances 2^-11 relative +
# 2^-12 abs (each sums B*S*K values of af, of which a few flipped). The
# control, the float32 chain rounded to bfloat16 only at its output, must
# fall outside the norm bound (and, train, the stats bounds).
FUSED_BF16_CASES = {
    "sa1": (2, 40, 64, 3, (128, 128, 256)),
    "sa1_signed": (2, 40, 64, 3, (128, 128, 256)),
    "sa2": (2, 24, 32, 259, (256, 256, 512)),
    "sa3": (2, 17, 16, 515, (256, 256, 512)),
    "sa3_signed": (2, 17, 16, 515, (256, 256, 512)),
    "sa4_full_width": (3, 256, 16, 515, (256, 256, 512)),
    "k16_one_layer": (3, 5, 16, 20, (128,)),
    "k48_tiles": (2, 25, 48, 36, (128, 256)),  # 96-row tiles, partial last
    "k144": (1, 3, 144, 5, (128, 128)),        # segments of 48 rows
    "k128_sa2": (1, 6, 128, 259, (256, 256, 512)),
    "k256_sa2": (1, 2, 256, 259, (256, 256, 512)),  # eval by the pass plan
    # the last 128-row tile holds 32 rows (the second warpgroup none), and
    # K = 32 centres span two warps of a warpgroup
    "k32_partial_tile": (1, 41, 32, 259, (256, 256, 512)),
    # the last tile's second warpgroup has no rows; a centre spans 4 warps
    "k64_empty_warpgroup": (3, 13, 64, 3, (128, 128, 256)),
    # 150 tiles (300 pass items) over 132 SMs: the persistent walk is
    # partial
    "k16_many_tiles": (4, 300, 16, 515, (256, 256, 512)),
}
BF16_NORM_REL = 2.0 ** -9
BF16_ELEMENT_OF_MAX = 2.0 ** -5
BF16_MEAN_REL = 2.0 ** -12
BF16_VAR_TOL = dict(rtol=2.0 ** -11, atol=2.0 ** -12)


def _bf16_gaps(got, want):
    g, w = got.double(), want.double()
    return (float((g - w).norm() / w.norm().clamp_min(1e-30)),
            float((g - w).abs().max() / w.abs().max().clamp_min(1e-30)))


def _bf16_stats_close(got, want):
    """Every batch mean and variance of got (pooled, means, variances)
    within its bound of want's."""
    return all(float((a - b).abs().max()) <= BF16_MEAN_REL * (
        1 + float(b.abs().max())) for a, b in zip(got[1], want[1])) and all(
        torch.allclose(a, b, **BF16_VAR_TOL) for a, b in zip(got[2], want[2]))


def _bf16_close(got, want, what):
    rel, worst = _bf16_gaps(got, want)
    assert rel <= BF16_NORM_REL and worst <= BF16_ELEMENT_OF_MAX, (
        what, rel, worst)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", sorted(FUSED_BF16_CASES))
def test_fused_mlp_bf16_kernel_matches_plain(dev, case, train):
    widths = FUSED_BF16_CASES[case][4]
    args = _fused_inputs(case, dev, table=FUSED_BF16_CASES)
    bf16 = torch.bfloat16
    got = kernel_mlp_pool(*args, train, 1e-5, bf16)
    torch.cuda.synchronize()
    want = plain_mlp_pool(*args, train, 1e-5, bf16)
    assert got[0].dtype == want[0].dtype == bf16
    assert torch.isfinite(got[0].float()).all()
    _bf16_close(got[0], want[0], "pooled")
    assert len(got[1]) == len(want[1]) == (len(widths) if train else 0)
    assert _bf16_stats_close(got, want)
    # the control: the float32 chain, rounded to bfloat16 at its output,
    # falls outside the bounds on the pooled norm and the stats
    control = plain_mlp_pool(*args, train, 1e-5, torch.float32)
    assert _bf16_gaps(control[0].to(bf16), want[0])[0] > BF16_NORM_REL
    if train:  # some batch mean, and some variance, outside its bound
        assert not _bf16_stats_close(((), control[1], ()), ((), want[1], ()))
        assert not _bf16_stats_close(((), (), control[2]), ((), (), want[2]))
    if train:  # fixed-order reductions: the same bits every run
        again = kernel_mlp_pool(*args, train, 1e-5, bf16)
        for a, b in zip(got[1] + got[2], again[1] + again[2]):
            assert torch.equal(a, b)
        assert torch.equal(got[0], again[0])


def test_fused_mlp_bf16_wrapper_counts_and_checks(dev):
    """An eval call is one bfloat16 chained-kernel launch where the chain
    takes its shape (K = 16, 32, 64) and L bfloat16 passes and a pool
    launch where it does not (K = 48), a train call L bfloat16 passes, L
    stats and one pool launch; the bfloat16 mode takes K % 16 == 0 only."""
    grouped, ws, ss, bs, rm, rv = _fused_inputs("sa2", dev,
                                                table=FUSED_BF16_CASES)
    bf16 = torch.bfloat16
    before = ops.fused_mlp_pool.launches
    ops.fused_mlp_pool(grouped, ws, ss, bs, rm, rv, train=False, dtype=bf16)
    ops.fused_mlp_pool(grouped, ws, ss, bs, train=True, dtype=bf16)
    assert ops.fused_mlp_pool.launches == before + 2
    assert _kernel_launches(lambda: ops.fused_mlp_pool(
        grouped, ws, ss, bs, rm, rv, train=False, dtype=bf16)) == {
            "fused_mlp_bf16": 1}
    assert _kernel_launches(lambda: ops.fused_mlp_pool(
        grouped, ws, ss, bs, train=True, dtype=bf16)) == {
            "mlp_pass_bf16": 3, "mlp_stats": 3, "mlp_pool": 1}
    # K = 48: a centre does not fit a warpgroup's 64 rows, so an eval call
    # runs the pass plan with the running statistics
    g48, ws48, ss48, bs48, rm48, rv48 = _fused_inputs(
        "k48_tiles", dev, table=FUSED_BF16_CASES)
    assert _kernel_launches(lambda: ops.fused_mlp_pool(
        g48, ws48, ss48, bs48, rm48, rv48, train=False, dtype=bf16)) == {
            "mlp_pass_bf16": 2, "mlp_pool": 1}
    with pytest.raises(ValueError, match="K % 16"):
        ops.fused_mlp_pool(grouped[:, :, :24].contiguous(), ws, ss, bs, rm,
                           rv, train=False, dtype=bf16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_train_stats_over_a_world_one_group(dev, dtype):
    """Inside parallel.data_parallel the train mode adds each layer's
    column sums over the ranks between its stats launch and a finishing
    launch; on a world-1 group (gloo, card tensors) that sum is the
    identity, so the pooled output and the statistics are bitwise those of
    the launches without a group."""
    import socket
    import torch.distributed as dist
    from omni_pq_torch import parallel
    args = _fused_inputs("sa2", dev, table=FUSED_BF16_CASES)
    want = kernel_mlp_pool(*args, True, 1e-5, dtype)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        with parallel.data_parallel():
            got = kernel_mlp_pool(*args, True, 1e-5, dtype)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        assert torch.equal(a, b)


def test_bf16_products_sum_in_float32_on_card(dev):
    """ops.matmul's matmul and linear in bfloat16 on the card against the
    same products on the CPU (which sums bfloat16 products in float32), at
    a depth of 4096 where cuBLAS may split the sum: forward and gradients
    within 2^-9 of their norm (the float32 sums run in another order and
    flip a rounding to bfloat16 by one ulp, 2^-8 relative, now and then);
    the switch they open is closed again after each call."""
    from omni_pq_torch.ops import matmul as mm
    m = torch.backends.cuda.matmul
    before = m.allow_bf16_reduced_precision_reduction
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(3, 64, 4096, generator=gen).to(torch.bfloat16)
    b = torch.randn(4096, 96, generator=gen).to(torch.bfloat16)
    w = torch.randn(96, 4096, generator=gen).to(torch.bfloat16)
    for fn, x, y in ((mm.matmul, a, b), (mm.linear, a, w)):
        out = []
        for d in (dev, "cpu"):
            xs, ys = (t.to(d).clone().requires_grad_() for t in (x, y))
            r = fn(xs, ys)
            (r.float() * torch.linspace(-1, 1, r.shape[-1],
                                        device=d)).sum().backward()
            out.append([t.detach().float().cpu()
                        for t in (r, xs.grad, ys.grad)])
        assert m.allow_bf16_reduced_precision_reduction == before
        for got, want in zip(*out):
            assert float((got - want).norm()) <= 2.0 ** -9 * float(
                want.norm())


def test_fused_mlp_bf16_gradients_on_card_match_cpu(dev):
    """The backward (a remat through the plain bfloat16 chain) on the card
    against the CPU's: both round the same chain to bfloat16, cuBLAS and
    the CPU sum in other orders, so the gradients agree to a few bfloat16
    ulps of their norm."""
    args = _fused_inputs("sa2", dev, seed=1, table=FUSED_BF16_CASES)
    cpu = [args[0].cpu()] + [[t.cpu() for t in ts] for ts in args[1:]]
    grads = []
    for grouped, ws, ss, bs, rm, rv in (args, cpu):
        leaves = [grouped.requires_grad_()] + [
            t.requires_grad_() for t in ws + ss + bs]
        pooled, _, _ = ops.fused_mlp_pool(grouped, ws, ss, bs, train=True,
                                          dtype=torch.bfloat16)
        (pooled.float().sin().sum()).backward()
        grads.append([t.grad.cpu() for t in leaves])
    for a, b in zip(*grads):
        assert float((a - b).norm()) <= 2.0 ** -6 * float(b.norm())


@pytest.mark.parametrize("case", ["no_hit_centres", "overflowing"])
def test_ball_query_group_backward_on_card_matches_cpu(dev, case):
    """Both gradients are float32 sums of cotangents, which index_add_ adds
    on the card in no fixed order: a point of "overflowing" (every ball
    holds every point) sums 250 terms whose partial sums reach ~16 around a
    result of ~0.5, so a relative tolerance of the result does not hold.
    Any two orders of an n-term float32 sum differ by at most 2 gamma_n S,
    gamma_n = n u / (1 - n u), u = 2^-24, S the sum of the terms' absolute
    values; each element is held to that bound, with n and S counted on the
    CPU in float64 from the same indices and cotangents."""
    xyz, ctr, radius, k = _bq_case(case, np.random.default_rng(4))
    g = np.random.default_rng(5).normal(size=ctr.shape[:2] + (k, 3))
    grads = []
    for d in (dev, torch.device("cpu")):
        x = _cuda(xyz, dev).to(d).requires_grad_()
        c = _cuda(ctr, dev).to(d).requires_grad_()
        idx, grouped = ops.ball_query_group(radius, k, x, c)
        grouped.backward(_cuda(g, dev).to(d))
        grads.append((x.grad.cpu(), c.grad.cpu()))
    # the terms: d xyz[b, idx] += g, d ctr[b, s] -= sum over the K slots
    B, N, _ = xyz.shape
    gabs = torch.from_numpy(np.abs(_cuda(g, "cpu").numpy())).double()
    flat = (idx.cpu().long() + N * torch.arange(B)[:, None, None]).flatten()
    s_xyz = torch.zeros(B * N, 3, dtype=torch.float64).index_add_(
        0, flat, gabs.reshape(-1, 3)).view(B, N, 3)
    n_xyz = torch.zeros(B * N, dtype=torch.float64).index_add_(
        0, flat, torch.ones(flat.numel(), dtype=torch.float64)).view(B, N, 1)
    s_ctr, n_ctr = gabs.sum(2), torch.full((1,), float(k), dtype=torch.float64)
    u = 2.0 ** -24
    for (got, want), s, n in zip(zip(*grads), (s_xyz, s_ctr), (n_xyz, n_ctr)):
        gamma = n * u / (1 - n * u)
        bound = 2 * gamma * s
        diff = (got.double() - want.double()).abs()
        assert bool((diff <= bound).all()), float((diff - bound).max())


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


def _module_on(module, dev, seed):
    """`module` with random weights from `seed` (infer.init_weights) and BN
    affine parameters and running stats from numpy noise, on `dev`."""
    from omni_pq_torch.infer import init_weights
    from omni_pq_torch.models.pointnet2 import BatchNorm
    init_weights(module, torch.Generator().manual_seed(seed))
    r = np.random.default_rng(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                c = m.num_features
                for t, v in ((m.weight, r.uniform(0.5, 1.5, c)),
                             (m.bias, r.normal(0, 0.1, c)),
                             (m.running_mean, r.normal(0, 0.1, c)),
                             (m.running_var, r.uniform(0.5, 1.5, c))):
                    t.copy_(torch.from_numpy(v))
    return module.to(dev)


def _kernel_and_plain(module, args, train, counted, dev):
    """module(*args) on the kernels, then through ops.plain_versions(),
    from the same state: (launch counts of the kernel run; for each run
    the outputs, the parameters' gradients of a fixed functional in train
    mode and the buffers afterwards)."""
    import copy
    out = []
    for plain in (False, True):
        m = copy.deepcopy(module).train(train)
        for fn in counted.values():
            fn.launches = 0
        ctx = ops.plain_versions() if plain else contextlib.nullcontext()
        with ctx, torch.set_grad_enabled(train):
            res = m(*args)
            res = res if isinstance(res, tuple) else (res,)
            if train:
                gen = torch.Generator(dev).manual_seed(1)
                sum((r * torch.randn(r.shape, generator=gen, device=dev))
                    .sum() for r in res if r.is_floating_point()).backward()
        torch.cuda.synchronize()
        if not plain:
            launches = {k: fn.launches for k, fn in counted.items()}
        out.append(([r.detach() for r in res],
                    {n: p.grad for n, p in m.named_parameters()},
                    dict(m.named_buffers())))
    return launches, out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_sa_module_msg_on_kernels_equals_plain(dev, train):
    """SAModuleMSG at small widths on a 40 000-point scene pair: 1 FPS and
    2 idx-only ball-query launches, outputs (and in train mode the
    parameters' gradients and running stats) bitwise its plain path."""
    from omni_pq_torch.models import SAModuleMSG
    xyz = _cuda(_scenes(2)[..., :3], dev)
    feats = _cuda(np.random.default_rng(1).normal(size=(2, 40000, 4)), dev)
    msg = _module_on(SAModuleMSG(512, (0.2, 0.4), (32, 16), 4,
                                 ((16, 32), (16, 24)), normalize_xyz=True),
                     dev, seed=2)
    counted = {"fps": ops.fps, "ball_query": ops.ball_query,
               "ball_query_group": ops.ball_query_group}
    launches, (kern, plain) = _kernel_and_plain(msg, (xyz, feats), train,
                                                counted, dev)
    assert launches == {"fps": 1, "ball_query": 2, "ball_query_group": 0}
    for a, b in zip(kern, plain):
        assert (a.keys() if isinstance(a, dict) else len(a)) == (
            b.keys() if isinstance(b, dict) else len(b))
        for x, y in (zip(a.values(), b.values()) if isinstance(a, dict)
                     else zip(a, b)):
            assert (x is None and y is None) or torch.equal(x, y)


def test_lfp_module_msg_on_kernels_equals_plain(dev):
    """LFPModuleMSG at small widths, centres not drawn from the sources and
    one far outside (no hit: row 0 stands in): 2 ball-query-group launches,
    the output bitwise its plain path's."""
    from omni_pq_torch.models import LFPModuleMSG
    r = np.random.default_rng(3)
    src = _scenes(2)[:, ::40, :3]                    # (2, 1000, 3)
    tgt = src[:, ::2] + r.normal(0, 0.05, (2, 500, 3))
    tgt[1, 17] += 100.0
    f1, f2 = r.normal(size=(2, 1000, 8)), r.normal(size=(2, 500, 6))
    lfp = _module_on(LFPModuleMSG((0.4, 0.8), (16, 8), 8, 6,
                                  ((16, 16), (24, 16)), (24,)), dev, seed=4)
    counted = {"ball_query_group": ops.ball_query_group}
    args = tuple(_cuda(a, dev) for a in (tgt, src, f2, f1))
    launches, (kern, plain) = _kernel_and_plain(lfp, args, False, counted,
                                                dev)
    assert launches == {"ball_query_group": 2}
    idx = ops.ball_query(0.8, 8, args[1], args[0])
    assert int(idx[1, 17].max()) == 0
    assert torch.equal(kern[0][0], plain[0][0])


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_remat_sa_step_on_card_matches_the_step_without_it(dev, fused):
    """The --smoke supervised step (fused: backbone width 2, every SA layer
    through the fused kernel) with remat_sa against the same step without
    it: the same launch counts, the BN running stats bitwise (moved once),
    stats and gradients within 1e-5 (index_add_ adds in no fixed order on
    the card)."""
    from omni_pq_torch.config import SCANNET_MEAN_SIZES
    from omni_pq_torch.train import (OptimizerConfig, batch_to_tensors,
                                     TrainState, make_train_step)
    cfg = ModelConfig(num_points=2048, dropout=0.0,
                      **(dict(FUSED_SMOKE, fused_sa=True) if fused
                         else SMOKE_MODEL))
    labeled = batch_to_tensors(make_batch(np.random.default_rng(7), 2,
                                          cfg.num_points), dev)
    counted = (ops.fps, ops.ball_query_group, ops.fused_mlp_pool)
    runs = []
    for remat in (False, True):
        model = build_model(dataclasses.replace(cfg, remat_sa=remat), dev,
                            seed=2)
        state = TrainState(model, OptimizerConfig())
        step = make_train_step(model, model.cfg, SCANNET_MEAN_SIZES)
        for fn in counted:
            fn.launches = 0
        stats = step(state, labeled)
        torch.cuda.synchronize()
        runs.append((stats, {n: p.grad for n, p in model.named_parameters()},
                     dict(model.named_buffers()),
                     [fn.launches for fn in counted]))
    (s0, g0, b0, l0), (s1, g1, b1, l1) = runs
    assert l1 == l0 and l0[2] == (4 if fused else 0)
    for k in b0:
        assert torch.equal(b1[k], b0[k]), k
    for k in s0:
        assert abs(float(s1[k]) - float(s0[k])) <= 1e-5 * max(
            1.0, abs(float(s0[k]))), k
    norm = float(torch.sqrt(sum((g * g).sum() for g in g0.values())))
    gap = max(float((g1[n] - g0[n]).abs().max()) for n in g0)
    assert gap <= 1e-5 * norm


def test_float64_forward_on_card_matches_cpu(dev):
    cfg = ModelConfig(**{**SMOKE_MODEL, "num_points": 512,
                         "compute_dtype": "float64"})
    pc = make_batch(np.random.default_rng(0), 2, 512)["point_clouds"]
    model = build_model(cfg, dev, seed=3)
    counted = (ops.fps, ops.ball_query, ops.ball_query_group,
               ops.fused_mlp_pool)
    for fn in counted:
        fn.launches = 0
    ep = eval_forward(model, pc)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counted] == [6, 5, 0, 0]
    with ops.plain_versions():
        ep_plain = eval_forward(model, pc)
    ep_cpu = eval_forward(build_model(cfg, "cpu", seed=3), pc)
    assert set(ep) == set(ep_cpu)
    for k, want in ep_cpu.items():
        got = ep[k].cpu()
        assert got.dtype == want.dtype, k
        assert torch.equal(got, ep_plain[k].cpu()), k
        if want.dtype.is_floating_point:
            assert want.dtype == torch.float64, k
            gap = float((got - want).abs().max())
            assert gap <= 1e-9 * float(want.abs().max()), (k, gap)
        else:
            assert torch.equal(got, want), k


def test_trace_spans_on_the_profiler_clock_on_card(dev):
    """The spans of a --smoke semi-supervised step (`utils.trace`) under
    torch.profiler with CUDA activity: every record within 50 us of its
    record_function event on the profiler's clock, the kernels' ctypes
    launches under `ops.fps` and `ops.ball_query` (6 FPS and 5
    ball-query launches a forward), and `allocations` above 0 on
    `train.step` and each of its phases."""
    import gc

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from omni_pq_torch.config import SCANNET_MEAN_SIZES
    from omni_pq_torch.train import (OptimizerConfig, TrainFlags, TrainState,
                                     batch_to_tensors, make_train_step)
    from omni_pq_torch.utils import trace
    cfg = ModelConfig(**{**SMOKE_MODEL, "num_points": 2048})
    model = build_model(cfg, dev, seed=3)
    state = TrainState(model, OptimizerConfig(), ema=True)
    step = make_train_step(model, cfg, SCANNET_MEAN_SIZES, TrainFlags())
    lab, weak = (batch_to_tensors(make_batch(np.random.default_rng(s), 2,
                                             cfg.num_points), dev)
                 for s in (4, 5))
    gen = torch.Generator(dev).manual_seed(0)
    step(state, lab, weak, generator=gen, consistency_weight=0.05)
    torch.cuda.synchronize()
    trace.clear()
    gc.disable()  # a collection inside a span's exit would blur its clock
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(state, lab, weak, generator=gen, consistency_weight=0.05)
            torch.cuda.synchronize()
    finally:
        gc.enable()
    recs = trace.records()
    trace.clear()
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            events.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    for r in recs:
        assert min(max(abs(s - r.t0_ns), abs(e - r.t1_ns))
                   for s, e in events[r.name]) <= 50_000, r
    names = [r.name for r in recs]
    assert (names.count("ops.fps"), names.count("ops.ball_query")) == (12, 10)
    phases = [r for r in recs
              if r.name == "train.step" or r.name.startswith("step.")]
    assert len(phases) == 6
    for r in phases:
        assert r.counters["allocations"] > 0, r
