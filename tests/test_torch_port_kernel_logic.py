"""The index logic of the port's FPS and ball-query CUDA kernels, and the BN +
ReLU step and pool of its fused SA-MLP kernels, on the CPU.

`omni_pq_torch/csrc/point_logic.cuh` holds what the kernels decide beyond
plain arithmetic, and nothing the kernels do not compile: the FPS launch
plan (the cluster size P chosen from the shape), the (value, index) order
and the slice of a row each cluster CTA owns; the ball query's choice of
the rows that skip chunks, the layout of a row's chunk-box table, the
conservative ball-vs-box test and the point test. nvcc compiles it into the
kernels; here g++ compiles it into a small host harness
(`tests/torch_kernel_logic_harness.cpp`, `-ffp-contract=off`, so no product
is fused into an FMA, as in the kernels' `__f*_rn` arithmetic), loaded with
ctypes. The tests skip only when g++ is missing.

`omni_pq_torch/csrc/mlp_logic.cuh` holds the fused SA-MLP kernels' BN + ReLU
step and the train mode's pool from a centre's max and min
(`pool_from_extremes`); the same harness builds it, and it must equal numpy
float32's relu((a - mu) * mul + b), computed op by op, bitwise, and the max
of that over a centre's rows. The bfloat16 mode's step (`round_bf16`,
`bn_relu_bf16`, `pool_from_extremes_bf16`) is held bitwise against numpy
with ml_dtypes' bfloat16: af = a rounded to bfloat16, the BN in float32 op
by op, the result rounded to bfloat16, then the relu (+0 for every value
<= 0), and the max of that over a centre's rows.

The harness builds serial models of the kernels' loops from the header: FPS
over the slices of a P-CTA cluster (each thread's first maximum, each
warp's best, all slots merged) for P = 1, 8 and 16, and the ball query of
one centre three ways: every chunk scanned (the kernel's rows of up to 2048
points), chunks skipped by the box test with the kernel's margin (larger
rows), and with r2 itself (the test's own bound). The models are the
harness's own, not the kernels' warp-wide loops: a card run
(`tests/test_torch_port_cuda.py`, `chip_smoke.py`) is what holds the kernels
themselves. Tolerance: none. Indices equal the port's plain versions
(`omni_pq_torch.ops.reference`) and the JAX package's entry points
(`omni_pq_tpu.ops.fps` / `ball_query`, their Pallas kernels in interpret
mode or their oracles, as the JAX tests run them) on the same seeded numpy
inputs. Only on the shells within ~1 ULP of the radius is the JAX side left
out: XLA may fuse its d^2 into FMAs there (tests/test_torch_port_ops.py).
"""
import ctypes
import functools
import itertools
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from omni_pq_tpu import ops as jops
from omni_pq_torch import ops
from omni_pq_torch.data import make_batch
from omni_pq_torch.data.spatial import spatial_sort
from omni_pq_torch.ops.reference import radius_sq

ROOT = Path(__file__).resolve().parents[1]
HARNESS = ROOT / "tests" / "torch_kernel_logic_harness.cpp"
CSRC = ROOT / "omni_pq_torch" / "csrc"
_F32 = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host harness")
    out = tmp_path_factory.mktemp("kernel_logic") / "harness.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-std=c++20", "-pthread",
                    "-shared", "-fPIC", "-I", str(CSRC), "-o", str(out), str(HARNESS)],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(out))
    h.fps_max_points.restype = ctypes.c_int
    h.fps_plan_of.argtypes = [ctypes.c_int, _I32]
    h.fps_plan_of.restype = None
    h.fps_row.argtypes = [_F32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          _I32]
    h.fps_row.restype = None
    h.box_threshold.argtypes = [ctypes.c_float]
    h.box_threshold.restype = ctypes.c_float
    h.bq_query.argtypes = [_F32, ctypes.c_int, ctypes.c_int, _F32,
                           ctypes.c_int, ctypes.c_int, ctypes.c_float,
                           ctypes.c_int, _I32]
    h.bq_query.restype = ctypes.c_longlong
    h.skips_chunks.argtypes = [ctypes.c_int]
    h.skips_chunks.restype = ctypes.c_int
    h.bq_box_misses.argtypes = [_F32, ctypes.c_int, _F32, ctypes.c_int,
                                ctypes.c_float]
    h.bq_box_misses.restype = ctypes.c_longlong
    h.mlp_pool.argtypes = [_F32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           _F32, _F32, _F32, _F32]
    h.mlp_pool.restype = None
    h.mlp_bn_relu.argtypes = [_F32, ctypes.c_longlong, ctypes.c_int, _F32,
                              _F32, _F32, _F32]
    h.mlp_bn_relu.restype = None
    for name in ("mlp_bn_relu_bf16", "mlp_pool_bf16", "round_bf16_n"):
        getattr(h, name).restype = None
    h.mlp_bn_relu_bf16.argtypes = h.mlp_bn_relu.argtypes
    h.mlp_pool_bf16.argtypes = h.mlp_pool.argtypes
    h.round_bf16_n.argtypes = [_F32, ctypes.c_longlong, _F32]
    _LL = ctypes.c_longlong
    h.wl_packed_index.argtypes = [ctypes.c_int] * 3
    h.wl_packed_index.restype = _LL
    h.wl_stage_offset.argtypes = [ctypes.c_int] * 3
    h.wl_stage_offset.restype = _LL
    h.wl_desc_byte.argtypes = [ctypes.c_uint] + [ctypes.c_int] * 3
    h.wl_desc_byte.restype = _LL
    h.wl_acc_row_col.argtypes = [ctypes.c_int] * 3 + [_I32]
    h.wl_afrag_row_k.argtypes = [ctypes.c_int] * 4 + [_I32]
    for name in ("wl_acc_row_col", "wl_afrag_row_k", "wl_tile_reduce",
                 "wl_pitches"):
        getattr(h, name).restype = None
    h.wl_acc_for_afrag.argtypes = [ctypes.c_int] * 3
    h.wl_acc_for_afrag.restype = ctypes.c_int
    h.wl_f32_window.argtypes = [_LL, ctypes.c_int, ctypes.c_int,
                                ctypes.POINTER(_LL)]
    h.wl_f32_window.restype = None
    h.wl_tile_reduce.argtypes = [_F32] + [ctypes.c_int] * 3 + [_F32] * 4
    h.wl_pass_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    h.wl_pass_smem.restype = _LL
    h.wl_chain_smem.argtypes = [ctypes.c_int]
    h.wl_chain_smem.restype = _LL
    h.wl_chain_stages.argtypes = [ctypes.c_int]
    h.wl_chain_stages.restype = ctypes.c_int

    h.wl_chain_takes.argtypes = [_I32, ctypes.c_int, ctypes.c_int]
    h.wl_chain_takes.restype = ctypes.c_int
    h.wl_pitches.argtypes = [_I32]
    h.wl_halve8_origin.argtypes = [ctypes.c_int] * 3
    h.wl_halve8_origin.restype = ctypes.c_int
    return h


def _f32(a):
    a = np.ascontiguousarray(a, dtype=np.float32)
    return a, a.ctypes.data_as(_F32)


def _plan(lib, N):
    out = (ctypes.c_int * 3)()
    lib.fps_plan_of(N, out)
    return tuple(out)


def test_fps_plan_rule(lib):
    """P from the shape: one CTA (<= 256 threads, 8 points a thread) up to
    2048 points, else a 16-CTA cluster with the fewest warps that hold a
    slice at 16 points a thread, up to the capacity that the built library
    reports to the Python wrapper (fps_max_points), at least the 58 000
    points of the one-CTA kernel it replaced."""
    assert _plan(lib, 40000) == (16, 160, 16)        # sa1
    assert _plan(lib, 2048) == (1, 256, 8)           # sa2: points 2048
    assert _plan(lib, 1024) == (1, 128, 8)           # sa3, seeds, votes
    assert _plan(lib, 40) == (1, 32, 8)
    assert _plan(lib, 2049) == (16, 32, 16)
    cap = lib.fps_max_points()
    assert cap >= 58000
    assert _plan(lib, cap) == (16, 512, 16) and _plan(lib, cap + 1)[0] == 0
    for N in range(1, cap, 997):
        P, threads, ppt = _plan(lib, N)
        assert threads % 32 == 0 and 32 <= threads <= 512
        assert P * threads * ppt >= N and P == (1 if N <= 2048 else 16)


def _fps_case(name):
    r = np.random.default_rng(7)
    if name == "morton_scene":
        return make_batch(r, 1, 3000)["point_clouds"], 48
    if name == "near_ties":
        return r.uniform(0.5, 5, (1, 2500, 3)), 64
    if name == "cross_slice_ties":  # point n and n + 1000 coincide
        a = r.uniform(0.5, 5, (1, 1000, 3))
        return np.concatenate([a, a], 1), 64
    if name == "all_ties":  # every point the same: every pick ties
        return np.full((1, 2100, 3), [1.5, -2.0, 0.7]), 24
    if name == "zero_padding":
        return np.concatenate([r.normal(size=(1, 1700, 3)) + 2.0,
                               np.zeros((1, 400, 3))], 1), 96
    if name == "n_below_npoint":
        xyz = r.normal(size=(2, 40, 3)) + 2.0
        xyz[:, 30:] = 0.0
        return xyz, 64
    return r.uniform(0.5, 5, (2, 2333, 3)), 40  # N not a multiple of P*threads


FPS_CASES = ["morton_scene", "near_ties", "cross_slice_ties", "all_ties",
             "zero_padding", "n_below_npoint", "ragged"]


@functools.lru_cache(maxsize=None)
def _fps_refs(name):
    xyz, npoint = _fps_case(name)
    xyz = np.asarray(xyz, np.float32)
    want = ops.fps_ref(torch.from_numpy(xyz), npoint).numpy()
    jax_want = np.asarray(jops.fps(jnp.asarray(xyz), npoint))
    return xyz, npoint, want, jax_want


@pytest.mark.parametrize("P", [1, 8, 16])
@pytest.mark.parametrize("case", FPS_CASES)
def test_fps_cluster_logic_equals_plain_and_jax(lib, case, P):
    xyz, npoint, want, jax_want = _fps_refs(case)
    got = np.zeros_like(want)
    for b in range(xyz.shape[0]):
        row, ptr = _f32(xyz[b])
        out = np.zeros(npoint, np.int32)
        lib.fps_row(ptr, row.shape[0], npoint, P, out.ctypes.data_as(_I32))
        got[b] = out
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_want)
    if case == "all_ties":
        assert (got == 0).all()
    if case == "cross_slice_ties":  # the lower of two coinciding points
        assert (got < 1000).all()
    if case == "zero_padding":
        assert got.max() < 1700


def _shells(r, B=2, N=2048, S=128, radius=0.4):
    ctr = r.uniform(1, 4, (B, S, 3))
    base = ctr[np.arange(B)[:, None], r.integers(0, S, (B, N))]
    dirs = r.normal(size=(B, N, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return base + dirs * radius * (1 + r.normal(scale=1e-6, size=(B, N, 1))), ctr


def _morton(xyz):
    return np.stack([x[spatial_sort(x)] for x in np.asarray(xyz, np.float32)])


def _bq_case(name):
    r = np.random.default_rng(11)
    if name.startswith("shells"):  # points within ~1 ULP of the radius
        xyz, ctr = _shells(r)
        return (_morton(xyz) if name == "shells_morton" else xyz), ctr, 0.4, 64
    if name == "ball_faces":
        # 32-point chunks on the ball's +-x, +-y, +-z faces, radii a few
        # ULP apart: each box's gap is its nearest point's |c - p|
        c = np.array([1.1, 2.3, 0.7], np.float32)
        j = np.arange(2304)
        xyz = np.tile(c, (j.size, 1))
        xyz[j, (j // 64) % 3] += (np.where(j // 192 % 2, -0.3, 0.3)
                                  * (1 + (j % 64 - 32) * 6e-8))
        return xyz[None], c[None, None], 0.3, 64
    if name == "morton_scene":
        pc = make_batch(r, 2, 4000)["point_clouds"]
        return pc, pc[:, ::40][:, :100], 0.2, 64
    if name == "fps_ordered":  # sa2's input: points in FPS order
        pc = make_batch(r, 1, 3000)["point_clouds"]
        sub = pc[:, ops.fps_ref(torch.from_numpy(pc), 512).numpy()[0]]
        return sub, sub[:, :128], 0.4, 32
    xyz = _morton(r.uniform(size=(2, 1999, 3)) * 3)  # a partial last chunk
    ctr = xyz[:, ::8][:, :200].copy()
    if name == "no_hit_centres":
        ctr[:, ::3] += 50.0
        return xyz, ctr, 0.4, 16
    if name == "zero_padding":
        xyz[:, 1700:] = 0.0
        ctr[:, ::4] = 0.05  # centres beside the padding at the origin
        return xyz, ctr, 0.3, 32
    return xyz, ctr, 0.3, 32


BQ_CASES = ["morton_scene", "shells", "shells_morton", "ball_faces",
            "no_hit_centres", "zero_padding", "ragged_last_chunk",
            "fps_ordered"]
ULP_CASES = ("shells", "shells_morton", "ball_faces")


@pytest.mark.parametrize("case", BQ_CASES)
def test_ball_query_chunk_skip_equals_plain_and_jax(lib, case):
    xyz, ctr, radius, k = _bq_case(case)
    xyz, xp = _f32(xyz)
    ctr, cp = _f32(ctr)
    B, N, _ = xyz.shape
    S = ctr.shape[1]
    want = ops.ball_query_ref(radius, k, torch.from_numpy(xyz),
                              torch.from_numpy(ctr)).numpy()
    scanned = {}
    for mode in (0, 1, 2):  # whole scan; boxes with the kernel's margin; r2
        got = np.zeros((B, S, k), np.int32)
        scanned[mode] = lib.bq_query(xp, B, N, cp, S, k, radius_sq(radius),
                                     mode, got.ctypes.data_as(_I32))
        np.testing.assert_array_equal(got, want)
    assert scanned[2] <= scanned[1] <= scanned[0]
    if case not in ULP_CASES:
        np.testing.assert_array_equal(
            got, np.asarray(jops.ball_query(radius, k, jnp.asarray(xyz),
                                            jnp.asarray(ctr))))
    chunks = B * S * -(-N // 32)
    if case == "morton_scene":  # Morton order: most chunks skipped
        assert scanned[1] < 0.2 * chunks and lib.skips_chunks(N)
    if case == "fps_ordered":  # the kernel scans such rows whole
        assert not lib.skips_chunks(N)
    if case == "no_hit_centres":
        assert (got[:, ::3] == 0).all()
    if case == "zero_padding":
        assert (got[:, ::4] >= 1700).any()


@pytest.mark.parametrize("case", ["shells_morton", "ball_faces",
                                  "morton_scene", "zero_padding"])
def test_box_test_never_drops_a_hit(lib, case):
    """Without its margin (r2 itself) the box test still admits every chunk
    that holds a hit: the gaps are rounded like the point test's c - p."""
    xyz, ctr, radius, _ = _bq_case(case)
    r2 = radius_sq(radius)
    assert lib.box_threshold(r2) > r2
    for b in range(xyz.shape[0]):
        row, xp = _f32(xyz[b])
        c, cp = _f32(ctr[b])
        assert lib.bq_box_misses(xp, row.shape[0], cp, c.shape[0], r2) == 0


def _bn_relu_np(a, mu, mul, b):
    """relu(((a - mu) * mul) + b) in numpy float32, one rounding an op; the
    relu gives +0 for every value <= 0, as the kernels' does."""
    y = ((a - mu) * mul) + b
    return np.where(y > 0, y, np.float32(0))


def _mlp_case(name):
    """(a (centres, K, C), mu, mul, b) float32. mul has both signs, +0 and
    -0 in every case."""
    r = np.random.default_rng(13)
    centres, K, C = 6, 16, 12
    a = r.normal(size=(centres, K, C)).astype(np.float32)
    mu = r.normal(0, 0.3, C).astype(np.float32)
    mul = (r.uniform(0.5, 2.0, C) * np.where(np.arange(C) % 2, -1, 1)
           ).astype(np.float32)
    mul[2], mul[3] = 0.0, -0.0
    b = r.normal(0, 0.2, C).astype(np.float32)
    if name == "ties":  # a centre's max and min each held by several rows
        a[:, ::4] = a[:, :1]
        a[:, 1::5] = a[:, 2:3]
        a[3] = a[3, :1]  # a constant centre
    if name == "all_negative":  # every value of a centre relus to 0
        a[2] = np.where(mul > 0, -50.0, 50.0).astype(np.float32)
        a[2, :, 2:4] = 0.0
        b[2:4] = -0.5
    if name == "zero_bias":  # b = +0 and -0: the -0 sums of mul = +-0
        b[:] = 0.0
        b[1::2] = -0.0
        a[1] = mu  # a - mu = 0 exactly
    return a, mu, mul, b


@pytest.mark.parametrize("case", ["signs", "ties", "all_negative",
                                  "zero_bias"])
def test_pool_from_extremes_is_the_max_of_bn_relu_bitwise(lib, case):
    """mlp_logic::bn_relu equals numpy's op-by-op float32 relu((a - mu) *
    mul + b) bitwise, and the train mode's pool, bn_relu of each channel's
    max (mul >= 0) or min (mul < 0, sign bit set) over a centre's rows,
    equals the max over the rows of bn_relu bitwise, for mul of both signs,
    +0 and -0, ties within a centre and centres whose values all relu to
    0."""
    a, mu, mul, b = _mlp_case(case)
    centres, K, C = a.shape
    a_c, ap = _f32(a)
    vecs = [_f32(v) for v in (mu, mul, b)]
    want_h = _bn_relu_np(a, mu, mul, b)
    got_h = np.zeros_like(a)
    lib.mlp_bn_relu(ap, a.size, C, *(p for _, p in vecs),
                    got_h.ctypes.data_as(_F32))
    np.testing.assert_array_equal(got_h.view(np.uint32),
                                  want_h.view(np.uint32))
    want = want_h.max(axis=1)
    got = np.zeros((centres, C), np.float32)
    lib.mlp_pool(ap, centres, K, C, *(p for _, p in vecs),
                 got.ctypes.data_as(_F32))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not np.signbit(got).any()  # the pool is never -0
    if case == "all_negative":
        assert (got[2] == 0).all()


def _bf16(x):
    """numpy float32 rounded to bfloat16 (ties to even) and back."""
    with np.errstate(invalid="ignore"):  # NaN stays NaN
        return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(
            np.float32)


def test_round_bf16_matches_ml_dtypes_bitwise(lib):
    """mlp_logic::round_bf16 (the host spelling of __float2bfloat16_rn) on
    ties, values next to ties, subnormals, the largest finite values (which
    round to inf), infinities and NaN."""
    r = np.random.default_rng(17)
    bits = np.concatenate([
        r.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.uint32),
        np.array([0x3f808000, 0x3f818000, 0x3f807fff, 0x3f808001,  # ties
                  0x00008000, 0x00018000, 0x00000001, 0x807fffff,  # subnormal
                  0x7f7fffff, 0xff7fffff, 0x7f7f8000, 0x7f800000,
                  0xff800000, 0x00000000, 0x80000000], np.uint32)])
    a = bits.view(np.float32)
    got = np.zeros_like(a)
    lib.round_bf16_n(a.ctypes.data_as(_F32), a.size,
                     got.ctypes.data_as(_F32))
    want = _bf16(a)
    finite = ~np.isnan(want)
    np.testing.assert_array_equal(got[finite].view(np.uint32),
                                  want[finite].view(np.uint32))
    assert np.isnan(got[~finite]).all()


@pytest.mark.parametrize("case", ["signs", "ties", "all_negative",
                                  "zero_bias"])
def test_pool_from_extremes_bf16_is_the_max_of_bn_relu_bitwise(lib, case):
    """The bfloat16 mode's BN step equals numpy's relu(bf16((bf16(a) - mu) *
    mul + b)) bitwise, op by op in float32, and its pool from a centre's
    max and min of bf16(a) equals the max over the rows, for scales of both
    signs, +0 and -0, ties and centres that relu to 0 (rounding to bfloat16
    is monotone, so the max/min choice still holds bitwise)."""
    a, mu, mul, b = _mlp_case(case)
    if case == "zero_bias":  # bf16(a) - mu = 0 exactly in centre 1
        mu = _bf16(mu)
        a[1] = mu
    else:
        a = a * np.float32(3.3)  # values off the bfloat16 grid
    centres, K, C = a.shape
    a_c, ap = _f32(a)
    vecs = [_f32(v) for v in (mu, mul, b)]
    y = _bf16((_bf16(a) - mu) * mul + b)
    want_h = np.where(y > 0, y, np.float32(0))
    got_h = np.zeros_like(a)
    lib.mlp_bn_relu_bf16(ap, a.size, C, *(p for _, p in vecs),
                         got_h.ctypes.data_as(_F32))
    np.testing.assert_array_equal(got_h.view(np.uint32),
                                  want_h.view(np.uint32))
    want = want_h.max(axis=1)
    got = np.zeros((centres, C), np.float32)
    lib.mlp_pool_bf16(ap, centres, K, C, *(p for _, p in vecs),
                      got.ctypes.data_as(_F32))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not np.signbit(got).any()
    assert (got == _bf16(got)).all()  # bfloat16 values


# ---- the bfloat16 fused kernels' layouts and plans (csrc/wgmma_logic.cuh)
#
# The kernels (csrc/fused_mlp_bf16.cu) feed wgmma.mma_async from a weight
# stage in shared memory, read through a no-swizzle descriptor, and an A
# operand in registers; the layer chain hands each accumulator to the next
# layer as its A operand. These tests hold the header's maps against
# models of what wgmma reads and writes (PTX ISA's canonical K-major layout
# and its m64nNk16 fragment layouts, as the header states them) and against
# the wrapper's own weight packing; the card tests hold the kernels.

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100


@pytest.mark.parametrize("cin,cout", [(3, 128), (259, 256), (256, 512),
                                      (20, 8)])
def test_packed_weights_are_where_the_descriptor_reads(lib, cin, cout):
    """The wrapper packs W^T (torch, `_weights_packed`) exactly as
    packed_weight_index says, a bijection onto the packed array; each stage
    of 8-row-aligned rows is the contiguous block at packed_stage_offset;
    and for every (row, k) of a stage the descriptor that make_desc builds,
    decoded as the hardware reads it, finds the element the packing put
    there."""
    from omni_pq_torch.ops.fused_mlp import _weights_packed
    r = np.random.default_rng(cin + cout)
    w = torch.from_numpy(r.normal(size=(cin, cout)).astype(np.float32))
    packed, kp = _weights_packed([w])[0]
    assert kp % 64 == 0 and kp >= cin
    wt = torch.zeros(cout, kp, dtype=torch.bfloat16)
    wt[:, :cin] = w.t()
    idx = np.array([[lib.wl_packed_index(n, k, cout) for k in range(kp)]
                    for n in range(cout)])
    assert np.array_equal(np.sort(idx.ravel()), np.arange(cout * kp))
    assert torch.equal(packed[torch.from_numpy(idx)], wt)
    base = 0x1230  # a 16-byte aligned shared address
    for kc in range(kp // 64):
        for n0 in sorted({0, (cout // 2) // 8 * 8}):
            rows = min(256, cout - n0)
            off = lib.wl_stage_offset(kc, n0, cout)
            stage = packed[off:off + rows * 64]
            seen = set()
            for n in range(rows):
                for k in range(64):
                    s, kk = divmod(k, 16)
                    byte = lib.wl_desc_byte(base, n, kk, s) - base
                    assert byte % 2 == 0 and 0 <= byte < rows * 128
                    seen.add(byte)
                    assert stage[byte // 2] == wt[n0 + n, kc * 64 + k]
            assert len(seen) == rows * 64


@pytest.mark.parametrize("n", [128, 256])
def test_accumulator_covers_the_tile_and_is_the_next_a_fragment(lib, n):
    """The m64nN accumulator map puts every (row, column) of the 64 x n
    tile in exactly one register of one lane, and the register-A fragment
    of k step s of the next layer is, register by register, the
    accumulator that holds the same (row, column 16 s + k)."""
    out = (ctypes.c_int * 2)()
    owner = {}
    for w in range(4):
        for lane in range(32):
            for r in range(n // 2):
                lib.wl_acc_row_col(w, lane, r, out)
                key = (out[0], out[1])
                assert key not in owner and 0 <= out[0] < 64 \
                    and 0 <= out[1] < n
                owner[key] = (w, lane, r)
    assert len(owner) == 64 * n
    for w in range(4):
        for lane in range(32):
            for s in range(n // 16):
                for reg in range(4):
                    for half in range(2):
                        lib.wl_afrag_row_k(w, lane, reg, half, out)
                        row, k = out[0], out[1]
                        assert owner[(row, 16 * s + k)] == (
                            w, lane, lib.wl_acc_for_afrag(s, reg, half))


def _bf16_values(r, shape, zeros=0.0):
    v = r.normal(size=shape).astype(ml_dtypes.bfloat16).astype(np.float32)
    v[r.uniform(size=shape) < zeros] = 0.0
    return v


@pytest.mark.parametrize("case", ["n256_seg16", "n128_seg32", "n256_seg64",
                                  "n128_seg48_partial", "n256_seg128",
                                  "zeros_and_signs"])
def test_epilogue_reductions_match_numpy_in_their_order(lib, case):
    """The pass kernel's column sums of af and af^2 over a 128-row tile in
    the kernels' fixed order (each lane's rows g and g + 8, the header's
    halve8 over g run by 32 lockstep lanes, each result at the column
    halve8_origin names, then the 8 warps in order) equal a numpy float32
    model of that order bitwise, and each segment's max and min equal
    numpy's: every column reduced exactly once."""
    n, seg, valid, zeros = {
        "n256_seg16": (256, 16, 128, 0.0), "n128_seg32": (128, 32, 128, 0.0),
        "n256_seg64": (256, 64, 128, 0.0),
        "n128_seg48_partial": (128, 48, 96, 0.0),
        "n256_seg128": (256, 128, 128, 0.0),
        "zeros_and_signs": (128, 16, 64, 0.5)}[case]
    r = np.random.default_rng(len(case))
    af = _bf16_values(r, (128, n), zeros) * np.float32(8.0)
    af[valid:] = 0.0  # rows past the tile's valid ones read as 0
    s1, s2 = np.zeros(n, np.float32), np.zeros(n, np.float32)
    mx = np.zeros((valid // seg, n), np.float32)
    mn = np.zeros_like(mx)
    ptr = lambda a: a.ctypes.data_as(_F32)  # noqa: E731
    afc = np.ascontiguousarray(af)
    lib.wl_tile_reduce(ptr(afc), n, seg, valid, ptr(s1), ptr(s2), ptr(mx),
                       ptr(mn))
    # numpy: per warp, x_g = af[16w+g] + af[16w+g+8] for g = 0..7, the
    # butterfly ((x0+x1)+(x2+x3))+((x4+x5)+(x6+x7)), then warps 0..7 in turn
    t = af.reshape(8, 2, 8, n)  # (warp, row half, g, column)
    for got, x in ((s1, t[:, 0] + t[:, 1]),
                   (s2, t[:, 0] * t[:, 0] + t[:, 1] * t[:, 1])):
        x = x[:, 0::2] + x[:, 1::2]
        x = x[:, 0::2] + x[:, 1::2]
        x = x[:, 0] + x[:, 1]
        want = x[0]
        for w in range(1, 8):
            want = want + x[w]
        assert want.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    segs = af[:valid].reshape(valid // seg, seg, n)
    assert np.array_equal(mx, segs.max(1)) and np.array_equal(mn, segs.min(1))


# (K, widths [C0, C1, ...], whether the eval chain takes them): the main
# path's fused calls and the card tests' bfloat16 cases
PLAN_SHAPES = {
    "sa1": (64, [3, 128, 128, 256], True),
    "sa2": (32, [259, 256, 256, 512], True),
    "sa3_sa4": (16, [515, 256, 256, 512], True),
    "k16_one_layer": (16, [20, 128], True),
    "k48": (48, [36, 128, 256], False),
    "k144": (144, [5, 128, 128], False),
    "k128_sa2": (128, [259, 256, 256, 512], False),
    "k256_sa2": (256, [259, 256, 256, 512], False),
    "wide_middle": (32, [64, 512, 256], False),
    "too_many_channels": (16, [515, 256, 256, 256, 512], False),
}


@pytest.mark.parametrize("case", sorted(PLAN_SHAPES))
def test_plans_fit_shared_memory(lib, case):
    """Every pass of the pass plan (float32 rows in pass 0, bfloat16 a_j
    after it) and the eval chain (its ring as deep as fits, 3 to 8 stages)
    stay within the card's 232 448 bytes a block; the chain takes exactly
    the shapes whose centres fit a warpgroup's 64 rows, whose middle layers
    fit the registers and whose BN vectors fit their 1024 channels."""
    K, chans, takes = PLAN_SHAPES[case]
    for j, cin in enumerate(chans[:-1]):
        assert lib.wl_pass_smem(int(j == 0), cin) <= SMEM_LIMIT
    c = (ctypes.c_int * len(chans))(*chans)
    assert bool(lib.wl_chain_takes(c, len(chans) - 1, K)) == takes
    assert lib.wl_chain_smem(chans[0]) <= SMEM_LIMIT
    assert 3 <= lib.wl_chain_stages(chans[0]) <= 8


@pytest.mark.parametrize("cin", [3, 20, 36, 259, 515])
def test_f32_windows_are_aligned_and_cover_the_rows(lib, cin):
    """A float32 row's 64-k window is a legal bulk copy (16-byte aligned at
    both ends), fits the stage's 272-byte row, starts at most 3 floats
    before the row's k0, covers k0 .. min(k0 + 64, cin) - 1, and never
    reaches past the last row of a tile whose row count is a multiple of
    16."""
    pitch = (ctypes.c_int * 2)()
    lib.wl_pitches(pitch)
    out = (ctypes.c_longlong * 3)()
    rows = 32
    for row in range(rows):
        for k0 in range(0, cin, 64):
            lib.wl_f32_window(row, cin, k0, out)
            begin, nbytes, off = out
            first = (row * cin + k0) * 4
            last = (row * cin + min(k0 + 64, cin)) * 4
            assert begin % 16 == 0 and nbytes % 16 == 0
            assert nbytes <= 4 * pitch[1] and 0 <= off <= 3
            assert begin + 4 * off == first and begin + nbytes >= last
            assert begin + nbytes <= rows * cin * 4


def test_shared_reads_spread_over_the_banks(lib):
    """wgmma's reads of a core matrix (8 rows of 16 bytes) cover the 32
    banks once; a warp's 4-byte A-fragment loads from a bfloat16 stage
    (rows g, k pair 2q) hit 32 distinct banks; from a float32 stage
    (rows g, k 2q, every choice of the rows' window offsets 0-3) at most 3
    lanes share a bank (the layer-0 loads: 8 a k step and thread)."""
    pitch = (ctypes.c_int * 2)()
    lib.wl_pitches(pitch)
    banks = {(lib.wl_desc_byte(0, n, k, 0) // 4) % 32
             for n in range(8) for k in range(0, 8, 2)}
    assert banks == set(range(32))
    bf16 = [((g * pitch[0] + 2 * q) * 2 // 4) % 32
            for g in range(8) for q in range(4)]
    assert len(set(bf16)) == 32
    worst = 0
    for offs in itertools.product(range(4), repeat=8):
        f32 = np.bincount([(g * pitch[1] + offs[g] + 2 * q) % 32
                           for g in range(8) for q in range(4)])
        worst = max(worst, int(f32.max()))
    assert worst <= 3


@pytest.mark.parametrize("N", [16, 32, 64])
def test_halving_origins_cover_every_index_once(lib, N):
    """Over the 8 lanes of a quad column, halve8_origin(k, g, N) for
    k < N / 8 names each of the N indices exactly once: every value is
    reduced and written by one lane."""
    seen = sorted(lib.wl_halve8_origin(k, g, N)
                  for g in range(8) for k in range(N // 8))
    assert seen == list(range(N))
