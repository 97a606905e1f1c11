"""The index logic of the port's FPS and ball-query CUDA kernels, on the CPU.

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
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
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
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", "-I", str(CSRC), "-o", str(out), str(HARNESS)],
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
