"""The port's point-cloud ops (omni_pq_torch.ops) against the JAX package's.

The same numpy inputs go through the JAX function (its Pallas kernels in
interpret mode on the CPU, or its jnp oracle below the size threshold, as the
JAX package's own tests run them) and through the port on the CPU, where each
op is its plain PyTorch version. Tolerances: FPS / ball-query / three_nn
indices bitwise and grouped xyz exact (same elementwise arithmetic, no FMA on
either side); interpolation floats within 1e-6 (the JAX side sums squares and
matmuls in XLA's order).
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from omni_pq_tpu import ops as jops
from omni_pq_tpu.data.spatial import spatial_sort as jax_spatial_sort
from omni_pq_torch import ops
from omni_pq_torch.data.spatial import spatial_sort
from omni_pq_torch.ops import cuda as kernels


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _j(x):
    return jnp.asarray(np.asarray(x, dtype=np.float32))


def _fps_case(name):
    r = np.random.default_rng(0)
    if name == "near_ties":  # the (2, 5000) regression of tests/test_ops.py
        return r.uniform(0.5, 5, (2, 5000, 3)), 512
    if name == "zero_padding":
        xyz = r.normal(size=(2, 600, 3)) + 2.0
        xyz[:, 450:] = 0.0
        return xyz, 128
    if name == "n_le_npoint":  # the JAX wrapper takes its oracle here
        xyz = r.normal(size=(2, 40, 3)) + 2.0
        xyz[:, 30:] = 0.0
        return xyz, 64
    return r.normal(size=(11, 300, 3)) + 2.0, 32  # JAX batch chunking


@pytest.mark.parametrize("case", ["near_ties", "zero_padding", "n_le_npoint",
                                  "batch_chunking"])
def test_fps_bitwise(case):
    xyz, npoint = _fps_case(case)
    want = np.asarray(jops.fps(_j(xyz), npoint))
    got = ops.fps(_t(xyz), npoint)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "zero_padding":
        assert got.max() < 450  # padding is never picked


def _bq_cloud(n, s, morton, rng):
    xyz = rng.uniform(size=(2, n, 3)).astype(np.float32) * 3
    if morton:
        xyz = np.stack([xyz[b][spatial_sort(xyz[b])] for b in range(2)])
    ctr = xyz[:, :: n // s][:, :s].copy()
    return xyz, ctr


# (N, S, K, radius, Morton order, every 3rd centre off the cloud); N*S on
# both sides of the JAX wrapper's 256*1024 threshold (oracle / Pallas)
BQ_CASES = {
    "oracle_side": (800, 64, 16, 0.4, True, True),
    "pallas_side_morton_no_hit": (2000, 256, 16, 0.4, True, True),
    "pallas_side_overflowing": (2000, 200, 8, 5.0, False, False),
}


@pytest.mark.parametrize("case", sorted(BQ_CASES))
def test_ball_query_group_bitwise(case):
    n, s, k, radius, morton, off_cloud = BQ_CASES[case]
    xyz, ctr = _bq_cloud(n, s, morton, np.random.default_rng(1))
    if off_cloud:
        ctr[:, ::3] += 50.0
    idx_j, grouped_j = jops.ball_query_group(radius, k, _j(xyz), _j(ctr))
    idx, grouped = ops.ball_query_group(radius, k, _t(xyz), _t(ctr))
    assert idx.dtype == torch.int32 and grouped.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(grouped.numpy(), np.asarray(grouped_j))
    # the idx-only entry point shares the semantics
    np.testing.assert_array_equal(
        ops.ball_query(radius, k, _t(xyz), _t(ctr)).numpy(), np.asarray(idx_j))
    if off_cloud:
        assert (idx.numpy()[:, ::3] == 0).all()
    if case == "pallas_side_overflowing":
        assert (np.diff(idx.numpy(), axis=-1) > 0).all()  # every slot a hit


def test_morton_order_matches_jax():
    pts = np.random.default_rng(2).uniform(size=(3000, 3)).astype(np.float32)
    np.testing.assert_array_equal(spatial_sort(pts), jax_spatial_sort(pts))


def test_ball_query_boundary_disagreements_are_1ulp_only():
    """The adversarial shells of tests/test_ops.py: points at radius*(1 +-
    1e-6). Membership may differ only within 3e-6 relative of the radius
    (XLA may fuse the JAX side's d^2 into FMAs; the port never does)."""
    rng = np.random.default_rng(0)
    B, N, S, r = 2, 2048, 128, 0.4
    ctr = rng.uniform(1, 4, (B, S, 3)).astype(np.float32)
    pts = []
    for b in range(B):
        base = ctr[b][rng.integers(0, S, N)]
        dirs = rng.normal(size=(N, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        pts.append(base + dirs * r * (1 + rng.normal(scale=1e-6, size=(N, 1))))
    xyz = np.stack(pts).astype(np.float32)
    a = ops.ball_query_group(r, 64, _t(xyz), _t(ctr))[0].numpy()
    b = np.asarray(jops.ball_query_group(r, 64, _j(xyz), _j(ctr))[0])
    for bi, si in np.argwhere((a != b).any(-1)):
        for j in set(a[bi, si].tolist()) ^ set(b[bi, si].tolist()):
            d = np.linalg.norm(xyz[bi, j].astype(np.float64)
                               - ctr[bi, si].astype(np.float64))
            assert abs(d - r) / r < 3e-6, (bi, si, j, d)


def test_reference_oracles_match_jax():
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(2, 100, 3)) + 2.0
    np.testing.assert_array_equal(ops.fps_ref(_t(xyz), 16).numpy(),
                                  np.asarray(jops.fps_ref(_j(xyz), 16)))
    pts = rng.uniform(size=(2, 200, 3))
    np.testing.assert_array_equal(
        ops.ball_query_ref(0.2, 8, _t(pts), _t(pts[:, :30])).numpy(),
        np.asarray(jops.ball_query_ref(0.2, 8, _j(pts), _j(pts[:, :30]))))
    unk, kno = rng.normal(size=(2, 50, 3)), rng.normal(size=(2, 20, 3))
    d, i = ops.three_nn_ref(_t(unk), _t(kno))
    dj, ij = jops.three_nn_ref(_j(unk), _j(kno))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-6, atol=1e-6)


def test_interpolation_ops_match_jax():
    rng = np.random.default_rng(4)
    unk = rng.normal(size=(2, 64, 3)).astype(np.float32)
    kno = rng.normal(size=(2, 24, 3)).astype(np.float32)
    kno[:, :8] = unk[:, :8]  # coinciding points: recomputed d2 must be 0
    feats = rng.normal(size=(2, 24, 5)).astype(np.float32)
    d, i = ops.three_nn(_t(unk), _t(kno))
    dj, ij = jops.three_nn(_j(unk), _j(kno))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-6, atol=1e-6)
    assert (d.numpy()[:, :8, 0] == 0).all()
    idx = rng.integers(0, 24, (2, 10, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        ops.group_points(_t(feats), torch.from_numpy(idx)).numpy(),
        np.asarray(jops.group_points(_j(feats), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        ops.gather_points(_t(feats), torch.from_numpy(idx[..., 0])).numpy(),
        np.asarray(jops.gather_points(_j(feats), jnp.asarray(idx[..., 0]))))
    w = rng.uniform(size=(2, 64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        ops.three_interpolate(_t(feats), i, _t(w)).numpy(),
        np.asarray(jops.three_interpolate(_j(feats), ij, _j(w))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        ops.interpolate_features(_t(unk), _t(kno), _t(feats)).numpy(),
        np.asarray(jops.interpolate_features(_j(unk), _j(kno), _j(feats))),
        rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor goes to the plain version (no launch is counted); any
    other device must be CUDA, or the wrapper raises."""
    xyz = _t(np.random.default_rng(5).normal(size=(1, 64, 3)) + 2.0)
    counts = (ops.fps.launches, ops.ball_query_group.launches,
              ops.ball_query.launches)
    assert torch.equal(ops.fps(xyz, 8), ops.fps_plain(xyz, 8))
    for a, b in zip(ops.ball_query_group(0.5, 4, xyz, xyz[:, :8]),
                    ops.ball_query_group_plain(0.5, 4, xyz, xyz[:, :8])):
        assert torch.equal(a, b)
    ops.ball_query(0.5, 4, xyz, xyz[:, :8])
    assert counts == (ops.fps.launches, ops.ball_query_group.launches,
                      ops.ball_query.launches)
    with ops.plain_versions():  # the switch the card's checks use
        assert ops.fps is ops.fps_plain
        assert ops.ball_query_group is ops.ball_query_group_plain
    assert ops.fps is not ops.fps_plain and hasattr(ops.fps, "launches")
    meta = torch.empty(1, 64, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.fps(meta, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ball_query_group(0.5, 4, meta, meta)


def test_kernel_build_needs_nvcc(monkeypatch):
    """The kernels are built at first use on the card's machine; without the
    CUDA toolkit the build raises instead of falling back."""
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has the CUDA toolkit")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()
    for name in ("fps", "ball_query"):
        src = (kernels.CSRC / f"{name}.cu").read_text()
        fn_name, argtypes = kernels._SIGNATURES[name]
        assert f'extern "C" int {fn_name}(' in src
        assert "Replaces:" in src and "sm_90a" in src
