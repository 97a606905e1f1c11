"""The port's CUDA kernels on the card, against their plain versions.

Marked `cuda`; each test skips (in its fixture) when torch sees no card.
Run on a machine with a card and nvcc, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX, which that machine lacks;
this file imports only torch, numpy and the port.) Tolerance: none. Each
kernel must equal its plain version bitwise, indices and grouped xyz alike,
and the --smoke forward through the kernels must equal the one through the
plain versions.
"""
import numpy as np
import pytest
import torch

from omni_pq_torch import ops
from omni_pq_torch.config import SMOKE_MODEL, ModelConfig
from omni_pq_torch.data import make_batch
from omni_pq_torch.infer import build_model, eval_forward
from omni_pq_torch.ops.fps import MAX_POINTS

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


FPS_CASES = {
    "near_ties": lambda r: (r.uniform(0.5, 5, (2, 5000, 3)), 512),
    "zero_padding": lambda r: (np.concatenate(
        [r.normal(size=(2, 450, 3)) + 2.0, np.zeros((2, 150, 3))], 1), 128),
    "n_below_npoint": lambda r: (r.normal(size=(3, 40, 3)) + 2.0, 64),
    "partial_warp": lambda r: (r.normal(size=(2, 33, 3)) + 2.0, 8),
    "sa1_scale": lambda r: (make_batch(r, 2)["point_clouds"], 2048),
}


@pytest.mark.parametrize("case", sorted(FPS_CASES))
def test_fps_kernel_equals_plain(dev, case):
    xyz, npoint = FPS_CASES[case](np.random.default_rng(0))
    x = _cuda(xyz, dev)
    got = ops.fps(x, npoint)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (x.shape[0], npoint)
    assert torch.equal(got, ops.fps_plain(x, npoint))


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
                                  "shells_k64", "sa1_scale"])
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
    with pytest.raises(ValueError, match="N <="):
        ops.fps(torch.ones(1, MAX_POINTS + 1, 3, device=dev), 16)
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
