"""Plain PyTorch versions of the point-cloud kernels.

The same semantics as the JAX package's oracles (`omni_pq_tpu/ops/reference.py`),
written as ordinary tensor ops. They run on any device: the CPU tests use them
as the ops themselves, and on the card they are what each hand-written kernel
is held against. Every distance is written as separate elementwise ops,
((dx*dx + dy*dy) + dz*dz), never `.pow(2).sum(-1)`: each eager op is its own
kernel, so nothing is contracted into an FMA, and the CUDA kernels (which
spell the same order with `__f*_rn` intrinsics) can be bitwise equal to them.

Semantics (the reference CUDA ops):
  - FPS (sampling_gpu.cu:74-234): index 0 first; points with |p|^2 <= 1e-3
    are never picked; each step takes the point with the largest running min
    distance to the picked set, lowest index on ties.
  - ball query (ball_query_gpu.cu:14-49): per centre the first (by index)
    <= nsample points with d^2 < r^2; unfilled slots repeat the first hit, a
    centre with no hit gets index 0 everywhere.
  - three_nn (interpolate_gpu.cu:14-73): 3 nearest known points, brute force.
"""
from __future__ import annotations

import numpy as np
import torch

FPS_SKIP_NORM_SQ = 1e-3  # points with ||p||^2 <= this are never selected


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcast |a - b|^2 over a trailing xyz axis, as ((dx^2+dy^2)+dz^2)."""
    dx = a[..., 0] - b[..., 0]
    dy = a[..., 1] - b[..., 1]
    dz = a[..., 2] - b[..., 2]
    return dx * dx + dy * dy + dz * dz


def radius_sq(radius: float) -> float:
    """r^2 as the float32 both the JAX oracle and the Pallas kernel compare
    against: the product taken in double, then rounded once to float32."""
    return float(np.float32(radius * radius))


def fps_ref(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Furthest point sampling: (B, N, 3) float32 -> (B, npoint) int32.
    Other coordinate types are sampled on their float32 copy, as the JAX
    package's oracle (`interop/oracle_ops.py`) samples them."""
    xyz = xyz.detach().float()  # indices only: no graph to build
    B, N, _ = xyz.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    valid = x * x + y * y + z * z > FPS_SKIP_NORM_SQ
    # invalid points start at -1: min() keeps them there (d >= 0), so they
    # never win the argmax
    mind = torch.where(valid, 1e10, -1.0).to(torch.float32)
    out = torch.zeros(B, npoint, dtype=torch.int32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        c = xyz[rows, last][:, None, :]  # (B, 1, 3)
        mind = torch.minimum(mind, _sq_dist(xyz, c))
        last = torch.argmax(mind, dim=-1)  # first maximal index
        out[:, i] = last.to(torch.int32)
    return out


def ball_query_ref(radius: float, nsample: int, xyz: torch.Tensor,
                   new_xyz: torch.Tensor) -> torch.Tensor:
    """(B,N,3) points x (B,S,3) centres -> (B,S,nsample) int32 indices.

    One batch row at a time, so the (S, N) distance matrix stays small.
    The decisions are made on float32 copies of the coordinates, whatever
    their type, as the JAX package's oracle makes them."""
    xyz, new_xyz = xyz.detach().float(), new_xyz.detach().float()
    N = xyz.shape[1]
    r2 = radius_sq(radius)
    cols = torch.arange(N, dtype=torch.int32, device=xyz.device)
    rows = []
    for b in range(xyz.shape[0]):
        d2 = _sq_dist(new_xyz[b][:, None, :], xyz[b][None, :, :])  # (S, N)
        # first nsample hits by index == nsample smallest of (idx if hit else N)
        key = torch.where(d2 < r2, cols, N)
        idx = torch.topk(key, nsample, dim=-1, largest=False,
                         sorted=True).values
        first = idx[:, :1]
        rows.append(torch.where(idx >= N, torch.where(first >= N, 0, first),
                                idx))
    return torch.stack(rows).to(torch.int32)


def three_nn_ref(unknown: torch.Tensor, known: torch.Tensor):
    """3 nearest known points per unknown point, direct distances.

    unknown (B, n, 3), known (B, m, 3) -> (dist2 (B, n, 3) ascending,
    idx (B, n, 3) int32)."""
    d2 = _sq_dist(unknown[:, :, None, :], known[:, None, :, :])
    dist, idx = torch.topk(d2, 3, dim=-1, largest=False, sorted=True)
    return dist, idx.to(torch.int32)
