"""Plain PyTorch point-cloud ops of the benchmark's reference.

The semantics of the reference CUDA ops of PQ-Transformer / VoteNet
(pointnet2/_ext_src/src/{sampling,ball_query,interpolate}_gpu.cu), written
as ordinary tensor ops that run on any device. Nothing here imports the
program: the benchmark holds the program's outputs against these.

  - FPS: index 0 first; points with |p|^2 <= 1e-3 (padding) are never
    picked; each step takes the point with the largest running min squared
    distance to the picked set, lowest index on ties. Distances are
    ((dx*dx + dy*dy) + dz*dz), each product its own op, so no FMA
    contraction moves a rounding.
  - ball query: per centre the first (by index) <= nsample points with
    d^2 < r^2, r^2 rounded once to float32; unfilled slots repeat the first
    hit, a centre with no hit takes index 0 everywhere.
  - three_nn: the 3 nearest known points. Departure from the CUDA op, which
    ranks by the direct distance: they are ranked by
    |u|^2 - 2 u.k + |k|^2 (the cross term one batched product), as the
    JAX package and the port rank them, and the 3 chosen distances are
    then taken directly. Ranking by another formula would flip near-ties
    between the two sides and show as a fault that is none.

Every matrix product of the reference goes through `matmul`, which emulates
an 8-bit float (e4m3, one scale a tensor) when asked: the control that the
comparison must fail.
"""
from __future__ import annotations

import numpy as np
import torch

FPS_SKIP_NORM_SQ = 1e-3
FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dx = a[..., 0] - b[..., 0]
    dy = a[..., 1] - b[..., 1]
    dz = a[..., 2] - b[..., 2]
    return dx * dx + dy * dy + dz * dz


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32 indices, decided in float32."""
    xyz = xyz.detach().float()
    B = xyz.shape[0]
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    valid = x * x + y * y + z * z > FPS_SKIP_NORM_SQ
    mind = torch.where(valid, 1e10, -1.0).to(torch.float32)
    out = torch.zeros(B, npoint, dtype=torch.int32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        mind = torch.minimum(mind, sq_dist(xyz, xyz[rows, last][:, None, :]))
        last = torch.argmax(mind, dim=-1)
        out[:, i] = last.to(torch.int32)
    return out


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """(B,N,3) points x (B,S,3) centres -> (B,S,nsample) int32, one batch
    row at a time so that the (S, N) distances stay small."""
    xyz, new_xyz = xyz.detach().float(), new_xyz.detach().float()
    N = xyz.shape[1]
    r2 = float(np.float32(radius * radius))
    cols = torch.arange(N, dtype=torch.int32, device=xyz.device)
    rows = []
    for b in range(xyz.shape[0]):
        d2 = sq_dist(new_xyz[b][:, None, :], xyz[b][None, :, :])
        key = torch.where(d2 < r2, cols, N)
        idx = torch.topk(key, nsample, dim=-1, largest=False,
                         sorted=True).values
        first = idx[:, :1]
        rows.append(torch.where(idx >= N, torch.where(first >= N, 0, first),
                                idx))
    return torch.stack(rows).to(torch.int32)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, S) -> (B, S, C)."""
    i = idx.long()[..., None].expand(-1, -1, points.shape[-1])
    return torch.gather(points, 1, i)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, S, K) -> (B, S, K, C)."""
    B, S, K = idx.shape
    return gather_points(points, idx.reshape(B, S * K)).reshape(
        B, S, K, points.shape[-1])


def interpolate(unknown: torch.Tensor, known: torch.Tensor,
                known_feats: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """3-NN inverse-distance interpolation of known_feats (B, m, C) onto the
    unknown points (B, n, 3): w_i = (1/(d_i+eps)) / sum_j (1/(d_j+eps))."""
    unknown, known = unknown.detach(), known.detach()
    cross = torch.bmm(unknown, known.transpose(1, 2)).float()
    d2 = ((unknown * unknown).sum(-1)[:, :, None] - 2.0 * cross
          + (known * known).sum(-1)[:, None, :]).clamp_min(0.0)
    picks = []
    for _ in range(3):
        i = torch.argmin(d2, dim=-1, keepdim=True)
        picks.append(i)
        d2 = d2.scatter(-1, i, float("inf"))
    idx = torch.cat(picks, dim=-1).to(torch.int32)
    diff = group_points(known, idx) - unknown[:, :, None, :]
    dist2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
             + diff[..., 2] * diff[..., 2])
    recip = 1.0 / (torch.sqrt(dist2) + eps)
    weight = recip / recip.sum(-1, keepdim=True)
    g = group_points(known_feats, idx) * weight[..., None]
    return g[:, :, 0] + g[:, :, 1] + g[:, :, 2]


def nn_distance(pc1: torch.Tensor, pc2: torch.Tensor, l1: bool = False):
    """Chamfer: pc1 (B,N,C), pc2 (B,M,C) -> dist1 (B,N), idx1 (B,N),
    dist2 (B,M), idx2 (B,M); squared L2, or L1 with `l1`; lowest index on
    ties."""
    diff = pc1[:, :, None, :] - pc2[:, None, :, :]
    dist = diff.abs().sum(-1) if l1 else (diff ** 2).sum(-1)
    return (dist.amin(dim=2), dist.argmin(dim=2), dist.amin(dim=1),
            dist.argmin(dim=1))


def smoothl1(error: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    diff = error.abs()
    return torch.where(diff < delta, 0.5 * diff ** 2 / delta,
                       diff - 0.5 * delta)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude onto 448), returned in x's type: an 8-bit product's operand."""
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


def matmul(a: torch.Tensor, b: torch.Tensor, low: bool) -> torch.Tensor:
    """a @ b; with `low` both operands rounded to float8 first."""
    if low:
        a, b = fp8(a), fp8(b)
    return torch.matmul(a, b)
