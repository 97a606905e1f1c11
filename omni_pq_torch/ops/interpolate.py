"""three_nn / three_interpolate and the gather/group ops, in plain PyTorch.

The JAX package leaves these to XLA (`omni_pq_tpu/ops/interpolate.py`); none
of them is a Pallas kernel, so the port writes them as tensor ops. Layout is
channel-last, as in the JAX package.
"""
from __future__ import annotations

import torch


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """3 nearest known points per unknown point: (B,n,3) x (B,m,3) ->
    (dist2 (B,n,3), idx (B,n,3) int32).

    Neighbours are chosen by the JAX package's distance form,
    |u|^2 - 2 u.k + |k|^2 clamped at 0, in 3 argmin passes (first minimum on
    ties); the 3 chosen distances are then recomputed directly, so a point
    that coincides with a known point gets exactly 0 (interpolate.py:34-62)."""
    cross = torch.bmm(unknown, known.transpose(1, 2))
    d2 = ((unknown * unknown).sum(-1)[:, :, None] - 2.0 * cross
          + (known * known).sum(-1)[:, None, :]).clamp_min(0.0)
    idxs = []
    for _ in range(3):
        i = torch.argmin(d2, dim=-1, keepdim=True)
        idxs.append(i)
        d2 = d2.scatter(-1, i, float("inf"))
    idx = torch.cat(idxs, dim=-1).to(torch.int32)  # (B, n, 3)
    diff = group_points(known, idx) - unknown[:, :, None, :]
    dist2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
             + diff[..., 2] * diff[..., 2])
    return dist2, idx


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, S) -> (B, S, C); every index in [0, N)."""
    i = idx.long()[..., None].expand(-1, -1, points.shape[-1])
    return torch.gather(points, 1, i)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, S, K) -> (B, S, K, C)."""
    B, S, K = idx.shape
    flat = gather_points(points, idx.reshape(B, S * K))
    return flat.reshape(B, S, K, points.shape[-1])


def three_interpolate(feats: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """feats (B, m, C), idx (B, n, 3), weight (B, n, 3) -> (B, n, C)."""
    g = group_points(feats, idx) * weight[..., None]  # (B, n, 3, C)
    return g[:, :, 0] + g[:, :, 1] + g[:, :, 2]


def interpolate_features(unknown_xyz: torch.Tensor, known_xyz: torch.Tensor,
                         known_feats: torch.Tensor,
                         eps: float = 1e-8) -> torch.Tensor:
    """FP-module interpolation: 3-NN inverse-distance weighting with the
    Euclidean distance d, w_i = (1/(d_i+eps)) / sum_j (1/(d_j+eps))."""
    dist2, idx = three_nn(unknown_xyz, known_xyz)
    recip = 1.0 / (torch.sqrt(dist2) + eps)
    weight = recip / recip.sum(-1, keepdim=True)
    return three_interpolate(known_feats, idx, weight)
