"""Chamfer (nearest-neighbour) distance between point sets, and the smooth-L1
/ huber penalties of the losses, in plain PyTorch (the port of
`omni_pq_tpu/ops/nn_distance.py`; the JAX package leaves them to XLA).

O(N*M) pairwise distances, min over each axis, with squared-L2 (default),
L1 or huber variants (utils/nn_distance.py:34-61 of the reference).
"""
from __future__ import annotations

import torch


def huber_loss(error: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """0.5*x^2 for |x| <= delta, else 0.5*delta^2 + delta*(|x| - delta)."""
    abs_error = error.abs()
    quadratic = torch.clamp_max(abs_error, delta)
    linear = abs_error - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def smoothl1_loss(error: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Smooth-L1 as in the reference's models/utils/losses.py:5-18."""
    diff = error.abs()
    return torch.where(diff < delta, 0.5 * diff ** 2 / delta,
                       diff - 0.5 * delta)


def nn_distance(pc1: torch.Tensor, pc2: torch.Tensor, l1smooth: bool = False,
                delta: float = 1.0, l1: bool = False):
    """pc1 (B,N,C), pc2 (B,M,C) -> dist1 (B,N), idx1 (B,N) int32,
    dist2 (B,M), idx2 (B,M) int32; ties go to the lowest index."""
    diff = pc1[:, :, None, :] - pc2[:, None, :, :]
    if l1smooth:
        dist = huber_loss(diff, delta).sum(-1)
    elif l1:
        dist = diff.abs().sum(-1)
    else:
        dist = (diff ** 2).sum(-1)
    # amin spreads a tie's gradient over the tied entries, as jnp.min does
    return (dist.amin(dim=2), dist.argmin(dim=2).to(torch.int32),
            dist.amin(dim=1), dist.argmin(dim=1).to(torch.int32))
