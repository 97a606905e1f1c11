"""Morton (z-order) spatial sorting of point clouds.

The port's own copy of `omni_pq_tpu/data/spatial.py`.

TPU-native design choice: the reference's random downsample (pc_util
random_sampling via np.random.choice) emits points in random order — the
order is an arbitrary implementation detail (it only decides which of the
>nsample in-radius neighbors ball query keeps). Emitting clouds in Morton
order makes consecutive index chunks spatially coherent, which is what lets
the ball-query kernel's chunk-bbox skip cut its work to the true neighborhood
(ops/ball_query.py). Host-side numpy, ~1ms per 40k-point scene.
"""
from __future__ import annotations

import numpy as np


def _spread_bits(v: np.ndarray) -> np.ndarray:
    """Insert two zero bits between each of the low 10 bits (for 3D Morton)."""
    v = v.astype(np.uint64) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_code(points: np.ndarray) -> np.ndarray:
    """(N,3) float points -> (N,) uint64 Morton codes (10 bits per axis)."""
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    scale = np.where(hi > lo, 1023.0 / (hi - lo), 0.0)
    q = np.clip(((points - lo) * scale), 0, 1023).astype(np.uint64)
    return (_spread_bits(q[:, 0]) | (_spread_bits(q[:, 1]) << 1)
            | (_spread_bits(q[:, 2]) << 2))


def spatial_sort(points: np.ndarray) -> np.ndarray:
    """(N,3+) points -> permutation putting them in Morton order."""
    return np.argsort(morton_code(points[:, :3]), kind="stable")
