"""The least time of the point kernels (FPS and the ball query) in one
forward, from the shapes: `chip_smoke.py`'s counts (FPS_OPS_PER_POINT and
the bounds of its kernel table) at commit
4c1c1dacbb14fd55b2b315e6b58815882cf32f9c.

FPS needs, in each of its npoint - 1 steps, every point's distance to the
last pick and its running minimum: 10 operations a point (3 sub, 3 mul,
2 add, 1 min, 1 compare); it reads the points once and writes the indices.
The ball query is counted by its bytes alone (the points and centres read
once; each slot's int32 index and float32 relative xyz written once):
chip_smoke's `bq_work` counts the points a 32-point-chunk scan tests, which
is one design's work and not what the inputs need; at sa1 its operations
bound (0.0126 ms) equalled the bytes bound (PERF.md kernel table)."""
from __future__ import annotations

from typing import Dict

from ..peaks import F32_OPS_PER_S, bound_s
from .layers import fps_calls, sa_layers

FPS_OPS_PER_POINT = 10


def fps_bound_s(cfg: Dict, B: int) -> float:
    return sum(bound_s(B * N * 12 + B * S * 4,
                       B * (S - 1) * N * FPS_OPS_PER_POINT, F32_OPS_PER_S)
               for _, N, S in fps_calls(cfg))


def ball_query_bound_s(cfg: Dict, B: int) -> float:
    return sum(bound_s(B * N * 12 + B * S * 12 + B * S * K * (4 + 12), 0.0,
                       F32_OPS_PER_S)
               for _, N, S, K, _, _ in sa_layers(cfg))


def forward_bound_s(cfg: Dict, B: int) -> float:
    return fps_bound_s(cfg, B) + ball_query_bound_s(cfg, B)
