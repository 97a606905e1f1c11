"""The least time of one call of the program's point kernels (FPS and the
ball query), from its shape: `chip_smoke.py`'s counts (FPS_OPS_PER_POINT
and the bounds of its kernel table) at commit
4c1c1dacbb14fd55b2b315e6b58815882cf32f9c. A model's counts
(`counts/<model>.py`) add these up over the calls of its forward.

FPS needs, in each of its npoint - 1 steps, every point's distance to the
last pick and its running minimum: 10 operations a point (3 sub, 3 mul,
2 add, 1 min, 1 compare); it reads the points once and writes the indices.
The ball query is counted by its bytes alone (the points and centres read
once; each slot's int32 index and float32 relative xyz written once):
chip_smoke's `bq_work` counts the points a 32-point-chunk scan tests, which
is one design's work and not what the inputs need; at sa1 its operations
bound (0.0126 ms) equalled the bytes bound (PERF.md kernel table)."""
from __future__ import annotations

from ..peaks import F32_OPS_PER_S, bound_s

FPS_OPS_PER_POINT = 10


def fps_call_bound_s(B: int, N: int, S: int) -> float:
    """FPS of S centres from N points in each of B clouds."""
    return bound_s(B * N * 12 + B * S * 4,
                   B * (S - 1) * N * FPS_OPS_PER_POINT, F32_OPS_PER_S)


def ball_query_call_bound_s(B: int, N: int, S: int, K: int) -> float:
    """The ball query of K samples around each of S centres among N points
    in each of B clouds."""
    return bound_s(B * N * 12 + B * S * 12 + B * S * K * (4 + 12), 0.0,
                   F32_OPS_PER_S)
