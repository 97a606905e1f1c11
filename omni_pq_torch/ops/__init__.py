"""Point-cloud ops of the port: hand-written CUDA kernels (fps, ball query)
with their plain PyTorch versions, and the plain gather/interpolation ops.

The models call `ops.fps` and `ops.ball_query_group` through this package,
so `plain_versions()` can route a whole forward through the plain versions.
"""
import contextlib

from .fps import fps, fps_plain
from .ball_query import ball_query, ball_query_group, ball_query_group_plain
from .interpolate import (three_nn, gather_points, group_points,
                          three_interpolate, interpolate_features)
from .reference import fps_ref, ball_query_ref, three_nn_ref

__all__ = [
    "plain_versions", "fps", "fps_plain", "ball_query", "ball_query_group",
    "ball_query_group_plain", "three_nn", "gather_points", "group_points",
    "three_interpolate", "interpolate_features", "fps_ref", "ball_query_ref",
    "three_nn_ref",
]


@contextlib.contextmanager
def plain_versions():
    """Within the block, the models' fps / ball_query_group calls take the
    plain PyTorch versions on every device: the reference a kernel-path
    forward on the card is held against."""
    global fps, ball_query_group
    saved = fps, ball_query_group
    fps, ball_query_group = fps_plain, ball_query_group_plain
    try:
        yield
    finally:
        fps, ball_query_group = saved
