"""Point-cloud ops of the port: hand-written CUDA kernels (fps, ball query
with its grouping and feature-grouping forms, the fused SA-MLP) with their
plain PyTorch versions, the plain gather/interpolation ops and the Chamfer
distance of the losses.

The models call `ops.fps`, `ops.ball_query_group` and `ops.fused_mlp_pool`
through this package, so `plain_versions()` can route a whole forward (and
its backward) through the plain versions.
"""
import contextlib

from .fps import fps, fps_plain
from .ball_query import (ball_query, ball_query_group, ball_query_group_plain,
                         ball_query_group_feats, ball_query_group_feats_plain)
from .fused_mlp import (fused_mlp_pool, fused_mlp_pool_plain,
                        supports as fused_mlp_supports)
from .nn_distance import nn_distance
from .interpolate import (three_nn, gather_points, group_points,
                          three_interpolate, interpolate_features)
from .reference import fps_ref, ball_query_ref, three_nn_ref

__all__ = [
    "plain_versions", "fps", "fps_plain", "ball_query", "ball_query_group",
    "ball_query_group_plain", "ball_query_group_feats",
    "ball_query_group_feats_plain", "fused_mlp_pool", "fused_mlp_pool_plain",
    "fused_mlp_supports", "nn_distance", "three_nn", "gather_points", "group_points",
    "three_interpolate", "interpolate_features", "fps_ref", "ball_query_ref",
    "three_nn_ref",
]


@contextlib.contextmanager
def plain_versions():
    """Within the block, the models' fps / ball_query_group / fused_mlp_pool
    calls take the plain PyTorch versions on every device: the reference a
    kernel-path forward on the card is held against."""
    global fps, ball_query_group, fused_mlp_pool
    saved = fps, ball_query_group, fused_mlp_pool
    fps, ball_query_group, fused_mlp_pool = (
        fps_plain, ball_query_group_plain, fused_mlp_pool_plain)
    try:
        yield
    finally:
        fps, ball_query_group, fused_mlp_pool = saved
