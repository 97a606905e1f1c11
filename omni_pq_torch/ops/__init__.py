"""Point-cloud ops of the port: hand-written CUDA kernels (fps, ball query
with its grouping and feature-grouping forms, the fused SA-MLP, the
radius-masked attention of 3DETR's encoder) with their plain PyTorch
versions, the plain gather/interpolation ops and the Chamfer distance of
the losses.

The models call `ops.fps`, `ops.ball_query`, `ops.ball_query_group`,
`ops.fused_mlp_pool` and `ops.radius_attention` through this package, so
`plain_versions()` can route a whole forward (and its backward) through the
plain versions.
"""
import contextlib

from .fps import fps, fps_plain
from .ball_query import (ball_query, ball_query_group, ball_query_group_plain,
                         ball_query_group_feats, ball_query_group_feats_plain)
from .fused_mlp import (fused_mlp_pool, fused_mlp_pool_plain,
                        supports as fused_mlp_supports)
from .radius_attention import radius_attention, radius_attention_plain
from .nn_distance import nn_distance, huber_loss, smoothl1_loss
from .interpolate import (three_nn, gather_points, group_points,
                          three_interpolate, interpolate_features)
from .reference import fps_ref, ball_query_ref, three_nn_ref

__all__ = [
    "plain_versions", "fps", "fps_plain", "ball_query", "ball_query_group",
    "ball_query_group_plain", "ball_query_group_feats",
    "ball_query_group_feats_plain", "fused_mlp_pool", "fused_mlp_pool_plain",
    "fused_mlp_supports", "radius_attention", "radius_attention_plain",
    "nn_distance", "huber_loss", "smoothl1_loss",
    "three_nn", "gather_points", "group_points",
    "three_interpolate", "interpolate_features", "fps_ref", "ball_query_ref",
    "three_nn_ref",
]


@contextlib.contextmanager
def plain_versions():
    """Within the block, the models' fps / ball_query / ball_query_group /
    fused_mlp_pool / radius_attention calls take the plain PyTorch versions
    on every device: the reference a kernel-path forward on the card is
    held against."""
    global fps, ball_query, ball_query_group, fused_mlp_pool
    global radius_attention
    saved = fps, ball_query, ball_query_group, fused_mlp_pool, radius_attention
    fps, ball_query, ball_query_group, fused_mlp_pool, radius_attention = (
        fps_plain, ball_query_ref, ball_query_group_plain,
        fused_mlp_pool_plain, radius_attention_plain)
    try:
        yield
    finally:
        (fps, ball_query, ball_query_group, fused_mlp_pool,
         radius_attention) = saved
