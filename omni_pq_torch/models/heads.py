"""Prediction heads for object boxes and layout quads (the port of
`omni_pq_tpu/models/heads.py`). Each head is two Conv+BN+ReLU layers followed
by parallel 1x1-conv heads; predicted centres are offsets from `base_xyz`.
Under a bfloat16 compute dtype the trunk's convolutions run in bfloat16 and
its BatchNorms in float32; the output heads have no compute dtype and run in
float32, as in the JAX package."""
from __future__ import annotations

import math

import torch
from torch import nn

from ..config import SCANNET_MEAN_SIZES
from .pointnet2 import BatchNorm, Conv


class _Trunk(nn.Module):
    def __init__(self, hidden_dim: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv(hidden_dim, hidden_dim, dtype=dtype)
        self.bn1 = BatchNorm(hidden_dim)
        self.conv2 = Conv(hidden_dim, hidden_dim, dtype=dtype)
        self.bn2 = BatchNorm(hidden_dim)

    def trunk(self, net):
        net = torch.relu(self.bn1(self.conv1(net)))
        return torch.relu(self.bn2(self.conv2(net)))


class PredictHead(_Trunk):
    """Object box head: objectness (2), centre offset, heading (1 bin), size
    (clusters + residuals), semantic class."""

    def __init__(self, hidden_dim: int, num_heading_bin: int,
                 num_size_cluster: int, num_class: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_dim, dtype)
        self.num_heading_bin = num_heading_bin
        self.num_size_cluster = num_size_cluster
        self.objectness_scores_head = Conv(hidden_dim, 2)
        self.center_head = Conv(hidden_dim, 3)
        self.heading_class_head = Conv(hidden_dim, num_heading_bin)
        self.heading_residual_head = Conv(hidden_dim, num_heading_bin)
        self.size_class_head = Conv(hidden_dim, num_size_cluster)
        self.size_residual_head = Conv(hidden_dim, num_size_cluster * 3)
        self.sem_cls_scores_head = Conv(hidden_dim, num_class)
        self.register_buffer(
            "mean_size", torch.from_numpy(SCANNET_MEAN_SIZES), persistent=False)

    def forward(self, net, base_xyz, prefix: str):
        """net (B,K,D), base_xyz (B,K,3) -> (center, pred_size, end_points
        update for `prefix`)."""
        net = self.trunk(net)
        B, K = net.shape[:2]
        center = self.center_head(net) + base_xyz
        heading_res_norm = self.heading_residual_head(net)
        size_scores = self.size_class_head(net)
        size_res_norm = self.size_residual_head(net).reshape(
            B, K, self.num_size_cluster, 3)
        size_residuals = size_res_norm * self.mean_size
        size_recover = size_residuals + self.mean_size
        pred_size_class = torch.argmax(size_scores, dim=-1)  # (B, K)
        pred_size = torch.gather(
            size_recover, 2,
            pred_size_class[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
        ep = {
            f"{prefix}objectness_scores": self.objectness_scores_head(net),
            f"{prefix}center": center,
            f"{prefix}heading_scores": self.heading_class_head(net),
            f"{prefix}heading_residuals_normalized": heading_res_norm,
            f"{prefix}heading_residuals":
                heading_res_norm * (math.pi / self.num_heading_bin),
            f"{prefix}size_scores": size_scores,
            f"{prefix}size_residuals_normalized": size_res_norm,
            f"{prefix}size_residuals": size_residuals,
            f"{prefix}pred_size": pred_size,
            f"{prefix}sem_cls_scores": self.sem_cls_scores_head(net),
        }
        return center, pred_size, ep


class QuadPredictHead(_Trunk):
    """Layout quad head: quadness (2), centre offset, unit normal, 2D size.
    per_vector_norm=True normalises each predicted normal; False divides by
    the global tensor norm like the reference (pq_transformer.py:112-113)."""

    def __init__(self, hidden_dim: int, per_vector_norm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_dim, dtype)
        self.per_vector_norm = per_vector_norm
        self.quad_scores_head = Conv(hidden_dim, 2)
        self.center_head = Conv(hidden_dim, 3)
        self.normal_vector_head = Conv(hidden_dim, 3)
        self.size_head = Conv(hidden_dim, 2)

    def forward(self, net, base_xyz, prefix: str):
        net = self.trunk(net)
        center = self.center_head(net) + base_xyz
        normal = self.normal_vector_head(net)
        if self.per_vector_norm:
            normal = normal / (torch.linalg.vector_norm(
                normal, dim=-1, keepdim=True) + 1e-8)
        else:
            normal = normal / (torch.linalg.vector_norm(normal) + 1e-8)
        size = self.size_head(net)
        ep = {
            f"{prefix}quad_scores": self.quad_scores_head(net),
            f"{prefix}quad_center": center,
            f"{prefix}normal_vector": normal,
            f"{prefix}quad_size": size,
        }
        return center, size, ep
