"""PointNet++ backbone (the port of `omni_pq_tpu/models/backbone.py`).

Channel plan with width=2, depth=2 (the reference default):
  sa1: 40000 -> 2048, r 0.2, ns 64, mlp [128,128,256]
  sa2:  2048 -> 1024, r 0.4, ns 32, mlp [256,256,512]
  sa3:  1024 ->  512, r 0.8, ns 16, mlp [256,256,512]
  sa4:   512 ->  256, r 1.2, ns 16, mlp [256,256,512]
  fp1: sa4 -> sa3, mlp [512,512]; fp2: sa3 -> sa2, mlp [512,288]
Seeds: 1024 x 288-d at the sa2 coordinates. seed_inds keeps the reference's
approximation sa1_inds[:, :1024] (backbone_module.py:135-137).
`fused=True` routes the SA layers whose widths pass the gate through the
fused SA-MLP kernel (`ModelConfig.fused_sa`).
"""
from __future__ import annotations

import torch
from torch import nn

from .pointnet2 import SAModuleVotes, FPModule


class Pointnet2Backbone(nn.Module):
    def __init__(self, input_feature_dim: int = 0, width: int = 2,
                 depth: int = 2, out_dim: int = 288,
                 npoints=(2048, 1024, 512, 256), nsamples=(64, 32, 16, 16),
                 radii=(0.2, 0.4, 0.8, 1.2), fused: bool = False):
        super().__init__()
        w, d = width, depth
        outs = [128 * w, 256 * w, 256 * w, 256 * w]
        mlps = [[64 * w] * d, [128 * w] * d, [128 * w] * d, [128 * w] * d]
        cin = input_feature_dim
        for i in range(4):
            self.add_module(f"sa{i + 1}", SAModuleVotes(
                npoints[i], radii[i], nsamples[i], cin, mlps[i] + [outs[i]],
                normalize_xyz=True, fused=fused))
            cin = outs[i]
        self.fp1 = FPModule([outs[3] + outs[2], 256 * w, 256 * w])
        self.fp2 = FPModule([256 * w + outs[1], 256 * w, out_dim])

    def forward(self, pointcloud: torch.Tensor) -> dict:
        """pointcloud (B, N, 3+input_feature_dim) -> dict of end points."""
        xyz = pointcloud[..., 0:3].contiguous()
        features = pointcloud[..., 3:] if pointcloud.shape[-1] > 3 else None

        ep = {}
        xyz1, f1, inds1 = self.sa1(xyz, features)
        ep["sa1_inds"], ep["sa1_xyz"], ep["sa1_features"] = inds1, xyz1, f1
        xyz2, f2, inds2 = self.sa2(xyz1, f1)
        ep["sa2_inds"], ep["sa2_xyz"], ep["sa2_features"] = inds2, xyz2, f2
        xyz3, f3, _ = self.sa3(xyz2, f2)
        ep["sa3_xyz"], ep["sa3_features"] = xyz3, f3
        xyz4, f4, _ = self.sa4(xyz3, f3)
        ep["sa4_xyz"], ep["sa4_features"] = xyz4, f4

        up3 = self.fp1(xyz3, xyz4, f3, f4)
        up2 = self.fp2(xyz2, xyz3, f2, up3)
        ep["fp2_features"] = up2
        ep["fp2_xyz"] = xyz2
        ep["fp2_inds"] = inds1[:, :xyz2.shape[1]]
        ep["seed_inds"] = ep["fp2_inds"]
        ep["seed_xyz"] = xyz2
        ep["seed_features"] = up2
        return ep
