"""PointNet++ modules (channel-last, eval mode).

The port of `omni_pq_tpu/models/pointnet2.py` (SharedMLP, SAModuleVotes,
FPModule). Parameters carry the reference PQ_Transformer's state_dict names
and shapes (pytorch_utils.SharedMLP: `layer{i}.conv.weight` of shape
(out, in, 1, 1) and `layer{i}.bn.bn.*`), so a reference `.pth` loads as it
is. Every 1x1 convolution runs as a matmul on channel-last tensors
(`F.linear`), never through cuDNN, which would default to TF32.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops

BN_EPS = 1e-5


class Conv(nn.Module):
    """A 1x1 convolution (or a Linear, `kernel_dims=0`) applied to the last
    axis of a channel-last tensor. The weight keeps the reference's shape
    (out, in, 1, ...); parameters are left uninitialised for `init_weights`
    or `load_state_dict`."""

    def __init__(self, cin: int, cout: int, kernel_dims: int = 1,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((cout, cin) + (1,) * kernel_dims))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.flatten(1), self.bias)


class BatchNorm(nn.BatchNorm1d):
    """Eval-mode BatchNorm over the last axis of a channel-last tensor, in
    the JAX package's (flax's) order: (x - mean) * (rsqrt(var + eps) *
    scale) + bias. Keeps nn.BatchNorm1d's parameters and buffers, so its
    state_dict keys are the reference's."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "omni_pq_torch runs the eval forward: train-mode BatchNorm "
                "comes with the training slice")
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias


class _BN(nn.Module):
    """pytorch_utils' BatchNorm wrapper: gives the `bn.bn.*` key path."""

    def __init__(self, channels: int):
        super().__init__()
        self.bn = BatchNorm(channels)

    def forward(self, x):
        return self.bn(x)


class _MLPLayer(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv(cin, cout, kernel_dims=2, bias=False)
        self.bn = _BN(cout)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class SharedMLP(nn.Sequential):
    """1x1 conv (no bias) + BatchNorm + ReLU stack over the last axis.
    `channels` includes the input width: [cin, c1, c2, ...]."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        for i, (cin, cout) in enumerate(zip(channels[:-1], channels[1:])):
            self.add_module(f"layer{i}", _MLPLayer(cin, cout))


class SAModuleVotes(nn.Module):
    """Set abstraction: FPS -> ball query + group -> SharedMLP -> max-pool
    (PointnetSAModuleVotes with pooling='max', use_xyz=True).
    `mlp_channels` excludes the implicit +3 xyz input channels."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_channels: int, mlp_channels: Sequence[int],
                 normalize_xyz: bool = False):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.normalize_xyz = normalize_xyz
        self.mlp_module = SharedMLP([in_channels + 3, *mlp_channels])

    def forward(self, xyz: torch.Tensor,
                features: Optional[torch.Tensor] = None):
        """xyz (B,N,3), features (B,N,C) -> new_xyz (B,npoint,3),
        new_features (B,npoint,C_out), inds (B,npoint) int32."""
        inds = ops.fps(xyz, self.npoint)
        new_xyz = ops.gather_points(xyz, inds)
        idx, grouped_xyz = ops.ball_query_group(self.radius, self.nsample,
                                                xyz, new_xyz)
        if self.normalize_xyz:
            grouped_xyz = grouped_xyz / self.radius
        if features is not None:
            grouped = torch.cat([grouped_xyz,
                                 ops.group_points(features, idx)], dim=-1)
        else:
            grouped = grouped_xyz
        return new_xyz, self.mlp_module(grouped).amax(dim=2), inds


class FPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance upsampling + SharedMLP;
    channel order [interpolated known, skip] like the reference."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        self.mlp = SharedMLP(channels)

    def forward(self, unknown_xyz, known_xyz, unknown_feats, known_feats):
        interp = ops.interpolate_features(unknown_xyz, known_xyz, known_feats)
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(interp)
