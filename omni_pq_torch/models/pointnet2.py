"""PointNet++ modules (channel-last; eval and train mode).

The port of `omni_pq_tpu/models/pointnet2.py` (SharedMLP, SAModuleVotes,
FPModule). Parameters carry the reference PQ_Transformer's state_dict names
and shapes (pytorch_utils.SharedMLP: `layer{i}.conv.weight` of shape
(out, in, 1, 1) and `layer{i}.bn.bn.*`), so a reference `.pth` loads as it
is. Every 1x1 convolution runs as a matmul on channel-last tensors
(`F.linear`), never through cuDNN, which would default to TF32.
`SAModuleVotes(fused=True)` runs its MLP + max-pool through
`ops.fused_mlp_pool` on the same parameters, where the widths pass the gate.

Mixed precision follows the JAX package (flax's `dtype` attributes): a
module built with a compute dtype holds it as `compute_dtype`, and
`with_compute_dtype` switches every such module of a model for a while (the
bfloat16 EMA teacher). A `Conv` with a compute dtype casts its input,
weight and bias to it (flax `nn.Dense(dtype=...)`), one without computes in
the promoted type of its input and its float32 weight (a Dense with no
dtype). `BatchNorm` takes its statistics and normalises in float32 and
returns its compute dtype, float32 when it has none (flax
`nn.BatchNorm(dtype=...)`, whose statistics are float32 either way).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..ops import matmul as mm

# flax's momentum convention (new = 0.9 * old + 0.1 * batch), the JAX
# package's BN_MOMENTUM; the reference's torch BN momentum 0.1 is the same
# update
BN_MOMENTUM = 0.9
BN_EPS = 1e-5

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a `ModelConfig.compute_dtype` name."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {name!r}: expected one of "
                         f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


@contextlib.contextmanager
def with_compute_dtype(model: nn.Module, dtype: torch.dtype):
    """Run `model` with every module that has a compute dtype switched to
    `dtype` (modules without one keep computing in float32), restored on
    exit: the JAX package's second module with another compute_dtype over
    the same parameters (TrainFlags.teacher_bf16)."""
    mods = [m for m in model.modules()
            if getattr(m, "compute_dtype", None) is not None]
    saved = [m.compute_dtype for m in mods]
    for m in mods:
        m.compute_dtype = dtype
    try:
        yield model
    finally:
        for m, dt in zip(mods, saved):
            m.compute_dtype = dt


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """flax nn.Dense in `dtype`: x @ weight.T with x, weight and bias cast to
    it. Below float32 the product is rounded to `dtype` before the bias is
    added (two roundings, as flax adds the bias after the dot); in float32
    one fused F.linear. A bfloat16 product sums in float32
    (`ops.matmul.linear`)."""
    w = weight.to(dtype)
    if dtype == torch.float32:
        return F.linear(x.to(dtype), w, None if bias is None
                        else bias.to(dtype))
    y = mm.linear(x.to(dtype), w)
    return y if bias is None else y + bias.to(dtype)


class Conv(nn.Module):
    """A 1x1 convolution (or a Linear, `kernel_dims=0`) applied to the last
    axis of a channel-last tensor. The weight keeps the reference's shape
    (out, in, 1, ...); parameters are left uninitialised for `init_weights`
    or `load_state_dict`."""

    def __init__(self, cin: int, cout: int, kernel_dims: int = 1,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((cout, cin) + (1,) * kernel_dims))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        return linear(x, self.weight.flatten(1), self.bias, dt)


def update_running_stats(bn: nn.BatchNorm1d, mean: torch.Tensor,
                         var: torch.Tensor) -> None:
    """flax's running-stat update: new = 0.9 * old + 0.1 * batch, with the
    biased batch variance (not nn.BatchNorm1d's unbiased one)."""
    with torch.no_grad():
        bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean
                              + (1 - BN_MOMENTUM) * mean)
        bn.running_var.copy_(BN_MOMENTUM * bn.running_var
                             + (1 - BN_MOMENTUM) * var)


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis of a channel-last tensor with the JAX
    package's (flax's) semantics: (x - mean) * (rsqrt(var + eps) * scale) +
    bias. Eval mode uses the running stats. Train mode uses the batch mean
    and the fast variance max(0, E[x^2] - E[x]^2) over every axis but the
    last (gradients flow through both), and updates the running stats with
    `update_running_stats`. Keeps nn.BatchNorm1d's parameters and buffers,
    so its state_dict keys are the reference's."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__(channels, eps=BN_EPS)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dim=dims)
            var = torch.clamp_min((x * x).mean(dim=dims) - mean * mean, 0.0)
            update_running_stats(self, mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean) * mul + self.bias).to(
            self.compute_dtype or x.dtype)


class _BN(nn.Module):
    """pytorch_utils' BatchNorm wrapper: gives the `bn.bn.*` key path."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.bn = BatchNorm(channels, dtype)

    def forward(self, x):
        return self.bn(x)


class _MLPLayer(nn.Module):
    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__()
        self.conv = Conv(cin, cout, kernel_dims=2, bias=False, dtype=dtype)
        self.bn = _BN(cout, dtype)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class SharedMLP(nn.Sequential):
    """1x1 conv (no bias) + BatchNorm + ReLU stack over the last axis.
    `channels` includes the input width: [cin, c1, c2, ...]. In `dtype`
    (flax SharedMLP(dtype=...)): each product in it, each BatchNorm's
    statistics and normalisation in float32 and its output in it."""

    def __init__(self, channels: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i, (cin, cout) in enumerate(zip(channels[:-1], channels[1:])):
            self.add_module(f"layer{i}", _MLPLayer(cin, cout, dtype))


class SAModuleVotes(nn.Module):
    """Set abstraction: FPS -> ball query + group -> SharedMLP -> max-pool
    (PointnetSAModuleVotes with pooling='max', use_xyz=True).
    `mlp_channels` excludes the implicit +3 xyz input channels.

    fused=True routes the MLP + max-pool through `ops.fused_mlp_pool` when
    nsample and the widths pass `ops.fused_mlp_supports` at the compute
    dtype (the JAX package's FusedMLPPool): the same parameters and
    buffers, and in train mode the same running-stat update from the
    kernel's batch statistics. `fused` reads the gate at the current
    compute dtype (bfloat16 asks K % 16 == 0)."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_channels: int, mlp_channels: Sequence[int],
                 normalize_xyz: bool = False, fused: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.normalize_xyz = normalize_xyz
        self.mlp_channels = list(mlp_channels)
        self.mlp_module = SharedMLP([in_channels + 3, *mlp_channels], dtype)
        self.fuse = fused
        self.compute_dtype = dtype

    @property
    def fused(self) -> bool:
        return self.fuse and ops.fused_mlp_supports(
            self.nsample, self.mlp_channels, self.compute_dtype)

    def _fused_mlp_pool(self, grouped: torch.Tensor) -> torch.Tensor:
        layers = list(self.mlp_module)
        bns = [layer.bn.bn for layer in layers]
        pooled, means, variances = ops.fused_mlp_pool(
            grouped, [layer.conv.weight.flatten(1).t().contiguous()
                      for layer in layers],
            [bn.weight for bn in bns], [bn.bias for bn in bns],
            [bn.running_mean for bn in bns], [bn.running_var for bn in bns],
            train=self.training, eps=BN_EPS, dtype=self.compute_dtype)
        for bn, mean, var in zip(bns, means, variances):
            update_running_stats(bn, mean, var)
        return pooled

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
        if self.fused:
            return new_xyz, self._fused_mlp_pool(grouped), inds
        return new_xyz, self.mlp_module(grouped).amax(dim=2), inds


class FPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance upsampling + SharedMLP;
    channel order [interpolated known, skip] like the reference. The
    interpolation weights are float32, so the MLP's input is float32 under
    either compute dtype, as in the JAX package."""

    def __init__(self, channels: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = SharedMLP(channels, dtype)

    def forward(self, unknown_xyz, known_xyz, unknown_feats, known_feats):
        interp = ops.interpolate_features(unknown_xyz, known_xyz, known_feats)
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(interp)
