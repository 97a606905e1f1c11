"""PointNet++ modules (channel-last; eval and train mode).

The port of `omni_pq_tpu/models/pointnet2.py` (SharedMLP, SAModuleVotes,
SAModuleMSG, GroupAllModule, LFPModuleMSG, FPModule). Parameters carry the
reference's state_dict names and shapes (pytorch_utils.SharedMLP:
`layer{i}.conv.weight` of shape (out, in, 1, 1) and `layer{i}.bn.bn.*`;
pointnet2_modules.py's `mlp_module`, `mlps.{i}` and `post_mlp`), so a
reference `.pth` loads as it is. Every 1x1 convolution runs as a matmul on
channel-last tensors (`F.linear`), never through cuDNN, which would default
to TF32. `SAModuleVotes(fused=True)` runs its MLP + max-pool through
`ops.fused_mlp_pool` on the same parameters, where the widths pass the gate;
`SAModuleVotes(remat=True)` recomputes its unfused MLP + max-pool in the
backward (`ModelConfig.remat_sa`).

Precision follows the JAX package (flax's `dtype` attributes): a module
built with a compute dtype holds it as `compute_dtype`, and
`with_compute_dtype` switches every such module of a model for a while (the
bfloat16 EMA teacher). A `Conv` with a compute dtype casts its input,
weight and bias to it (flax `nn.Dense(dtype=...)`), one without computes in
the promoted type of its input and its weight (a Dense with no dtype).
`BatchNorm` takes its statistics and normalises in `acc_dtype` of its input
(float32 under float32 and bfloat16, float64 under float64) and returns its
compute dtype, that type when it has none (flax `nn.BatchNorm(dtype=...)`).
Under float64 the parameters may be float64 (`model.double()`, the design
point) or float32 (cast up exactly where they are used, as flax does); in
eval mode a BatchNorm with float32 statistics and scale takes
rsqrt(var + eps) * scale in float32, as flax's `_normalize` does.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import ops, parallel
from ..ops import matmul as mm

# flax's momentum convention (new = 0.9 * old + 0.1 * batch), the JAX
# package's BN_MOMENTUM; the reference's torch BN momentum 0.1 is the same
# update
BN_MOMENTUM = 0.9
BN_EPS = 1e-5

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "float64": torch.float64}


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype of BatchNorm, softmax and the residual paths
    (the JAX package's `acc_dtype`): float32 under float32 and bfloat16,
    float64 under float64."""
    return torch.promote_types(dtype, torch.float32)


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
    and float64 one fused F.linear: there flax's separate bias add moves a
    result by at most one rounding of its type, below what either route is
    held to, and the card runs one GEMM with the bias in its epilogue. A
    bfloat16 product sums in float32 (`ops.matmul.linear`)."""
    w = weight.to(dtype)
    if dtype.itemsize >= 4:
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


# set while a rematerialised MLP + pool is recomputed in the backward
_RECOMPUTING = False


@contextlib.contextmanager
def _recompute(dp):
    """The backward's recompute of a rematerialised MLP + pool: it runs in
    the forward's data-parallel context `dp` (the same global statistics,
    the same collectives on every rank) and moves no running statistic, so
    they move once a step, as under flax's remat."""
    global _RECOMPUTING
    saved, _RECOMPUTING = _RECOMPUTING, True
    try:
        with parallel.using(dp):
            yield
    finally:
        _RECOMPUTING = saved


def update_running_stats(bn: nn.BatchNorm1d, mean: torch.Tensor,
                         var: torch.Tensor) -> None:
    """flax's running-stat update: new = 0.9 * old + 0.1 * batch, with the
    biased batch variance (not nn.BatchNorm1d's unbiased one). The new
    statistic takes the promoted type, as a flax variable does: float64
    batch statistics turn float32 running stats into float64 ones. A no-op
    in the backward's recompute of a rematerialised forward."""
    if _RECOMPUTING:
        return
    with torch.no_grad():
        for name, batch in (("running_mean", mean), ("running_var", var)):
            old = getattr(bn, name)
            new = BN_MOMENTUM * old + (1 - BN_MOMENTUM) * batch
            if new.dtype == old.dtype:
                old.copy_(new)
            else:
                setattr(bn, name, new)


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis of a channel-last tensor with the JAX
    package's (flax's) semantics: (x - mean) * (rsqrt(var + eps) * scale) +
    bias. Eval mode uses the running stats. Train mode uses the batch mean
    and the fast variance max(0, E[x^2] - E[x]^2) over every axis but the
    last (gradients flow through both), and updates the running stats with
    `update_running_stats`; inside `parallel.data_parallel` those are the
    global batch's statistics (`parallel.moments`: one all-reduce, its
    gradient over the ranks too), so every rank's running stats stay
    equal, as flax's BatchNorm under a mesh. Keeps nn.BatchNorm1d's
    parameters and buffers, so its state_dict keys are the reference's."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__(channels, eps=BN_EPS)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(acc_dtype(x.dtype))
        dp = parallel.current() if self.training else None
        if dp is not None:
            mean, var = parallel.moments(x, dp)
            update_running_stats(self, mean.detach(), var.detach())
        elif self.training:
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
    statistics and normalisation in `acc_dtype(dtype)` and its output in
    it."""

    def __init__(self, channels: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i, (cin, cout) in enumerate(zip(channels[:-1], channels[1:])):
            self.add_module(f"layer{i}", _MLPLayer(cin, cout, dtype))


def _grouped_width(in_channels: int, use_xyz: bool) -> int:
    """The width of a grouped input: the relative xyz alone where there are
    no features (`in_channels` 0), else the features, after the xyz where
    `use_xyz`."""
    return 3 if in_channels == 0 else in_channels + 3 * use_xyz


def _grouped_input(grouped_xyz: torch.Tensor, features: Optional[torch.Tensor],
                   idx: torch.Tensor, use_xyz: bool) -> torch.Tensor:
    """The JAX modules' choice of MLP input: the grouped xyz where there
    are no features, else the grouped features, after the xyz where
    `use_xyz`."""
    if features is None:
        return grouped_xyz
    grouped = ops.group_points(features, idx)
    return torch.cat([grouped_xyz, grouped], dim=-1) if use_xyz else grouped


class SAModuleVotes(nn.Module):
    """Set abstraction: FPS -> ball query + group -> SharedMLP -> max-pool
    (PointnetSAModuleVotes with pooling='max', use_xyz=True).
    `mlp_channels` excludes the implicit +3 xyz input channels.

    fused=True routes the MLP + max-pool through `ops.fused_mlp_pool` when
    nsample and the widths pass `ops.fused_mlp_supports` at the compute
    dtype (the JAX package's FusedMLPPool): the same parameters and
    buffers, and in train mode the same running-stat update from the
    kernel's batch statistics. `fused` reads the gate at the current
    compute dtype (bfloat16 asks K % 16 == 0).

    remat=True (the JAX package's nn.remat of `_mlp_pool`) recomputes the
    unfused SharedMLP + max-pool in the backward from the grouped input
    instead of keeping its (B, npoint, nsample, C) activations: the FPS and
    the ball query are not run again, the recompute takes the forward's
    data-parallel context and moves no running statistic (`_recompute`).
    The fused route keeps no such activations, so the flag leaves it
    alone."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_channels: int, mlp_channels: Sequence[int],
                 normalize_xyz: bool = False, fused: bool = False,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.normalize_xyz = normalize_xyz
        self.mlp_channels = list(mlp_channels)
        self.mlp_module = SharedMLP([in_channels + 3, *mlp_channels], dtype)
        self.fuse = fused
        self.remat = remat
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

    def _mlp_pool(self, grouped: torch.Tensor) -> torch.Tensor:
        return self.mlp_module(grouped).amax(dim=2)

    def group(self, xyz: torch.Tensor,
              features: Optional[torch.Tensor] = None,
              inds: Optional[torch.Tensor] = None):
        """The centres and their groups: xyz (B,N,3), features (B,N,C) ->
        new_xyz (B,npoint,3), inds (B,npoint) int32, the ball query's idx
        (B,npoint,nsample), the MLP's input (B,npoint,nsample,3+C). `inds`,
        when given, are the centres' indices into xyz in place of the
        FPS."""
        if inds is None:
            inds = ops.fps(xyz, self.npoint)
        new_xyz = ops.gather_points(xyz, inds)
        idx, grouped_xyz = ops.ball_query_group(self.radius, self.nsample,
                                                xyz, new_xyz)
        if self.normalize_xyz:
            grouped_xyz = grouped_xyz / self.radius
        return new_xyz, inds, idx, _grouped_input(grouped_xyz, features, idx,
                                                  True)

    def pool(self, grouped: torch.Tensor) -> torch.Tensor:
        """The shared MLP and the max over each group: (B,npoint,nsample,
        3+C) -> (B,npoint,C_out), fused, recomputed in the backward, or
        plain."""
        if self.fused:
            return self._fused_mlp_pool(grouped)
        if self.remat and torch.is_grad_enabled():
            dp = parallel.current()
            return checkpoint(
                self._mlp_pool, grouped, use_reentrant=False,
                preserve_rng_state=False,
                context_fn=lambda: (contextlib.nullcontext(), _recompute(dp)))
        return self._mlp_pool(grouped)

    def forward(self, xyz: torch.Tensor,
                features: Optional[torch.Tensor] = None,
                inds: Optional[torch.Tensor] = None):
        """xyz (B,N,3), features (B,N,C) -> new_xyz (B,npoint,3),
        new_features (B,npoint,C_out), inds (B,npoint) int32 (`group`)."""
        new_xyz, inds, _, grouped = self.group(xyz, features, inds)
        return new_xyz, self.pool(grouped), inds


class SAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction (PointnetSAModuleMSG /
    PointnetSAModuleMSGVotes, pointnet2_modules.py:78-158, 274-353): one
    FPS, then for each (radius, nsample, mlp) branch the idx-only
    `ops.ball_query`, the grouped xyz relative to the centre (divided by
    the radius with `normalize_xyz`) and the grouped features, a float32
    SharedMLP (`mlps.{i}`) and a max-pool over nsample; the branches'
    pooled features concatenated. `mlps` lists each branch's output widths,
    `in_channels` the features' width (0: no features)."""

    def __init__(self, npoint: int, radii: Sequence[float],
                 nsamples: Sequence[int], in_channels: int,
                 mlps: Sequence[Sequence[int]], normalize_xyz: bool = False,
                 use_xyz: bool = True):
        super().__init__()
        if not len(radii) == len(nsamples) == len(mlps):
            raise ValueError(f"SAModuleMSG: {len(radii)} radii, "
                             f"{len(nsamples)} nsamples, {len(mlps)} mlps")
        self.npoint = npoint
        self.radii, self.nsamples = list(radii), list(nsamples)
        self.normalize_xyz, self.use_xyz = normalize_xyz, use_xyz
        cin = _grouped_width(in_channels, use_xyz)
        self.mlps = nn.ModuleList(SharedMLP([cin, *mlp]) for mlp in mlps)

    def forward(self, xyz: torch.Tensor,
                features: Optional[torch.Tensor] = None,
                inds: Optional[torch.Tensor] = None):
        """xyz (B,N,3), features (B,N,C) or None, inds (B,npoint) or None
        (FPS) -> new_xyz (B,npoint,3), new_features (B,npoint,
        sum of the branches' last widths), inds (B,npoint) int32."""
        if inds is None:
            inds = ops.fps(xyz, self.npoint)
        new_xyz = ops.gather_points(xyz, inds)
        outs = []
        for radius, nsample, mlp in zip(self.radii, self.nsamples, self.mlps):
            idx = ops.ball_query(radius, nsample, xyz, new_xyz)
            grouped_xyz = ops.group_points(xyz, idx) - new_xyz[:, :, None, :]
            if self.normalize_xyz:
                grouped_xyz = grouped_xyz / radius
            grouped = _grouped_input(grouped_xyz, features, idx, self.use_xyz)
            outs.append(mlp(grouped).amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1), inds


class GroupAllModule(nn.Module):
    """GroupAll (pointnet2_utils.py:379-425) + SharedMLP + max-pool: the
    whole cloud as one group -> one global feature. The MLP's input is the
    xyz where there are no features (`in_channels` 0), else the features,
    after the xyz where `use_xyz` (the JAX module's choice); it is the
    reference's `mlp_module` (PointnetSAModuleVotes with npoint None)."""

    def __init__(self, in_channels: int, mlp_channels: Sequence[int],
                 use_xyz: bool = True):
        super().__init__()
        self.use_xyz = use_xyz
        self.mlp_module = SharedMLP([_grouped_width(in_channels, use_xyz),
                                     *mlp_channels])

    def forward(self, xyz: torch.Tensor,
                features: Optional[torch.Tensor] = None) -> torch.Tensor:
        """xyz (B,N,3), features (B,N,C) or None -> (B, 1, C_out)."""
        grouped = xyz[:, None]
        if features is not None:
            f = features[:, None]
            grouped = torch.cat([grouped, f], dim=-1) if self.use_xyz else f
        return self.mlp_module(grouped).amax(dim=2)


class LFPModuleMSG(nn.Module):
    """Learnable multi-scale feature propagation (PointnetLFPModuleMSG,
    pointnet2_modules.py:418-497): features1 at xyz1 propagated onto the
    xyz2 centres. For each (radius, nsample, mlp) scale,
    `ops.ball_query_group` around the xyz2 centres (which need not lie in
    xyz1: a centre with no point in its ball groups xyz1[0] - centre and
    features1[0], as the reference pads), a float32 SharedMLP (`mlps.{i}`)
    and a max-pool, the xyz2-side skip features2 concatenated after it, then
    one post MLP (`post_mlp`) whose weights all scales share; the scales'
    outputs concatenated on channels. `mlps` and `post_mlp` list output
    widths; `in_channels1` / `in_channels2` are the widths of features1 /
    features2 (0: none)."""

    def __init__(self, radii: Sequence[float], nsamples: Sequence[int],
                 in_channels1: int, in_channels2: int,
                 mlps: Sequence[Sequence[int]], post_mlp: Sequence[int],
                 use_xyz: bool = True):
        super().__init__()
        if not len(radii) == len(nsamples) == len(mlps):
            raise ValueError(f"LFPModuleMSG: {len(radii)} radii, "
                             f"{len(nsamples)} nsamples, {len(mlps)} mlps")
        widths = {mlp[-1] + in_channels2 for mlp in mlps}
        if len(widths) != 1:
            raise ValueError(f"LFPModuleMSG: the scales share post_mlp, but "
                             f"their outputs + the skip are {sorted(widths)} "
                             f"wide")
        self.radii, self.nsamples = list(radii), list(nsamples)
        self.use_xyz = use_xyz
        cin = _grouped_width(in_channels1, use_xyz)
        self.mlps = nn.ModuleList(SharedMLP([cin, *mlp]) for mlp in mlps)
        self.post_mlp = SharedMLP([widths.pop(), *post_mlp])

    def forward(self, xyz2: torch.Tensor, xyz1: torch.Tensor,
                features2: Optional[torch.Tensor],
                features1: Optional[torch.Tensor]) -> torch.Tensor:
        """xyz2 (B,N2,3) targets, xyz1 (B,N1,3) sources, features2
        (B,N2,C2) skip or None, features1 (B,N1,C1) or None ->
        (B, N2, len(mlps) * post_mlp[-1])."""
        outs = []
        for radius, nsample, mlp in zip(self.radii, self.nsamples, self.mlps):
            idx, grouped_xyz = ops.ball_query_group(radius, nsample, xyz1,
                                                    xyz2)
            grouped = _grouped_input(grouped_xyz, features1, idx,
                                     self.use_xyz)
            new = mlp(grouped).amax(dim=2)
            if features2 is not None:
                new = torch.cat([new, features2], dim=-1)
            outs.append(self.post_mlp(new))
        return torch.cat(outs, dim=-1)


class FPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance upsampling + SharedMLP;
    channel order [interpolated known, skip] like the reference. The
    interpolation weights have the coordinates' type, float32 under float32
    and bfloat16 and float64 under float64, as in the JAX package."""

    def __init__(self, channels: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = SharedMLP(channels, dtype)

    def forward(self, unknown_xyz, known_xyz, unknown_feats, known_feats):
        interp = ops.interpolate_features(unknown_xyz, known_xyz, known_feats)
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(interp)
