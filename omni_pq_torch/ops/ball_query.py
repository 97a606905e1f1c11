"""Ball query (+ relative-xyz grouping, + feature-row grouping): the
hand-written CUDA kernel and its plain versions.

`ball_query_group`, `ball_query` and `ball_query_group_feats` take the plain
version for tensors on the CPU and launch the CUDA kernel
(`omni_pq_torch/csrc/ball_query.cu`) for tensors on the card, at every
shape: there is no size threshold and no fallback. They replace the JAX
package's Pallas kernel `omni_pq_tpu/ops/ball_query.py::_bq_kernel`
(`ball_query` is its idx-only form, `ball_query_group_feats` its
`feat_dim > 0` form; all three share the kernel).

`ball_query_group` is an autograd Function on both devices, with the JAX
package's custom VJP (`_bqg_bwd`): grouped = xyz[idx] - centre, so the
points get the scatter-add of the cotangent at idx (a centre with no hit
has idx 0, so its rows' gradient goes to xyz[0]) and each centre gets minus
the sum over its K slots. The JAX VJP is plain XLA, so the backward here is
plain torch too (`index_add_`, whose atomics on the card add in no fixed
order). `ball_query_group_feats` adds grouped features = features[idx], whose
cotangent scatter-adds into the features the same way (`_bqg_feats_bwd`).
`ball_query` has no gradient, like the reference's BallQuery.

float64 coordinates (the float64 route, `ModelConfig(compute_dtype=
"float64")`) take the JAX package's oracle semantics
(`omni_pq_tpu/interop/oracle_ops.py`): the indices are decided on float32
copies of the coordinates, by the idx-only kernel on the card (its launch
counts as `ball_query`'s) and by `ball_query_ref` on the CPU, and the
grouped values are then gathered from the float64 tensors, so they never
pass through float32; their gradient is the gather's own (a scatter-add
into the points, minus the K-sum into the centres), in float64.
"""
from __future__ import annotations

import functools

import torch

from . import cuda
from .interpolate import group_points
from .reference import ball_query_ref, radius_sq


def ball_query_group_plain(radius: float, nsample: int, xyz: torch.Tensor,
                           new_xyz: torch.Tensor):
    """Plain version of `ball_query_group`: ball_query_ref (on float32
    copies), then the gather in the coordinates' type."""
    idx = ball_query_ref(radius, nsample, xyz, new_xyz)
    return idx, group_points(xyz, idx) - new_xyz[:, :, None, :]


def ball_query_group_feats_plain(radius: float, nsample: int,
                                 xyz: torch.Tensor, new_xyz: torch.Tensor,
                                 features: torch.Tensor):
    """Plain version of `ball_query_group_feats`: `ball_query_group_plain`,
    then the feature gather."""
    idx, grouped = ball_query_group_plain(radius, nsample, xyz, new_xyz)
    return idx, grouped, group_points(features, idx)


# feature types the kernel copies (the JAX kernel's: float32 and bfloat16)
FEATURE_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def scan_max_points() -> int:
    """Rows of up to this many points are scanned whole; larger rows skip
    32-point chunks by their bounding boxes, which the launch writes into a
    scratch table first (read from the built library: csrc/point_logic.cuh,
    kBqScanMaxPoints)."""
    return cuda.library("ball_query")[2].ball_query_scan_max_points()


def _launch(radius, nsample, xyz, new_xyz, emit_values: bool, features=None):
    cuda.check_cuda_tensor("ball query xyz", xyz, torch.float32, 3, last=3)
    cuda.check_cuda_tensor("ball query centres", new_xyz, torch.float32, 3,
                           last=3)
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    if new_xyz.shape[0] != B or new_xyz.device != xyz.device or N < 1:
        raise ValueError(f"ball query: points {tuple(xyz.shape)} on "
                         f"{xyz.device}, centres {tuple(new_xyz.shape)} on "
                         f"{new_xyz.device}")
    dev = xyz.device
    # scratch: each 32-point chunk's bounding box (six arrays of bounds a
    # row), written by the launch
    boxes = (torch.empty(B, 6, -(-N // 32), dtype=torch.float32, device=dev)
             if N > scan_max_points() else None)
    idx = torch.empty(B, S, nsample, dtype=torch.int32, device=dev)
    grouped = (torch.empty(B, S, nsample, 3, dtype=torch.float32, device=dev)
               if emit_values else None)
    feats = None
    if features is not None:
        if features.dtype not in FEATURE_DTYPES:
            raise ValueError(f"ball query features: expected one of "
                             f"{FEATURE_DTYPES}, got {features.dtype}")
        cuda.check_cuda_tensor("ball query features", features,
                               features.dtype, 3)
        if features.shape[:2] != (B, N) or features.device != dev:
            raise ValueError(f"ball query: features {tuple(features.shape)} "
                             f"on {features.device} for points "
                             f"{tuple(xyz.shape)} on {dev}")
        feats = torch.empty(B, S, nsample, features.shape[2],
                            dtype=features.dtype, device=dev)
    row_bytes = (features.shape[2] * features.element_size()
                 if feats is not None and feats.numel() else 0)
    cuda.launch("ball_query", dev, xyz.data_ptr(), new_xyz.data_ptr(),
                None if boxes is None else boxes.data_ptr(), idx.data_ptr(),
                grouped.data_ptr() if emit_values else None,
                features.data_ptr() if row_bytes else None,
                feats.data_ptr() if row_bytes else None, row_bytes,
                B, N, S, nsample, radius_sq(radius))
    return idx, grouped, feats


def scatter_add_rows(idx: torch.Tensor, g: torch.Tensor, N: int):
    """The VJP of a row gather rows[b, idx]: (idx (B,S,K), cotangent
    (B,S,K,C)) -> (B,N,C), each g row added at its index."""
    B, C = idx.shape[0], g.shape[-1]
    rows = (idx.long() + N * torch.arange(B, device=idx.device)[:, None, None])
    out = torch.zeros(B * N, C, dtype=g.dtype, device=g.device)
    out.index_add_(0, rows.reshape(-1), g.reshape(-1, C))
    return out.reshape(B, N, C)


def ball_query_group_backward(idx: torch.Tensor, g: torch.Tensor, N: int):
    """The VJP of grouped = xyz[idx] - centre: (idx (B,S,K), cotangent
    (B,S,K,3)) -> (d xyz (B,N,3), d centres (B,S,3))."""
    return scatter_add_rows(idx, g, N), -g.sum(dim=2)


def _group_float64(radius, nsample, xyz, new_xyz, features=None):
    """The grouping entry points on float64 coordinates: the idx-only
    `ball_query` on their float32 copies, then float64 gathers that autograd
    differentiates."""
    idx = ball_query(radius, nsample, xyz, new_xyz)
    grouped = group_points(xyz, idx) - new_xyz[:, :, None, :]
    if features is None:
        return idx, grouped
    return idx, grouped, group_points(features, idx)


class _BallQueryGroup(torch.autograd.Function):
    """Both grouping entry points: features None gives (idx, grouped), a
    feature tensor adds the grouped features and their gradient. `counter`
    is the entry point whose launch count a kernel launch raises."""

    @staticmethod
    def forward(ctx, radius, nsample, xyz, new_xyz, features, counter):
        if xyz.device.type == "cpu":
            idx, grouped = ball_query_group_plain(radius, nsample, xyz,
                                                  new_xyz)
            feats = (None if features is None
                     else group_points(features, idx))
        else:
            idx, grouped, feats = _launch(radius, nsample, xyz, new_xyz,
                                          emit_values=True, features=features)
            counter.launches += 1
        ctx.save_for_backward(idx)
        ctx.n_points = xyz.shape[1]
        ctx.mark_non_differentiable(idx)
        return (idx, grouped) if feats is None else (idx, grouped, feats)

    @staticmethod
    def backward(ctx, _g_idx, g, g_feats=None):
        idx, = ctx.saved_tensors
        dxyz, dnew = ball_query_group_backward(idx, g, ctx.n_points)
        dfeats = (None if g_feats is None
                  else scatter_add_rows(idx, g_feats, ctx.n_points))
        return None, None, dxyz, dnew, dfeats, None


def ball_query_group(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor):
    """Fused ball query + relative-xyz grouping.

    (B,N,3) points x (B,S,3) centres -> (idx (B,S,nsample) int32,
    grouped (B,S,nsample,3) float32) with grouped == xyz[idx] - centre. A
    centre with no in-radius hit gets idx 0 and rows xyz[0] - centre.
    Differentiable in xyz and new_xyz (see the module docstring). float64
    coordinates give float64 grouped values (see the module docstring)."""
    if xyz.dtype == torch.float64:
        return _group_float64(radius, nsample, xyz, new_xyz)
    return _BallQueryGroup.apply(radius, nsample, xyz, new_xyz, None,
                                 ball_query_group)


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """(B,N,3) points x (B,S,3) centres -> (B,S,nsample) int32 neighbour
    indices: the first <= nsample points by index with d^2 < r^2, unfilled
    slots repeating the first hit (0 when there is none). float64
    coordinates are queried on their float32 copies."""
    if xyz.device.type == "cpu":
        return ball_query_ref(radius, nsample, xyz, new_xyz)
    if xyz.dtype == torch.float64:
        xyz, new_xyz = xyz.detach().float(), new_xyz.detach().float()
    idx, _, _ = _launch(radius, nsample, xyz, new_xyz, emit_values=False)
    ball_query.launches += 1
    return idx


def ball_query_group_feats(radius: float, nsample: int, xyz: torch.Tensor,
                           new_xyz: torch.Tensor, features: torch.Tensor):
    """Fused ball query + relative-xyz grouping + feature-row grouping.

    (B,N,3) points x (B,S,3) centres x (B,N,C) features -> (idx
    (B,S,nsample) int32, grouped (B,S,nsample,3) float32, grouped features
    (B,S,nsample,C) of the features' type, float32 or bfloat16) with
    grouped == xyz[idx] - centre and grouped features == features[idx]. A
    centre with no in-radius hit gets idx 0: rows xyz[0] - centre and
    features[0]. Differentiable in xyz, new_xyz and features (see the module
    docstring). float64 coordinates: see the module docstring."""
    if xyz.dtype == torch.float64:
        return _group_float64(radius, nsample, xyz, new_xyz, features)
    return _BallQueryGroup.apply(radius, nsample, xyz, new_xyz, features,
                                 ball_query_group_feats)


ball_query_group.launches = 0  # kernel launches since last set to 0
ball_query.launches = 0
ball_query_group_feats.launches = 0
