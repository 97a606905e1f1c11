"""Ball query (+ relative-xyz grouping): the hand-written CUDA kernel and its
plain version.

`ball_query_group` and `ball_query` take the plain version for tensors on the
CPU and launch the CUDA kernel (`omni_pq_torch/csrc/ball_query.cu`) for
tensors on the card, at every shape: there is no size threshold and no
fallback. They replace the JAX package's Pallas kernel
`omni_pq_tpu/ops/ball_query.py::_bq_kernel` (`ball_query` is its idx-only
form and shares the kernel).

`ball_query_group` is an autograd Function on both devices, with the JAX
package's custom VJP (`_bqg_bwd`): grouped = xyz[idx] - centre, so the
points get the scatter-add of the cotangent at idx (a centre with no hit
has idx 0, so its rows' gradient goes to xyz[0]) and each centre gets minus
the sum over its K slots. The JAX VJP is plain XLA, so the backward here is
plain torch too (`index_add_`, whose atomics on the card add in no fixed
order). `ball_query` has no gradient, like the reference's BallQuery.
"""
from __future__ import annotations

import torch

from . import cuda
from .interpolate import group_points
from .reference import ball_query_ref, radius_sq


def ball_query_group_plain(radius: float, nsample: int, xyz: torch.Tensor,
                           new_xyz: torch.Tensor):
    """Plain version of `ball_query_group`: ball_query_ref, then the gather."""
    idx = ball_query_ref(radius, nsample, xyz, new_xyz)
    return idx, group_points(xyz, idx) - new_xyz[:, :, None, :]


def _launch(radius, nsample, xyz, new_xyz, emit_values: bool):
    cuda.check_cuda_tensor("ball query xyz", xyz, torch.float32, 3, last=3)
    cuda.check_cuda_tensor("ball query centres", new_xyz, torch.float32, 3,
                           last=3)
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    if new_xyz.shape[0] != B or new_xyz.device != xyz.device or N < 1:
        raise ValueError(f"ball query: points {tuple(xyz.shape)} on "
                         f"{xyz.device}, centres {tuple(new_xyz.shape)} on "
                         f"{new_xyz.device}")
    idx = torch.empty(B, S, nsample, dtype=torch.int32, device=xyz.device)
    grouped = (torch.empty(B, S, nsample, 3, dtype=torch.float32,
                           device=xyz.device) if emit_values else None)
    cuda.launch("ball_query", xyz.device, xyz.data_ptr(), new_xyz.data_ptr(),
                idx.data_ptr(), grouped.data_ptr() if emit_values else None,
                B, N, S, nsample, radius_sq(radius))
    return idx, grouped


def ball_query_group_backward(idx: torch.Tensor, g: torch.Tensor, N: int):
    """The VJP of grouped = xyz[idx] - centre: (idx (B,S,K), cotangent
    (B,S,K,3)) -> (d xyz (B,N,3), d centres (B,S,3))."""
    B, S, K = idx.shape
    rows = (idx.long() + N * torch.arange(B, device=idx.device)[:, None, None])
    dxyz = torch.zeros(B * N, 3, dtype=g.dtype, device=g.device)
    dxyz.index_add_(0, rows.reshape(-1), g.reshape(-1, 3))
    return dxyz.reshape(B, N, 3), -g.sum(dim=2)


class _BallQueryGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, radius, nsample, xyz, new_xyz):
        if xyz.device.type == "cpu":
            idx, grouped = ball_query_group_plain(radius, nsample, xyz,
                                                  new_xyz)
        else:
            idx, grouped = _launch(radius, nsample, xyz, new_xyz,
                                   emit_values=True)
            ball_query_group.launches += 1
        ctx.save_for_backward(idx)
        ctx.n_points = xyz.shape[1]
        ctx.mark_non_differentiable(idx)
        return idx, grouped

    @staticmethod
    def backward(ctx, _g_idx, g):
        idx, = ctx.saved_tensors
        dxyz, dnew = ball_query_group_backward(idx, g, ctx.n_points)
        return None, None, dxyz, dnew


def ball_query_group(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor):
    """Fused ball query + relative-xyz grouping.

    (B,N,3) points x (B,S,3) centres -> (idx (B,S,nsample) int32,
    grouped (B,S,nsample,3) float32) with grouped == xyz[idx] - centre. A
    centre with no in-radius hit gets idx 0 and rows xyz[0] - centre.
    Differentiable in xyz and new_xyz (see the module docstring)."""
    return _BallQueryGroup.apply(radius, nsample, xyz, new_xyz)


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """(B,N,3) points x (B,S,3) centres -> (B,S,nsample) int32 neighbour
    indices: the first <= nsample points by index with d^2 < r^2, unfilled
    slots repeating the first hit (0 when there is none)."""
    if xyz.device.type == "cpu":
        return ball_query_ref(radius, nsample, xyz, new_xyz)
    idx, _ = _launch(radius, nsample, xyz, new_xyz, emit_values=False)
    ball_query.launches += 1
    return idx


ball_query_group.launches = 0  # kernel launches since last set to 0
ball_query.launches = 0
