"""Ball query (+ relative-xyz grouping): the hand-written CUDA kernel and its
plain version.

`ball_query_group` and `ball_query` take the plain version for tensors on the
CPU and launch the CUDA kernel (`omni_pq_torch/csrc/ball_query.cu`) for
tensors on the card, at every shape: there is no size threshold and no
fallback. They replace the JAX package's Pallas kernel
`omni_pq_tpu/ops/ball_query.py::_bq_kernel` (forward; `ball_query` is its
idx-only form and shares the kernel).
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


def ball_query_group(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor):
    """Fused ball query + relative-xyz grouping.

    (B,N,3) points x (B,S,3) centres -> (idx (B,S,nsample) int32,
    grouped (B,S,nsample,3) float32) with grouped == xyz[idx] - centre. A
    centre with no in-radius hit gets idx 0 and rows xyz[0] - centre."""
    if xyz.device.type == "cpu":
        return ball_query_group_plain(radius, nsample, xyz, new_xyz)
    out = _launch(radius, nsample, xyz, new_xyz, emit_values=True)
    ball_query_group.launches += 1
    return out


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
