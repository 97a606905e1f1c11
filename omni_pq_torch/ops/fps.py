"""Furthest point sampling: the hand-written CUDA kernel and its plain version.

`fps` takes the plain version for a tensor on the CPU and launches the CUDA
kernel (`omni_pq_torch/csrc/fps.cu`) for one on the card, at every shape:
there is no size threshold and no fallback. It replaces the JAX package's
Pallas kernel `omni_pq_tpu/ops/fps.py::_fps_kernel`.
"""
from __future__ import annotations

import torch

from . import cuda
from .reference import fps_ref as fps_plain

# the min-distance row lives in shared memory: 227 KB a block, less 1 KB
# kept for the kernel's static shared memory (272 bytes by ptxas)
MAX_POINTS = (232448 - 1024) // 4


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Furthest point sampling: (B, N, 3) float32 -> (B, npoint) int32.

    Index 0 is always selected first; near-origin points (padding) are never
    selected. No gradient, like the reference's FurthestPointSampling."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint)
    cuda.check_cuda_tensor("fps xyz", xyz, torch.float32, 3, last=3)
    B, N, _ = xyz.shape
    if not 0 < N <= MAX_POINTS or npoint < 1:
        raise ValueError(f"fps kernel takes 0 < N <= {MAX_POINTS} points and "
                         f"npoint >= 1, got N={N}, npoint={npoint}")
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    if B:
        cuda.launch("fps", xyz.device, xyz.data_ptr(), out.data_ptr(), B, N,
                    npoint)
        fps.launches += 1
    return out


fps.launches = 0  # kernel launches since the count was last set to 0
