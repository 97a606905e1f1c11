"""Furthest point sampling: the hand-written CUDA kernel and its plain version.

`fps` takes the plain version for a tensor on the CPU and launches the CUDA
kernel (`omni_pq_torch/csrc/fps.cu`) for one on the card, at every shape:
there is no size threshold and no fallback. It replaces the JAX package's
Pallas kernel `omni_pq_tpu/ops/fps.py::_fps_kernel`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda
from .reference import fps_ref as fps_plain


@functools.lru_cache(maxsize=None)
def max_points() -> int:
    """The kernel's capacity, read from the built library: a row's points
    live in registers, 16 a thread, over a cluster of at most 16 CTAs of 512
    threads (csrc/point_logic.cuh, kFpsMaxPoints)."""
    return cuda.library("fps")[2].fps_max_points()


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Furthest point sampling: (B, N, 3) float32 -> (B, npoint) int32.

    Index 0 is always selected first; near-origin points (padding) are never
    selected. No gradient, like the reference's FurthestPointSampling."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint)
    cuda.check_cuda_tensor("fps xyz", xyz, torch.float32, 3, last=3)
    B, N, _ = xyz.shape
    if not 0 < N <= max_points() or npoint < 1:
        raise ValueError(f"fps kernel takes 0 < N <= {max_points()} points "
                         f"and npoint >= 1, got N={N}, npoint={npoint}")
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    if B:
        cuda.launch("fps", xyz.device, xyz.data_ptr(), out.data_ptr(), B, N,
                    npoint)
        fps.launches += 1
    return out


fps.launches = 0  # kernel launches since the count was last set to 0


def cluster_plan(N: int) -> tuple:
    """(cluster size P, threads a CTA, points a thread) that the kernel
    takes for rows of N points (csrc/point_logic.cuh, fps_plan): one CTA up
    to 2048 points, else a cluster of 16 CTAs a batch row."""
    fn = cuda.library("fps")[2].fps_plan_for
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    plan = (ctypes.c_int * 3)()
    fn(N, plan)
    return tuple(plan)
