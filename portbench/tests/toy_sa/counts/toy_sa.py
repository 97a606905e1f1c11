"""The test-only model's counts: the shared MLP over every grouped row and
the head; one FPS and one ball query a forward; no fused SA-MLP."""
from __future__ import annotations

from typing import Dict

from portbench.counts import point_kernels
from portbench.counts.layers import chain_flops


def forward_flops(cfg: Dict, B: int) -> int:
    rows = B * cfg["npoint"] * cfg["nsample"]
    return (chain_flops(rows, [3] + list(cfg["mlp"]))
            + chain_flops(B, [cfg["mlp"][-1], cfg["num_out"]]))


def step_flops(cfg: Dict, B: int, teacher: bool) -> int:
    return (3 + int(teacher)) * forward_flops(cfg, B)


def point_kernels_bound_s(cfg: Dict, B: int) -> float:
    N, S = cfg["num_points"], cfg["npoint"]
    return (point_kernels.fps_call_bound_s(B, N, S)
            + point_kernels.ball_query_call_bound_s(B, N, S, cfg["nsample"]))


def fused_mlp_bound_s(cfg: Dict, B: int, train: bool):
    return None
