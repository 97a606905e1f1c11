"""Legacy EMA-teacher pseudo-GT quad losses (the port of
`omni_pq_tpu/losses/teacher.py`).

Rebuilds models/ema_loss_helper_pq.py:21-67 + loss_helper_pq.py:502-673:
the teacher's quad detections are rotated back into the student's frame and
used as pseudo ground truth for the student's quad score and geometry
losses (`compute_quad_losses`). The reference combines it with weight
lambda_teacher = 0.0 (loss_helper_pq.py:663), so the path is dead there;
it is part of the reference's API surface and keeps that default.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .supervised import compute_quad_losses, get_loss, prefixes_for


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _unrotate(xyz, flip_x, flip_y, rot_mat):
    """Teacher-frame coordinates (B,K,3) back in the student's frame
    (loss_helper_pq.py:504-536: rotz(-angle), then the flips)."""
    dt = torch.promote_types(xyz.dtype, rot_mat.dtype)
    out = torch.einsum("bkj,bij->bki", xyz.to(dt),
                       rot_mat.to(dt).transpose(1, 2))
    out = torch.where(flip_y[:, None, None] > 0,
                      out * out.new_tensor([1.0, -1.0, 1.0]), out)
    return torch.where(flip_x[:, None, None] > 0,
                       out * out.new_tensor([-1.0, 1.0, 1.0]), out)


def get_loss_teacher(ep: Dict, ema_ep: Dict,
                     num_layer: int = 6) -> torch.Tensor:
    """Teacher-as-pseudo-GT quad loss (loss_helper_pq.py:502-647): every
    teacher `last_` quad is a ground-truth quad of the student's prefixes;
    returns (center + normal + size) + 2.5 * score."""
    flip_x, flip_y = ep["flip_x_axis"], ep["flip_y_axis"]
    rot_mat = ep["rot_mat"]
    center = ema_ep["last_quad_center"]
    pseudo_centers = _unrotate(center, flip_x, flip_y, rot_mat)
    B, K2, _ = pseudo_centers.shape

    # the normals through two in-plane tangents rotated back (:602-635)
    normal = ema_ep["last_normal_vector"]
    any_dir = normal.new_tensor([0.0, 0.0, 1.0]).expand_as(normal)
    v1 = torch.linalg.cross(normal, any_dir, dim=-1)
    v1 = v1 / (_norm(v1) + 1e-12)
    v2 = torch.linalg.cross(normal, v1, dim=-1)
    v2 = v2 / (_norm(v2) + 1e-12)
    v1b = _unrotate(center + v1, flip_x, flip_y, rot_mat) - pseudo_centers
    v2b = _unrotate(center + v2, flip_x, flip_y, rot_mat) - pseudo_centers
    v1b = v1b / (_norm(v1b) + 1e-12)
    v2b = v2b / (_norm(v2b) + 1e-12)
    pseudo_normals = torch.linalg.cross(v1b, v2b, dim=-1)
    pseudo_normals = pseudo_normals / (_norm(pseudo_normals) + 1e-12)

    sub = {
        "aggregated_sample_xyz": ep["aggregated_sample_xyz"],
        "gt_quad_centers": pseudo_centers.detach(),
        "gt_quad_sizes": ema_ep["last_quad_size"].detach(),
        "gt_normal_vectors": pseudo_normals.detach(),
        # every teacher proposal counts as pseudo GT (:565-566)
        "num_gt_quads": torch.full((B,), K2, dtype=torch.int32,
                                   device=pseudo_centers.device),
    }
    for prefix in prefixes_for(num_layer):
        for k in ("quad_scores", "quad_center", "quad_size", "normal_vector"):
            sub[f"{prefix}{k}"] = ep[f"{prefix}{k}"]
    score_sum, center_sum, vector_sum, size_sum = compute_quad_losses(
        sub, num_layer, {})
    return center_sum + vector_sum + size_sum + 2.5 * score_sum


def get_loss_mean_teacher(ep: Dict, ema_ep: Dict, mean_size_arr,
                          num_layer: int = 6, pc_loss: bool = False,
                          lambda_teacher: float = 0.0
                          ) -> Tuple[torch.Tensor, Dict]:
    """loss_helper_pq.py:650-673: the supervised loss (counted where any
    scene has use_gt) + lambda_teacher * the teacher loss; lambda_teacher
    defaults to the reference's 0.0. Returns (loss, stats) with the stats
    of `get_loss` and gt_loss, teacher_loss and loss."""
    gt_loss, stats = get_loss(ep, mean_size_arr, num_layer=num_layer,
                              pc_loss=pc_loss)
    teacher_loss = get_loss_teacher(ep, ema_ep, num_layer=num_layer)
    lambda_gt = ep["use_gt"].any().to(gt_loss.dtype)
    loss = lambda_teacher * teacher_loss + lambda_gt * gt_loss
    stats["gt_loss"] = gt_loss
    stats["teacher_loss"] = teacher_loss
    stats["loss"] = loss
    return loss, stats
