"""Supervised detection + layout losses (the port of
`omni_pq_tpu/losses/supervised.py`).

The reference's models/loss_helper_pq.py: vote loss (:24), objectness loss
(:47), box + semantic-class loss (:92), quad score loss (:197), quad geometry
loss (:258), physical-constraint loss (:357, vectorised with masks instead of
per-scene loops) and the total get_loss (:412-486), with its weighting:
    loss = 10 * (pc + vote + 1/(L+1) * (0.9*object + 0.1*quad))
    object = box + 0.1*sem_cls + 0.5*objectness
    quad   = (center+normal+size) + 0.5*quad_score

Inputs: a merged dict `ep` of model end_points plus label tensors under the
reference's key names, fixed-shape padded (MAX_NUM_OBJ=64, MAX_NUM_QUAD=32);
`num_gt_boxes` / `num_gt_quads` are (B,) true counts. Masks, labels and
counts are float32 wherever the JAX package casts them to float32, on
float64 end points too: under the float64 route the normalisers
(sum of a mask + 1e-6, 1 / the box count) are float32 values in both.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..ops.nn_distance import nn_distance, smoothl1_loss
from .primitives import constant

FAR_THRESHOLD = 0.6
NEAR_THRESHOLD = 0.3
GT_VOTE_FACTOR = 3
OBJECTNESS_CLS_WEIGHTS = (0.2, 0.8)
QUAD_CLS_WEIGHTS = (0.4, 0.6)
# semantic classes excluded from the physical-constraint loss: door(5),
# window(6), picture(8), curtain(11) (loss_helper_pq.py:352-355)
PC_EXCLUDED_CLASSES = (5, 6, 8, 11)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) rows at idx (B, K) -> (B, K, ...)."""
    i = idx.long().reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, i.expand(idx.shape + x.shape[2:]))


def select_last_dim(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """x[..., labels] along the trailing (class) axis; labels in range."""
    return torch.gather(x, -1, labels.long()[..., None])[..., 0]


def weighted_ce(logits, labels, weights=None):
    """Per-element cross entropy -w[y]*log_softmax(x)[y] (torch CE 'none')."""
    ll = select_last_dim(torch.log_softmax(logits, dim=-1), labels)
    if weights is not None:
        wt = constant(tuple(weights), logits)
        return -wt[labels.long()] * ll
    return -ll


def prefixes_for(num_layer: int):
    """Loss iteration order of the reference (loss_helper_pq.py:51)."""
    return ["proposal_", "last_"] + [f"{i}head_" for i in range(num_layer - 1)]


def compute_vote_loss(ep: Dict) -> torch.Tensor:
    """VoteNet vote regression loss (loss_helper_pq.py:24-45)."""
    B, num_seed, _ = ep["seed_xyz"].shape
    vote_xyz = ep["vote_xyz"]  # (B, num_seed*factor, 3)
    seed_inds = ep["seed_inds"]
    seed_gt_votes_mask = _take(ep["vote_label_mask"], seed_inds).to(
        vote_xyz.dtype)
    seed_gt_votes = (_take(ep["vote_label"], seed_inds)
                     + ep["seed_xyz"].repeat(1, 1, GT_VOTE_FACTOR))
    vote_r = vote_xyz.reshape(B * num_seed, -1, 3)
    gt_r = seed_gt_votes.reshape(B * num_seed, GT_VOTE_FACTOR, 3)
    _, _, dist2, _ = nn_distance(vote_r, gt_r, l1=True)
    votes_dist = dist2.amin(dim=1).reshape(B, num_seed)
    return (votes_dist * seed_gt_votes_mask).sum() / (
        seed_gt_votes_mask.sum() + 1e-6)


def _assign(agg_xyz, gt_center, num_gt, near=NEAR_THRESHOLD,
            far=FAR_THRESHOLD) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Chamfer GT assignment with NEAR/FAR gating (loss_helper_pq.py:56-74).
    Returns (label (B,K) int32, mask (B,K) float, assignment (B,K) int32)."""
    K2 = gt_center.shape[1]
    dist1, ind1, _, _ = nn_distance(agg_xyz.detach(), gt_center)
    euclid = torch.sqrt(dist1 + 1e-6)
    label = (euclid < near).to(torch.int32)
    label = torch.where(ind1 >= num_gt[:, None], 0, label)
    mask = ((euclid < near) | (euclid > far)).to(torch.float32)
    assignment = torch.where(label == 0, K2 - 1, ind1)
    return label, mask, assignment.to(torch.int32)


def compute_objectness_and_box_loss(ep: Dict, mean_size_arr, num_layer: int,
                                    stats: Dict, near=NEAR_THRESHOLD,
                                    far=FAR_THRESHOLD):
    """Objectness + box + sem-cls losses over all prefixes
    (loss_helper_pq.py:47-193). The assignment depends only on
    aggregated_vote_xyz, so it is computed once and shared."""
    gt_center = ep["center_label"][:, :, 0:3]
    label, mask, assignment = _assign(ep["aggregated_vote_xyz"], gt_center,
                                      ep["num_gt_boxes"], near, far)
    labelf = label.to(torch.float32)
    n_pos = labelf.sum() + 1e-6
    mean_sizes = torch.as_tensor(mean_size_arr, dtype=gt_center.dtype,
                                 device=gt_center.device)

    objectness_sum = box_sum = sem_sum = 0.0
    for prefix in prefixes_for(num_layer):
        ep[f"{prefix}objectness_label"] = label
        ep[f"{prefix}objectness_mask"] = mask
        ep[f"{prefix}object_assignment"] = assignment

        obj_loss = weighted_ce(ep[f"{prefix}objectness_scores"], label,
                               OBJECTNESS_CLS_WEIGHTS)
        obj_loss = (obj_loss * mask).sum() / (mask.sum() + 1e-6)
        objectness_sum = objectness_sum + obj_loss
        stats[f"{prefix}objectness_loss"] = obj_loss

        # center
        assigned_center = _take(gt_center, assignment)
        center_loss = smoothl1_loss(assigned_center - ep[f"{prefix}center"])
        center_loss = (center_loss * labelf[..., None]).sum() / n_pos

        # heading
        hcl = _take(ep["heading_class_label"], assignment)
        heading_cls_loss = (weighted_ce(ep[f"{prefix}heading_scores"], hcl)
                            * labelf).sum() / n_pos
        nh = ep[f"{prefix}heading_scores"].shape[-1]
        hrl = _take(ep["heading_residual_label"], assignment)
        hrl_norm = hrl / (math.pi / nh)
        pred_hr = select_last_dim(
            ep[f"{prefix}heading_residuals_normalized"], hcl)
        heading_reg_loss = (smoothl1_loss(pred_hr - hrl_norm)
                            * labelf).sum() / n_pos

        # size
        scl = _take(ep["size_class_label"], assignment)
        size_cls_loss = (weighted_ce(ep[f"{prefix}size_scores"], scl)
                         * labelf).sum() / n_pos
        srl = _take(ep["size_residual_label"], assignment)  # (B,K,3)
        sr_norm = ep[f"{prefix}size_residuals_normalized"]  # (B,K,C,3)
        pred_sr = torch.gather(
            sr_norm, 2, scl.long()[..., None, None].expand(-1, -1, 1, 3)
        )[:, :, 0]
        srl_norm = srl / mean_sizes[scl.long()]
        size_reg_loss = (smoothl1_loss(pred_sr - srl_norm)
                         * labelf[..., None]).sum() / n_pos

        # semantic class
        sem_label = _take(ep["sem_cls_label"], assignment)
        sem_loss = (weighted_ce(ep[f"{prefix}sem_cls_scores"], sem_label)
                    * labelf).sum() / n_pos

        box_loss = (center_loss + 0.1 * heading_cls_loss + heading_reg_loss
                    + 0.1 * size_cls_loss + size_reg_loss)
        stats[f"{prefix}center_loss"] = center_loss
        stats[f"{prefix}heading_cls_loss"] = heading_cls_loss
        stats[f"{prefix}heading_reg_loss"] = heading_reg_loss
        stats[f"{prefix}size_cls_loss"] = size_cls_loss
        stats[f"{prefix}size_reg_loss"] = size_reg_loss
        stats[f"{prefix}box_loss"] = box_loss
        stats[f"{prefix}sem_cls_loss"] = sem_loss
        box_sum = box_sum + box_loss
        sem_sum = sem_sum + sem_loss
    return objectness_sum, box_sum, sem_sum


def compute_quad_losses(ep: Dict, num_layer: int, stats: Dict,
                        near=NEAR_THRESHOLD, far=FAR_THRESHOLD):
    """Quad score + geometry losses over all prefixes
    (loss_helper_pq.py:197-304)."""
    gt_center = ep["gt_quad_centers"][:, :, 0:3]
    label, mask, assignment = _assign(ep["aggregated_sample_xyz"], gt_center,
                                      ep["num_gt_quads"], near, far)
    labelf = label.to(torch.float32)
    n_pos = labelf.sum() + 1e-6

    score_sum = center_sum = vector_sum = size_sum = 0.0
    for prefix in prefixes_for(num_layer):
        ep[f"{prefix}quad_label"] = label
        ep[f"{prefix}quad_mask"] = mask
        ep[f"{prefix}quad_assignment"] = assignment

        score_loss = weighted_ce(ep[f"{prefix}quad_scores"], label,
                                 QUAD_CLS_WEIGHTS)
        score_loss = (score_loss * mask).sum() / (mask.sum() + 1e-6)
        stats[f"{prefix}quad_scores_loss"] = score_loss
        score_sum = score_sum + score_loss

        assigned_center = _take(gt_center, assignment)
        center_loss = smoothl1_loss(assigned_center
                                    - ep[f"{prefix}quad_center"])
        center_loss = (center_loss * labelf[..., None]).sum() / n_pos
        stats[f"{prefix}quad_center_loss"] = center_loss
        center_sum = center_sum + center_loss

        gt_vec = _take(ep["gt_normal_vectors"], assignment)
        pred_vec = ep[f"{prefix}normal_vector"]
        cos = (pred_vec * gt_vec).sum(-1) / (
            torch.linalg.vector_norm(pred_vec, dim=-1)
            * torch.linalg.vector_norm(gt_vec, dim=-1) + 1e-8)
        vector_loss = ((1.0 - cos) * labelf).sum() / n_pos
        stats[f"{prefix}normal_vector_loss"] = vector_loss
        vector_sum = vector_sum + vector_loss

        gt_size = _take(ep["gt_quad_sizes"], assignment)
        size_loss = smoothl1_loss(ep[f"{prefix}quad_size"] - gt_size)
        size_loss = (size_loss * labelf[..., None]).sum() / n_pos
        stats[f"{prefix}quad_size_loss"] = size_loss
        size_sum = size_sum + size_loss
    return score_sum, center_sum, vector_sum, size_sum


def get_2d_box_corners(box_size, center):
    """(B,K,3) size, (B,K,3) center -> (B,K,4,2) xy corners
    (loss_helper_pq.py:307-326)."""
    l, w = box_size[..., 0] / 2, box_size[..., 1] / 2
    dx = torch.stack([l, l, -l, -l], dim=-1)
    dy = torch.stack([w, -w, w, -w], dim=-1)
    return torch.stack([dx + center[..., 0:1], dy + center[..., 1:2]], dim=-1)


def compute_physical_constraints_loss(ep: Dict, mean_size_arr):
    """Object-corner-inside-quads penalty (loss_helper_pq.py:357-410),
    vectorised over (B, quads, corners) with masks. Uses 'last_' only."""
    prefix = "last_"
    pred_center = ep[f"{prefix}center"]  # (B,K,3)
    pred_size_class = ep[f"{prefix}size_scores"].argmax(-1)  # (B,K)
    sres = ep[f"{prefix}size_residuals"]  # (B,K,C,3)
    pred_size_res = torch.gather(
        sres, 2, pred_size_class[..., None, None].expand(-1, -1, 1, 3)
    )[:, :, 0]
    mean_sizes = torch.as_tensor(mean_size_arr, dtype=pred_center.dtype,
                                 device=pred_center.device)
    box_size = mean_sizes[pred_size_class] + pred_size_res

    objectness = ep[f"{prefix}objectness_label"].to(torch.float32)
    sem = _take(ep["sem_cls_label"], ep[f"{prefix}object_assignment"])
    allowed = torch.ones_like(sem, dtype=torch.bool)
    for c in PC_EXCLUDED_CLASSES:
        allowed = allowed & (sem != c)
    box_mask = objectness * allowed.to(torch.float32)  # (B,K)
    num_box = box_mask.sum(dim=1)  # (B,)

    corners = get_2d_box_corners(box_size, pred_center)  # (B,K,4,2)
    B, K = box_mask.shape
    pts = corners.reshape(B, K * 4, 2)
    pts_mask = box_mask.repeat_interleave(4, dim=1)  # (B, K*4)

    qc = ep[f"{prefix}quad_center"]
    nv = ep[f"{prefix}normal_vector"]
    qs = ep[f"{prefix}quad_size"]
    quad_label = ep[f"{prefix}quad_label"].to(torch.float32)  # (B,Q)

    a, b = nv[..., 0], nv[..., 1]  # (B,Q)
    d = -(a * qc[..., 0] + b * qc[..., 1])
    px, py = pts[..., 0], pts[..., 1]  # (B,P)
    delta = (a[:, :, None] * px[:, None, :] + b[:, :, None] * py[:, None, :]
             + d[:, :, None])  # (B,Q,P)
    k = -delta
    projx = px[:, None, :] + a[:, :, None] * k
    projy = py[:, None, :] + b[:, :, None] * k
    w = torch.sqrt((projx - qc[..., 0:1]) ** 2 + (projy - qc[..., 1:2]) ** 2)
    point_mask = (w < qs[..., 0:1]).to(torch.float32)
    per_pt = torch.relu(-delta) * point_mask * pts_mask[:, None, :]
    per_quad = per_pt.sum(dim=2)  # (B,Q)
    scene_scale = torch.where(num_box > 0,
                              1.0 / torch.clamp_min(num_box, 1.0), 0.0)
    pc_loss = (per_quad * quad_label * scene_scale[:, None]).sum()
    collisions = ((per_pt > 1e-4).to(torch.float32)
                  * quad_label[..., None]
                  * (num_box > 0)[:, None, None].to(torch.float32)).sum()
    return pc_loss, collisions


def get_loss(ep: Dict, mean_size_arr, num_layer: int = 6,
             pc_loss: bool = True, near=NEAR_THRESHOLD,
             far=FAR_THRESHOLD) -> Tuple[torch.Tensor, Dict]:
    """Total supervised loss (loss_helper_pq.py:412-486). `ep` is the merged
    end_points + labels dict (it gains the assignment keys); returns
    (scalar loss, stats dict of 0-d tensors)."""
    stats: Dict = {}
    zero = ep["center_label"].new_zeros(())
    vote_loss = compute_vote_loss(ep) if "vote_xyz" in ep else zero
    stats["vote_loss"] = vote_loss

    objectness_sum, box_sum, sem_sum = compute_objectness_and_box_loss(
        ep, mean_size_arr, num_layer, stats, near, far)
    stats["objectness_loss"] = objectness_sum
    stats["box_loss"] = box_sum
    stats["sem_cls_loss_sum"] = sem_sum

    score_sum, qcenter_sum, qvector_sum, qsize_sum = compute_quad_losses(
        ep, num_layer, stats, near, far)
    stats["quad_score_loss_sum"] = score_sum
    quad_loss_sum = qcenter_sum + qvector_sum + qsize_sum
    stats["quad_center_loss_sum"] = qcenter_sum
    stats["quad_vector_loss_sum"] = qvector_sum
    stats["quad_size_loss_sum"] = qsize_sum
    stats["quad_loss_sum"] = quad_loss_sum

    if pc_loss:
        pcl, collisions = compute_physical_constraints_loss(ep, mean_size_arr)
    else:
        pcl, collisions = zero, zero
    stats["physical_constraints_loss"] = pcl
    stats["collisions"] = collisions

    object_loss = box_sum + 0.1 * sem_sum + 0.5 * objectness_sum
    quad_loss = quad_loss_sum + 0.5 * score_sum
    loss = pcl + vote_loss + 1.0 / (num_layer + 1) * (
        0.9 * object_loss + 0.1 * quad_loss)
    loss = loss * 10.0
    stats["loss"] = loss
    return loss, stats
