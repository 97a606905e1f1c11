"""EMA mean-teacher consistency losses (the port of
`omni_pq_tpu/losses/consistency.py`).

Rebuilds models/utils/mean_teacher_consistency_util.py: teacher predictions
are mapped back into the student's augmented frame (flip -> rotate -> scale,
:31-39), student and teacher proposal sets are Chamfer-matched, per-proposal
distances are confidence-weighted by the *student's* softmax scores indexed
exactly as the reference does (:45-47 — the weights come from the student's
end_points), and each distance tensor is clipped at its 85th percentile
(EMA_CLIP, :17) before averaging. Combination weights per prefix:
objects 0.5*center + 1.0*class + 0.05*size; quads 0.5*center + 0*class +
1.0*normal + 0.05*size; averaged over all 7 prefixes (:201-270).

The teacher's end points carry no gradient (the caller computes them under
`torch.no_grad()`); the student's get the gradients JAX gives them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ops.nn_distance import nn_distance
from .supervised import _take as _take_rows

EMA_CLIP = 0.85


def _align_ema_centers(ema_center, flip_x, flip_y, rot_mat, scale):
    """Map teacher centers into the student frame (:31-39): flip x, flip y,
    then x @ rot_mat^T, then scale."""
    one = ema_center.new_ones(())
    sx = torch.stack([-one, one, one])
    sy = torch.stack([one, -one, one])
    x = torch.where(flip_x[:, None, None] > 0, ema_center * sx, ema_center)
    x = torch.where(flip_y[:, None, None] > 0, x * sy, x)
    dt = torch.promote_types(x.dtype, rot_mat.dtype)
    x = torch.bmm(x.to(dt), rot_mat.to(dt).transpose(1, 2))
    return x * scale[:, None, None]


def _quantile_clip_mean(dist):
    """mean of dist * (dist < 85th percentile of the whole tensor), the
    percentile by linear interpolation (jnp.quantile's and torch's default);
    the threshold carries no gradient."""
    eps = torch.quantile(dist.detach().reshape(-1), EMA_CLIP)
    return torch.where(dist < eps, dist, 0.0).mean()


def _center_consistency(center, ema_center_aligned, scores):
    """Confidence-weighted bidirectional Chamfer with quantile clipping.

    Returns (loss, map_ind (B,K) teacher->student assignment, dist2_mask)."""
    dist1, ind1, dist2, ind2 = nn_distance(center, ema_center_aligned)
    # student scores indexed by the matched teacher index — reproduced from
    # mean_teacher_consistency_util.py:45-47
    dist1_mask = _take_rows(scores, ind1)
    dist2_mask = scores
    dist = dist1 * dist1_mask + dist2 * dist2_mask
    return _quantile_clip_mean(dist), ind2, dist2_mask


def _class_consistency(cls_scores, ema_cls_scores, map_ind, batchmean=False):
    """KL(student aligned || teacher), x2 (:99-111)."""
    logp = torch.log_softmax(cls_scores, dim=2)
    ema_p = torch.softmax(ema_cls_scores, dim=2)
    logp_aligned = _take_rows(logp, map_ind)
    kl = ema_p * (torch.log(torch.clamp_min(ema_p, 1e-12)) - logp_aligned)
    if batchmean:
        return 2.0 * kl.sum() / cls_scores.shape[0]
    return 2.0 * kl.mean()


def _decode_size(size_scores, size_residuals, mean_size_arr):
    """Box size of the argmax size class (first index on ties): its mean
    size plus its residual, the residual by a one-hot select."""
    cls = size_scores.argmax(-1)
    oh = cls[..., None] == torch.arange(size_residuals.shape[2],
                                        device=cls.device)
    res = torch.where(oh[..., None], size_residuals, 0.0).sum(dim=2)
    mean_sizes = torch.as_tensor(mean_size_arr, dtype=size_residuals.dtype,
                                 device=size_residuals.device)
    return mean_sizes[cls] + res


def _size_consistency(size, ema_size, map_ind, confidence):
    aligned = _take_rows(size, map_ind)
    dist = ((aligned - ema_size) ** 2).sum(dim=2) * confidence
    return _quantile_clip_mean(dist)


def _normal_consistency(normal, ema_normal, map_ind, confidence):
    aligned = _take_rows(normal, map_ind)
    cos = (aligned[..., :2] * ema_normal[..., :2]).sum(-1) / (
        torch.linalg.vector_norm(aligned[..., :2], dim=-1)
        * torch.linalg.vector_norm(ema_normal[..., :2], dim=-1) + 1e-8)
    dist = (1.0 - cos.abs()) * confidence
    return _quantile_clip_mean(dist)


def get_consistency_loss(ep: Dict, ema_ep: Dict, mean_size_arr,
                         num_layer: int = 6) -> Tuple[torch.Tensor, Dict]:
    """Total consistency loss over all prefixes (:201-270).

    `ep` must carry augmentation records flip_x_axis, flip_y_axis (B,),
    rot_mat (B,3,3), scale (B,). Returns (loss, stats of 0-d tensors).
    """
    flip_x, flip_y = ep["flip_x_axis"], ep["flip_y_axis"]
    rot_mat, scale = ep["rot_mat"], ep["scale"]
    prefixes = ["last_", "proposal_"] + [f"{i}head_"
                                         for i in range(num_layer - 1)]

    obj_sum = quad_sum = 0.0
    obj_center_s = obj_class_s = obj_size_s = 0.0
    q_center_s = q_class_s = q_normal_s = q_size_s = 0.0
    for prefix in prefixes:
        # objects
        ema_center = _align_ema_centers(ema_ep[f"{prefix}center"], flip_x,
                                        flip_y, rot_mat, scale)
        scores = torch.softmax(ep[f"{prefix}objectness_scores"], dim=2)[..., 1]
        center_c, map_ind, conf = _center_consistency(
            ep[f"{prefix}center"], ema_center, scores)
        class_c = _class_consistency(ep[f"{prefix}sem_cls_scores"],
                                     ema_ep[f"{prefix}sem_cls_scores"], map_ind)
        size = _decode_size(ep[f"{prefix}size_scores"],
                            ep[f"{prefix}size_residuals"], mean_size_arr)
        ema_size = _decode_size(ema_ep[f"{prefix}size_scores"],
                                ema_ep[f"{prefix}size_residuals"],
                                mean_size_arr)
        ema_size = ema_size * scale[:, None, None]
        size_c = _size_consistency(size, ema_size, map_ind, conf)
        obj_center_s = obj_center_s + center_c
        obj_class_s = obj_class_s + class_c
        obj_size_s = obj_size_s + size_c
        obj_sum = obj_sum + (0.5 * center_c + 1.0 * class_c + 0.05 * size_c)

        # quads
        ema_qcenter = _align_ema_centers(ema_ep[f"{prefix}quad_center"],
                                         flip_x, flip_y, rot_mat, scale)
        qscores = torch.softmax(ep[f"{prefix}quad_scores"], dim=2)[..., 1]
        qcenter_c, qmap_ind, qconf = _center_consistency(
            ep[f"{prefix}quad_center"], ema_qcenter, qscores)
        qclass_c = _class_consistency(ep[f"{prefix}quad_scores"],
                                      ema_ep[f"{prefix}quad_scores"], qmap_ind,
                                      batchmean=True)
        qnormal_c = _normal_consistency(ep[f"{prefix}normal_vector"],
                                        ema_ep[f"{prefix}normal_vector"],
                                        qmap_ind, qconf)
        qsize_c = _size_consistency(ep[f"{prefix}quad_size"],
                                    ema_ep[f"{prefix}quad_size"], qmap_ind,
                                    qconf)
        q_center_s = q_center_s + qcenter_c
        q_class_s = q_class_s + qclass_c
        q_normal_s = q_normal_s + qnormal_c
        q_size_s = q_size_s + qsize_c
        quad_sum = quad_sum + (0.5 * qcenter_c + 0.0 * qclass_c
                               + 1.0 * qnormal_c + 0.05 * qsize_c)

    n = float(len(prefixes))
    stats = {
        "center_consistency_loss": obj_center_s / n,
        "class_consistency_loss": obj_class_s / n,
        "size_consistency_loss": obj_size_s / n,
        "consistency_loss": obj_sum / n,
        "quad_center_consistency_loss_sum": q_center_s / n,
        "quad_class_consistency_loss_sum": q_class_s / n,
        "quad_normal_consistency_loss_sum": q_normal_s / n,
        "quad_size_consistency_loss_sum": q_size_s / n,
        "quad_consistency_loss_sum": quad_sum / n,
    }
    return obj_sum / n + quad_sum / n, stats
