"""Object-detection prediction/GT parsing (host numpy).

The port's own copy of `omni_pq_tpu/evals/objects.py`.

Rebuilds models/ap_helper_pq.py:75-267 — box decoding (class2size +
residual), upright-camera corner generation, the three NMS variants, and the
per-class-proposal expansion. Quirk reproduced: object confidence uses
SIGMOID of the objectness logit (:141-142) while quads use softmax.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .box_ops import flip_axis_to_camera, flip_axis_to_depth, get_3d_box_batch
from .nms import nms_2d_faster, nms_3d_faster, nms_3d_faster_samecls
from .quad import softmax


def _corners_batch(dataset_config, cls_arr, res_arr, heading_cls, heading_res,
                   center_cam):
    """Batched box decode + corner generation."""
    angles = dataset_config.class2angle_batch(heading_cls, heading_res)
    sizes = dataset_config.class2size_batch(cls_arr, res_arr)
    return get_3d_box_batch(sizes, angles, center_cam)


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def parse_predictions(ep: Dict, config_dict: Dict, prefix: str = ""):
    """end_points -> (batch_pred_map_cls, pred_mask)."""
    dataset_config = config_dict["dataset_config"]
    pred_center = np.asarray(ep[f"{prefix}center"])
    heading_scores = np.asarray(ep[f"{prefix}heading_scores"])
    heading_residuals = np.asarray(ep[f"{prefix}heading_residuals"])
    size_scores = np.asarray(ep[f"{prefix}size_scores"])
    size_residuals = np.asarray(ep[f"{prefix}size_residuals"])
    sem_scores = np.asarray(ep[f"{prefix}sem_cls_scores"])
    obj_logits = np.asarray(ep[f"{prefix}objectness_scores"])

    bsize, K = pred_center.shape[:2]
    pred_heading_class = np.argmax(heading_scores, -1)
    pred_heading_residual = np.take_along_axis(
        heading_residuals, pred_heading_class[..., None], axis=2)[..., 0]
    pred_size_class = np.argmax(size_scores, -1)
    pred_size_residual = np.take_along_axis(
        size_residuals, pred_size_class[..., None, None].repeat(3, -1),
        axis=2)[:, :, 0]
    pred_sem_cls = np.argmax(sem_scores, -1)
    sem_cls_probs = softmax(sem_scores)
    obj_prob = sigmoid(obj_logits)[:, :, 1]

    center_cam = flip_axis_to_camera(pred_center)
    corners = _corners_batch(dataset_config, pred_size_class,
                             pred_size_residual, pred_heading_class,
                             pred_heading_residual, center_cam)

    nonempty = np.ones((bsize, K))
    if config_dict.get("remove_empty_box", False):
        batch_pc = np.asarray(ep["point_clouds"])[:, :, 0:3]
        for i in range(bsize):
            for j in range(K):
                box3d = flip_axis_to_depth(corners[i, j])
                lo, hi = box3d.min(0), box3d.max(0)
                inside = np.all((batch_pc[i] >= lo) & (batch_pc[i] <= hi), axis=1)
                if inside.sum() < 5:
                    nonempty[i, j] = 0

    pred_mask = np.zeros((bsize, K))
    use_3d = config_dict.get("use_3d_nms", True)
    cls_nms = config_dict.get("cls_nms", True)
    old_type = config_dict.get("use_old_type_nms", False)
    nms_iou = config_dict.get("nms_iou", 0.25)
    for i in range(bsize):
        idx = np.where(nonempty[i] == 1)[0]
        if len(idx) == 0:
            continue
        mins = corners[i].min(axis=1)
        maxs = corners[i].max(axis=1)
        if not use_3d:
            boxes = np.zeros((K, 5))
            boxes[:, 0], boxes[:, 1] = mins[:, 0], mins[:, 2]
            boxes[:, 2], boxes[:, 3] = maxs[:, 0], maxs[:, 2]
            boxes[:, 4] = obj_prob[i]
            pick = nms_2d_faster(boxes[idx], nms_iou, old_type)
        elif not cls_nms:
            boxes = np.zeros((K, 7))
            boxes[:, :3], boxes[:, 3:6], boxes[:, 6] = mins, maxs, obj_prob[i]
            pick = nms_3d_faster(boxes[idx], nms_iou, old_type)
        else:
            boxes = np.zeros((K, 8))
            boxes[:, :3], boxes[:, 3:6], boxes[:, 6] = mins, maxs, obj_prob[i]
            boxes[:, 7] = pred_sem_cls[i]
            pick = nms_3d_faster_samecls(boxes[idx], nms_iou, old_type)
        if len(pick) > 0:
            pred_mask[i, idx[pick]] = 1

    conf_thresh = config_dict.get("conf_thresh", 0.0)
    batch_pred_map_cls = []
    for i in range(bsize):
        js = np.where((pred_mask[i] == 1) & (obj_prob[i] > conf_thresh))[0]
        ci = corners[i]
        if config_dict.get("per_class_proposal", True):
            cls_probs = sem_cls_probs[i, js] * obj_prob[i, js, None]  # (J, C)
            cur = []
            for ii in range(dataset_config.num_class):
                cur += [(ii, ci[j], p) for j, p in zip(js, cls_probs[:, ii])]
            batch_pred_map_cls.append(cur)
        else:
            batch_pred_map_cls.append(
                [(int(pred_sem_cls[i, j]), ci[j], obj_prob[i, j])
                 for j in js])
    return batch_pred_map_cls, pred_mask


def parse_groundtruths(ep: Dict, config_dict: Dict):
    """labels -> batch_gt_map_cls (ap_helper_pq.py:221-267)."""
    dataset_config = config_dict["dataset_config"]
    center_label = np.asarray(ep["center_label"])
    heading_class_label = np.asarray(ep["heading_class_label"])
    heading_residual_label = np.asarray(ep["heading_residual_label"])
    size_class_label = np.asarray(ep["size_class_label"])
    size_residual_label = np.asarray(ep["size_residual_label"])
    box_label_mask = np.asarray(ep["box_label_mask"])
    sem_cls_label = np.asarray(ep["sem_cls_label"])
    bsize, K2 = center_label.shape[:2]

    center_cam = flip_axis_to_camera(center_label[:, :, 0:3])
    # masked (padding) rows may carry arbitrary class ids — substitute class
    # 0 before the batched decode, then zero them like the skipped rows of
    # the reference's loop form
    safe_cls = np.where(box_label_mask == 0, 0,
                        size_class_label).astype(np.int64)
    corners = _corners_batch(dataset_config, safe_cls,
                             size_residual_label, heading_class_label,
                             heading_residual_label, center_cam)
    corners = np.where(box_label_mask[..., None, None] == 0, 0.0, corners)

    batch_gt_map_cls = []
    for i in range(bsize):
        batch_gt_map_cls.append(
            [(int(sem_cls_label[i, j]), corners[i, j]) for j in range(K2)
             if box_label_mask[i, j] == 1])
    return batch_gt_map_cls
