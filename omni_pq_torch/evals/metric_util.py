"""Secondary precision/recall helpers (utils/metric_util.py parity).

The port's own copy of `omni_pq_tpu/evals/metric_util.py`.

Class-agnostic greedy matching of axis-aligned (cx,cy,cz,dx,dy,dz[,conf])
boxes at an IoU threshold (metric_util.py:27-120) — mostly unused by the
reference's main path but part of its API surface. The trimesh mesh-IO
helpers of that file are debug-only and intentionally not ported.
"""
from __future__ import annotations

import numpy as np


def calc_iou(box_a, box_b):
    """Axis-aligned 3D IoU of (cx,cy,cz,dx,dy,dz) boxes (metric_util.py)."""
    box_a, box_b = np.asarray(box_a, float), np.asarray(box_b, float)
    a_lo, a_hi = box_a[0:3] - box_a[3:6] / 2, box_a[0:3] + box_a[3:6] / 2
    b_lo, b_hi = box_b[0:3] - box_b[3:6] / 2, box_b[0:3] + box_b[3:6] / 2
    inter = np.prod(np.maximum(0.0, np.minimum(a_hi, b_hi)
                               - np.maximum(a_lo, b_lo)))
    vol_a = np.prod(box_a[3:6])
    vol_b = np.prod(box_b[3:6])
    union = vol_a + vol_b - inter
    return inter / union if union > 0 else 0.0


def single_scene_precision_recall(labels, pred, iou_thresh, conf_thresh):
    """Greedy class-agnostic TP/FP/FN for one scene. labels (N,6),
    pred (M,7) with conf in the last column."""
    pred = np.asarray(pred)
    labels = np.asarray(labels)
    if pred.shape[0] > 0 and pred.shape[1] >= 7:
        pred = pred[pred[:, 6] >= conf_thresh, :6]
    matched = np.zeros(len(labels), bool)
    TP = 0
    for p in pred:
        best, bj = 0.0, -1
        for j, g in enumerate(labels):
            if matched[j]:
                continue
            iou = calc_iou(p[:6], g[:6])
            if iou > best:
                best, bj = iou, j
        if best >= iou_thresh:
            TP += 1
            matched[bj] = True
    FP = len(pred) - TP
    FN = len(labels) - TP
    return TP, FP, FN


def multi_scene_precision_recall(labels, pred, iou_thresh, conf_thresh,
                                 label_mask=None, pred_mask=None):
    """Batched variant; masks select which boxes to consider."""
    labels, pred = np.asarray(labels), np.asarray(pred)
    if label_mask is None:
        label_mask = np.ones(labels.shape[:2])
    if pred_mask is None:
        pred_mask = np.ones(pred.shape[:2])
    TP = FP = FN = 0
    for b in range(labels.shape[0]):
        tp, fp, fn = single_scene_precision_recall(
            labels[b][label_mask[b] == 1], pred[b][pred_mask[b] == 1],
            iou_thresh, conf_thresh)
        TP += tp
        FP += fp
        FN += fn
    return TP, FP, FN, precision_recall(TP, FP, FN)


def precision_recall(TP, FP, FN):
    """(precision, recall), 0 where a denominator is 0."""
    p = TP / (TP + FP) if TP + FP > 0 else 0.0
    r = TP / (TP + FN) if TP + FN > 0 else 0.0
    return p, r
