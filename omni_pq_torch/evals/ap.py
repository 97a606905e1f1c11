"""VOC-style AP engine (host numpy; the port's own copy of
`omni_pq_tpu/evals/ap.py`), matching utils/eval_det.py: greedy
per-class matching at an IoU threshold, precision envelope AP. The reference
parallelizes per-class with a Pool(10) (eval_det.py:211-257); classes here are
evaluated with a thread pool (the work is numpy-bound, the pool keeps CLI
parity in spirit without fork overhead)."""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict

import numpy as np

from .box_ops import get_iou_obb


def voc_ap(rec, prec, use_07_metric=False):
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1])


def eval_det_cls(pred, gt, ovthresh=0.25, use_07_metric=False,
                 get_iou_func: Callable = get_iou_obb):
    """pred: {img_id: [(box, score)]}, gt: {img_id: [box]} for one class."""
    class_recs = {}
    npos = 0
    for img_id in gt:
        bbox = np.array(gt[img_id])
        class_recs[img_id] = {"bbox": bbox, "det": [False] * len(bbox)}
        npos += len(bbox)
    for img_id in pred:
        if img_id not in gt:
            class_recs[img_id] = {"bbox": np.array([]), "det": []}

    image_ids, confidence, BB = [], [], []
    for img_id in pred:
        for box, score in pred[img_id]:
            image_ids.append(img_id)
            confidence.append(score)
            BB.append(box)
    confidence = np.array(confidence)
    if len(BB) == 0:
        return np.zeros(0), np.zeros(0), 0.0
    BB = np.array(BB)
    sorted_ind = np.argsort(-confidence)
    BB = BB[sorted_ind]
    image_ids = [image_ids[i] for i in sorted_ind]

    nd = len(image_ids)
    tp, fp = np.zeros(nd), np.zeros(nd)
    for d in range(nd):
        R = class_recs[image_ids[d]]
        bb = BB[d].astype(float)
        ovmax, jmax = -np.inf, -1
        BBGT = R["bbox"].astype(float)
        if BBGT.size > 0:
            for j in range(BBGT.shape[0]):
                iou = get_iou_func(bb, BBGT[j])
                if iou > ovmax:
                    ovmax, jmax = iou, j
        if ovmax > ovthresh:
            if not R["det"][jmax]:
                tp[d] = 1.0
                R["det"][jmax] = True
            else:
                fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def eval_det(pred_all, gt_all, ovthresh=0.25, use_07_metric=False,
             get_iou_func: Callable = get_iou_obb, num_workers: int = 10):
    """pred_all: {img_id: [(cls, box, score)]}, gt_all: {img_id: [(cls, box)]}
    -> per-class (rec, prec, ap) dicts."""
    pred: Dict = {}
    gt: Dict = {}
    for img_id in pred_all:
        for cls, box, score in pred_all[img_id]:
            pred.setdefault(cls, {}).setdefault(img_id, []).append((box, score))
    for img_id in gt_all:
        for cls, box in gt_all[img_id]:
            gt.setdefault(cls, {}).setdefault(img_id, []).append(box)

    rec, prec, ap = {}, {}, {}
    classes = [c for c in gt.keys()]
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        results = list(pool.map(
            lambda c: eval_det_cls(pred.get(c, {}), gt[c], ovthresh,
                                   use_07_metric, get_iou_func), classes))
    for c, (r, p, a) in zip(classes, results):
        rec[c], prec[c], ap[c] = r, p, a
    return rec, prec, ap


class APCalculator:
    """Accumulates (pred, gt) per scan and computes mAP/AR
    (ap_helper_pq.py:520-575)."""

    def __init__(self, ap_iou_thresh=0.25, class2type_map=None):
        self.ap_iou_thresh = ap_iou_thresh
        self.class2type_map = class2type_map
        self.reset()

    def step(self, batch_pred_map_cls, batch_gt_map_cls):
        for pred, gt in zip(batch_pred_map_cls, batch_gt_map_cls):
            self.gt_map_cls[self.scan_cnt] = gt
            self.pred_map_cls[self.scan_cnt] = pred
            self.scan_cnt += 1

    def compute_metrics(self):
        rec, prec, ap = eval_det(self.pred_map_cls, self.gt_map_cls,
                                 ovthresh=self.ap_iou_thresh)
        ret = {}
        for key in sorted(ap.keys()):
            name = self.class2type_map[key] if self.class2type_map else str(key)
            ret[f"{name} Average Precision"] = ap[key]
        ret["mAP"] = np.mean(list(ap.values())) if ap else 0.0
        rec_list = []
        for key in sorted(ap.keys()):
            name = self.class2type_map[key] if self.class2type_map else str(key)
            r = rec[key][-1] if len(rec[key]) else 0
            ret[f"{name} Recall"] = r
            rec_list.append(r)
        ret["AR"] = np.mean(rec_list) if rec_list else 0.0
        return ret

    def reset(self):
        self.gt_map_cls = {}
        self.pred_map_cls = {}
        self.scan_cnt = 0
