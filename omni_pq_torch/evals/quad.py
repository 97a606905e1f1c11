"""Layout-quad prediction parsing and the quad-F1 metric (host numpy).

The port's own copy of `omni_pq_tpu/evals/quad.py`.

Rebuilds models/ap_helper_pq.py:270-517 (parse_quad_predictions /
parse_quad_groundtruths, get_verts, normal->heading decoding) and
QUADAPCalculator:579-736 (corner matching at SAME_THRES=0.40 in both vertex
orders, ceiling/floor synthesis from wall top/bottom corners). The
per-proposal Python loops of the reference are vectorized but numerically
identical; quirks reproduced on purpose:
  - quads become thin boxes of depth LENGTH=0.1 for NMS/AP (:383-385)
  - quad confidence is softmax (:402-404) for NMS/AP but the corner list used
    by F1 is gated at QUAD_THRES=0.5 on the same softmax prob
  - gt corner lists include `num_total_quads` entries (zero-padded beyond the
    vertical rectangles), inflating the F1 recall denominator exactly like
    the reference (:510-512)
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .box_ops import flip_axis_to_camera, get_3d_box_batch
from .nms import nms_3d_faster
from .ap import eval_det

MAX_NUM_QUAD = 32
LENGTH = 0.1
QUAD_THRES = 0.5
SAME_THRES = 0.40


def softmax(x):
    e = np.exp(x - np.max(x, axis=-1, keepdims=True))
    return e / np.sum(e, axis=-1, keepdims=True)


def heading_from_normal(normal: np.ndarray) -> np.ndarray:
    """(..., 3) normal -> heading angle (ap_helper_pq.py:367-378):
    arccos(cos(n, +y)), mirrored to 2pi-angle when cos(n, +x) > 0."""
    n = normal / np.maximum(np.linalg.norm(normal, axis=-1, keepdims=True), 1e-12)
    ang = np.arccos(np.clip(n[..., 1], -1.0, 1.0))
    return np.where(n[..., 0] > 0, 2 * np.pi - ang, ang)


def get_verts(center, width, height, normal) -> np.ndarray:
    """Quad -> 4 corners [(x1,y1,h+),(x2,y2,h+),(x1,y1,h-),(x2,y2,h-)]
    (ap_helper_pq.py:270-296)."""
    normal = np.asarray(normal, dtype=np.float64)
    normal = normal / max(np.linalg.norm(normal), 1e-6)
    cx, cy, cz = center
    x1 = cx + width * normal[1] / 2
    x2 = cx - width * normal[1] / 2
    y1 = cy - width * normal[0] / 2
    y2 = cy + width * normal[0] / 2
    h1, h2 = cz + height / 2, cz - height / 2
    return np.array([[x1, y1, h1], [x2, y2, h1], [x1, y1, h2], [x2, y2, h2]])


def get_verts_batch(center, width, height, normal) -> np.ndarray:
    """Quads -> corners: (..., 3), (...), (...), (..., 3) -> (..., 4, 3).
    Corners [(x1,y1,h+),(x2,y2,h+),(x1,y1,h-),(x2,y2,h-)] in float64, all
    proposals at once (the reference's get_verts, ap_helper_pq.py:270-296,
    called in its per-proposal loop, :323-458)."""
    center = np.asarray(center, dtype=np.float64)
    width = np.asarray(width, dtype=np.float64)
    height = np.asarray(height, dtype=np.float64)
    normal = np.asarray(normal, dtype=np.float64)
    norm = np.maximum(np.linalg.norm(normal, axis=-1, keepdims=True), 1e-6)
    n = normal / norm
    cx, cy, cz = center[..., 0], center[..., 1], center[..., 2]
    x1 = cx + width * n[..., 1] / 2
    x2 = cx - width * n[..., 1] / 2
    y1 = cy - width * n[..., 0] / 2
    y2 = cy + width * n[..., 0] / 2
    h1 = cz + height / 2
    h2 = cz - height / 2
    return np.stack([
        np.stack([x1, y1, h1], axis=-1), np.stack([x2, y2, h1], axis=-1),
        np.stack([x1, y1, h2], axis=-1), np.stack([x2, y2, h2], axis=-1),
    ], axis=-2)


def _quad_corners_8(center, size, normal):
    """Thin-box 8 corners in upright-camera frame for NMS/AP (batched)."""
    heading = heading_from_normal(normal)
    center_cam = flip_axis_to_camera(center)
    box_size = np.stack([size[..., 0], np.full(size.shape[:-1], LENGTH),
                         size[..., 1]], axis=-1)
    return get_3d_box_batch(box_size, heading, center_cam)


def parse_quad_predictions(ep: Dict, config_dict: Dict, prefix: str = ""):
    """end_points -> (batch_pred_map_cls, pred_mask, batch_pred_corners_list)
    (ap_helper_pq.py:323-458)."""
    pred_center = np.asarray(ep[f"{prefix}quad_center"])
    pred_size = np.asarray(ep[f"{prefix}quad_size"])
    normal = np.asarray(ep[f"{prefix}normal_vector"])
    quad_logits = np.asarray(ep[f"{prefix}quad_scores"])
    bsize, K = pred_center.shape[:2]
    obj_prob = softmax(quad_logits)[:, :, 1]

    nms_iou = config_dict.get("nms_iou_quad", config_dict.get("nms_iou", 0.25))
    conf_thresh = config_dict.get("conf_thresh", 0.0)
    old_type = config_dict.get("use_old_type_nms", False)

    pred_mask = np.zeros((bsize, K))
    corners8 = _quad_corners_8(pred_center, pred_size, normal)
    corners4 = get_verts_batch(pred_center, pred_size[..., 0],
                               pred_size[..., 1], normal)
    for i in range(bsize):
        boxes = np.zeros((K, 7))
        boxes[:, :3] = corners8[i].min(axis=1)
        boxes[:, 3:6] = corners8[i].max(axis=1)
        boxes[:, 6] = obj_prob[i]
        pick = nms_3d_faster(boxes, nms_iou, old_type)
        assert len(pick) > 0
        pred_mask[i, pick] = 1

    batch_pred_map_cls = []
    batch_pred_corners_list = []
    for i in range(bsize):
        batch_pred_map_cls.append(
            [(1, corners8[i, j], obj_prob[i, j]) for j in range(K)
             if pred_mask[i, j] == 1 and obj_prob[i, j] > conf_thresh])
        batch_pred_corners_list.append(
            [corners4[i, j] for j in range(K)
             if pred_mask[i, j] == 1 and obj_prob[i, j] > QUAD_THRES])
    return batch_pred_map_cls, pred_mask, batch_pred_corners_list


def parse_quad_groundtruths(ep: Dict, config_dict: Dict):
    """labels -> (batch_gt_map_cls, batch_gt_corners_list)
    (ap_helper_pq.py:461-517)."""
    center_label = np.asarray(ep["gt_quad_centers"])
    size_label = np.asarray(ep["gt_quad_sizes"])
    vector_label = np.asarray(ep["gt_normal_vectors"])
    num_gt_quads = np.asarray(ep["num_gt_quads"]).reshape(center_label.shape[0], -1)[:, 0]
    num_total_quads = np.asarray(ep["num_total_quads"]).reshape(center_label.shape[0], -1)[:, 0]
    bsize = center_label.shape[0]
    K2 = MAX_NUM_QUAD

    corners8 = _quad_corners_8(center_label[:, :K2], size_label[:, :K2],
                               vector_label[:, :K2])
    corners4 = get_verts_batch(center_label[:, :K2], size_label[:, :K2, 0],
                               size_label[:, :K2, 1], vector_label[:, :K2])
    batch_gt_map_cls = []
    batch_gt_corners_list = []
    for i in range(bsize):
        batch_gt_map_cls.append(
            [(1, corners8[i, j]) for j in range(K2) if j < num_gt_quads[i]])
        batch_gt_corners_list.append(
            [corners4[i, j] for j in range(K2) if j < num_total_quads[i]])
    return batch_gt_map_cls, batch_gt_corners_list


class QuadAPCalculator:
    """Quad AP + corner-matching F1 (ap_helper_pq.py:579-736)."""

    def __init__(self, ap_iou_thresh=0.25, class2type_map=None):
        self.ap_iou_thresh = ap_iou_thresh
        self.class2type_map = class2type_map
        self.reset()

    def reset(self):
        self.gt_map_cls = {}
        self.pred_map_cls = {}
        self.pred_corners = {}
        self.gt_corners = {}
        self.horizontal_corners = {}
        self.scan_cnt = 0

    def step(self, batch_pred_map_cls, batch_gt_map_cls,
             batch_pred_corners_list, batch_gt_corners_list,
             batch_gt_horizontal_list):
        for pred, gt, pc, gc, hz in zip(batch_pred_map_cls, batch_gt_map_cls,
                                        batch_pred_corners_list,
                                        batch_gt_corners_list,
                                        batch_gt_horizontal_list):
            self.gt_map_cls[self.scan_cnt] = gt
            self.pred_map_cls[self.scan_cnt] = pred
            self.pred_corners[self.scan_cnt] = pc
            self.gt_corners[self.scan_cnt] = gc
            self.horizontal_corners[self.scan_cnt] = np.asarray(hz)
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

    @staticmethod
    def _same_point(p, g):
        return np.linalg.norm(np.asarray(p) - np.asarray(g)) <= SAME_THRES

    @staticmethod
    def compute_correctness(pred_corner, all_gt):
        """True if the 4 corners match some gt quad within SAME_THRES in
        either vertex order ([0,1,2,3] or [1,0,3,2]) (:640-665). Vectorized
        over gts — same sqrt-norm comparisons as the reference's loops."""
        if len(all_gt) == 0:
            return False
        gts = np.asarray(all_gt, dtype=np.float64)       # (G, 4, 3)
        p = np.asarray(pred_corner, dtype=np.float64)    # (4, 3)
        d1 = np.sqrt(((p[None] - gts) ** 2).sum(-1))
        d2 = np.sqrt(((p[None] - gts[:, [1, 0, 3, 2]]) ** 2).sum(-1))
        ok1 = (d1 <= SAME_THRES).all(axis=1)
        ok2 = (d2 <= SAME_THRES).all(axis=1)
        return bool(np.any(ok1 | ok2))

    def _contain_point(self, pointlist, point):
        """First list entry within SAME_THRES of `point` (vectorized scan —
        the reference's linear _same_point loop, ap_helper_pq.py:667-671)."""
        if pointlist:
            a = np.asarray(pointlist, dtype=np.float64)
            d = np.sqrt(((a - np.asarray(point, dtype=np.float64)) ** 2)
                        .sum(axis=1))
            hits = np.nonzero(d <= SAME_THRES)[0]
            if hits.size:
                return True, pointlist[hits[0]]
        return False, None

    def get_ceiling_and_floor(self, pred_corners):
        """Synthesize ceiling/floor quads by merging wall top/bottom corners
        (:673-693). Same first-match/average semantics as _contain_point,
        with the list mirrored in a growing array (re-asarray per insertion
        was the F1 pass's dominant cost at 256 surviving proposals)."""
        def merge(points):
            out: List = []
            buf = np.empty((max(8, 2 * len(points)), 3), np.float64)
            n = 0
            for pt in points:
                pt = np.asarray(pt, dtype=np.float64)
                if n:
                    d = np.sqrt(((buf[:n] - pt) ** 2).sum(axis=1))
                    hits = np.nonzero(d <= SAME_THRES)[0]
                else:
                    hits = np.empty(0, np.int64)
                val = (out[hits[0]] + pt) / 2 if hits.size else pt
                out.append(val)
                if n == buf.shape[0]:
                    buf = np.concatenate([buf, np.empty_like(buf)])
                buf[n] = val
                n += 1
            return out

        tops = [qc[i] for qc in pred_corners for i in range(0, 2)]
        bottoms = [qc[i] for qc in pred_corners for i in range(2, 4)]
        return merge(tops), merge(bottoms)

    def compute_F1(self, calculated: bool = False):
        """Corner-matching F1 (:695-736); `calculated` additionally credits
        synthesized ceiling/floor quads against horizontal GT quads."""
        tp = fp = 0
        npos = sum(len(self.gt_corners[i]) for i in range(self.scan_cnt))
        for i in range(self.scan_cnt):
            all_pred = self.pred_corners[i]
            all_gt = self.gt_corners[i]
            horizontal = np.asarray(self.horizontal_corners[i])
            for pred_corner in all_pred:
                if self.compute_correctness(pred_corner, all_gt):
                    tp += 1
                else:
                    fp += 1
            if calculated:
                ceilings, floors = self.get_ceiling_and_floor(all_pred)
                if len(ceilings) == 4 and self.compute_correctness(ceilings, horizontal):
                    tp += 1
                if len(floors) == 4 and self.compute_correctness(floors, horizontal):
                    tp += 1
        p = tp / max(tp + fp, 1e-6)
        r = tp / max(npos, 1e-6)
        return 2.0 * p * r / max(p + r, 1e-6)
