"""Greedy axis-aligned NMS (host numpy; the port's own copy of
`omni_pq_tpu/evals/nms.py`), matching utils/nms.py semantics:
score-descending greedy pick, suppress by (old-type: inter/area_j, else
IoU) > threshold; samecls variant only suppresses same-class pairs."""
from __future__ import annotations

import numpy as np


def _nms(mins, maxs, score, overlap_threshold, old_type, cls=None):
    """Alive-mask formulation of the reference's delete-loop (utils/nms.py):
    identical greedy pick sequence — both sides call the same default
    np.argsort(score) (the reference picks I[-1] repeatedly, this picks the
    reversed order front-to-back), so ties resolve identically whatever the
    sort kind — but suppression flips a boolean instead of reallocating the
    index array (np.delete per pick measured ~10x slower at 256 proposals)."""
    n = score.shape[0]
    area = np.prod(maxs - mins, axis=1)
    # == picking order[-1] of an ascending stable argsort repeatedly
    order = np.argsort(score)[::-1]
    mins_o, maxs_o, area_o = mins[order], maxs[order], area[order]
    cls_o = cls[order] if cls is not None else None
    alive = np.ones(n, dtype=bool)
    pick = []
    if n <= 1024:
        # one vectorized pairwise-overlap matrix, then a boolean greedy
        # loop; per-axis 2-D ops avoid the (n, n, 3) broadcast temporaries
        inter = None
        for ax in range(mins.shape[1]):
            lo = np.maximum(mins_o[:, ax, None], mins_o[None, :, ax])
            hi = np.minimum(maxs_o[:, ax, None], maxs_o[None, :, ax])
            np.subtract(hi, lo, out=hi)
            d = np.maximum(hi, 0.0, out=hi)
            if inter is None:
                inter = d
            else:
                inter *= d
        with np.errstate(divide="ignore", invalid="ignore"):
            if old_type:
                o = inter / area_o[None, :]
            else:
                o = inter / (area_o[:, None] + area_o[None, :] - inter)
        if cls_o is not None:
            o = o * (cls_o[:, None] == cls_o[None, :])
        # keep[k] = rows NOT suppressed by k; a pick may only suppress
        # LATER (lower-scoring) rows, so the lower triangle + diagonal are
        # forced True — each loop iteration is then one in-place row AND
        keep = ~(o > overlap_threshold)
        keep |= np.tri(n, dtype=bool)
        for k in range(n):
            if alive[k]:
                pick.append(int(order[k]))
                np.logical_and(alive, keep[k], out=alive)
        return pick
    for k in range(n):
        if not alive[k]:
            continue
        pick.append(int(order[k]))
        lo = np.maximum(mins_o[k], mins_o[k + 1:])
        hi = np.minimum(maxs_o[k], maxs_o[k + 1:])
        inter = np.prod(np.maximum(0.0, hi - lo), axis=1)
        if old_type:
            o = inter / area_o[k + 1:]
        else:
            o = inter / (area_o[k] + area_o[k + 1:] - inter)
        if cls_o is not None:
            o = o * (cls_o[k + 1:] == cls_o[k])
        alive[k + 1:] &= ~(o > overlap_threshold)
    return pick


def nms_2d_faster(boxes, overlap_threshold, old_type=False):
    """boxes (n,5): x1,y1,x2,y2,score."""
    return _nms(boxes[:, [0, 1]], boxes[:, [2, 3]], boxes[:, 4],
                overlap_threshold, old_type)


def nms_3d_faster(boxes, overlap_threshold, old_type=False):
    """boxes (n,7): x1,y1,z1,x2,y2,z2,score."""
    return _nms(boxes[:, :3], boxes[:, 3:6], boxes[:, 6],
                overlap_threshold, old_type)


def nms_3d_faster_samecls(boxes, overlap_threshold, old_type=False):
    """boxes (n,8): x1,y1,z1,x2,y2,z2,score,cls."""
    return _nms(boxes[:, :3], boxes[:, 3:6], boxes[:, 6],
                overlap_threshold, old_type, cls=boxes[:, 7])
