"""Box geometry for evaluation: corner generation and oriented 3D IoU.

The port's own copy of `omni_pq_tpu/evals/box_ops.py`.

Host-side numpy, semantically matching the reference (SURVEY.md §5: metrics
stay host-side, numerically matching):
  - flip_axis_to_camera / get_3d_box / get_3d_box_batch:
    models/ap_helper_pq.py:26-33,
    utils/box_util.py:218-234 (corners in "upright camera" frame, y up
    negated)
  - polygon_clip / convex_hull_intersection / box3d_iou:
    utils/box_util.py:16-117 (Sutherland-Hodgman clipping; IoU of oriented
    boxes via BEV polygon intersection x vertical overlap)
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import ConvexHull


def flip_axis_to_camera(pc: np.ndarray) -> np.ndarray:
    """X-right,Y-forward,Z-up -> X-right,Y-down,Z-forward."""
    pc2 = np.copy(pc)
    pc2[..., [0, 1, 2]] = pc2[..., [0, 2, 1]]
    pc2[..., 1] *= -1
    return pc2


def flip_axis_to_depth(pc: np.ndarray) -> np.ndarray:
    pc2 = np.copy(pc)
    pc2[..., [0, 1, 2]] = pc2[..., [0, 2, 1]]
    pc2[..., 2] *= -1
    return pc2


def roty(t: float) -> np.ndarray:
    """Rotation about the y axis (the camera frame's up axis)."""
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def get_3d_box(box_size, heading_angle, center) -> np.ndarray:
    """(l,w,h), heading (clockwise from +x), center -> (8,3) corners.

    Corner order: top face 0-3 (y=+h/2), bottom face 4-7, counter-clockwise
    in BEV — the order box3d_iou depends on."""
    R = roty(heading_angle)
    l, w, h = box_size
    x = np.array([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2])
    y = np.array([h / 2, h / 2, h / 2, h / 2, -h / 2, -h / 2, -h / 2, -h / 2])
    z = np.array([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2])
    corners = R @ np.vstack([x, y, z])
    corners += np.asarray(center).reshape(3, 1)
    return corners.T


def get_3d_box_batch(box_size, heading_angle, center) -> np.ndarray:
    """Vectorized corner generation: (..., 3), (...), (..., 3) -> (..., 8, 3).

    Corners of every box at once (the reference's batched variant:
    utils/box_util.py:245-270 get_3d_box_batch_tensor), in float64 like the
    reference's scalar get_3d_box (its rotation matrix is float64).
    Corner order: top face 0-3, bottom face 4-7, counter-clockwise in BEV —
    the order box3d_iou depends on."""
    box_size = np.asarray(box_size, dtype=np.float64)
    heading_angle = np.asarray(heading_angle, dtype=np.float64)
    center = np.asarray(center, dtype=np.float64)
    l, w, h = box_size[..., 0], box_size[..., 1], box_size[..., 2]
    sgn_x = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float64)
    sgn_y = np.array([1, 1, 1, 1, -1, -1, -1, -1], np.float64)
    sgn_z = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float64)
    x = (l / 2)[..., None] * sgn_x
    y = (h / 2)[..., None] * sgn_y
    z = (w / 2)[..., None] * sgn_z
    c = np.cos(heading_angle)[..., None]
    s = np.sin(heading_angle)[..., None]
    # roty: cx = c*x + s*z; cy = y; cz = -s*x + c*z
    corners = np.stack([c * x + s * z, y, -s * x + c * z], axis=-1)
    return corners + center[..., None, :]


def poly_area(x, y) -> float:
    return 0.5 * np.abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def polygon_clip(subject, clip):
    """Sutherland-Hodgman clipping; both polygons CCW, clip convex. Returns
    vertex list or None if the intersection is empty."""
    def inside(p, cp1, cp2):
        return (cp2[0] - cp1[0]) * (p[1] - cp1[1]) > (cp2[1] - cp1[1]) * (p[0] - cp1[0])

    def intersection(cp1, cp2, s, e):
        dc = (cp1[0] - cp2[0], cp1[1] - cp2[1])
        dp = (s[0] - e[0], s[1] - e[1])
        n1 = cp1[0] * cp2[1] - cp1[1] * cp2[0]
        n2 = s[0] * e[1] - s[1] * e[0]
        n3 = 1.0 / (dc[0] * dp[1] - dc[1] * dp[0])
        return [(n1 * dp[0] - n2 * dc[0]) * n3, (n1 * dp[1] - n2 * dc[1]) * n3]

    output = list(subject)
    cp1 = clip[-1]
    for cp2 in clip:
        input_list = output
        output = []
        if not input_list:
            return None
        s = input_list[-1]
        for e in input_list:
            if inside(e, cp1, cp2):
                if not inside(s, cp1, cp2):
                    output.append(intersection(cp1, cp2, s, e))
                output.append(e)
            elif inside(s, cp1, cp2):
                output.append(intersection(cp1, cp2, s, e))
            s = e
        cp1 = cp2
        if len(output) == 0:
            return None
    return output


def convex_hull_intersection(p1, p2):
    inter = polygon_clip(p1, p2)
    if inter is not None:
        try:
            hull = ConvexHull(inter)
            return inter, hull.volume
        except Exception:
            return None, 0.0
    return None, 0.0


def box3d_vol(corners: np.ndarray) -> float:
    a = np.sqrt(np.sum((corners[0] - corners[1]) ** 2))
    b = np.sqrt(np.sum((corners[1] - corners[2]) ** 2))
    c = np.sqrt(np.sum((corners[0] - corners[4]) ** 2))
    return a * b * c


def box3d_iou(corners1: np.ndarray, corners2: np.ndarray):
    """Oriented 3D IoU of two (8,3) corner boxes in camera frame (y up is
    negative): BEV polygon intersection x vertical overlap."""
    rect1 = [(corners1[i, 0], corners1[i, 2]) for i in range(3, -1, -1)]
    rect2 = [(corners2[i, 0], corners2[i, 2]) for i in range(3, -1, -1)]
    area1 = poly_area(np.array(rect1)[:, 0], np.array(rect1)[:, 1])
    area2 = poly_area(np.array(rect2)[:, 0], np.array(rect2)[:, 1])
    _, inter_area = convex_hull_intersection(rect1, rect2)
    iou_2d = inter_area / max(area1 + area2 - inter_area, 1e-12)
    ymax = min(corners1[0, 1], corners2[0, 1])
    ymin = max(corners1[4, 1], corners2[4, 1])
    inter_vol = inter_area * max(0.0, ymax - ymin)
    vol1, vol2 = box3d_vol(corners1), box3d_vol(corners2)
    iou = inter_vol / max(vol1 + vol2 - inter_vol, 1e-12)
    return iou, iou_2d


def get_iou_obb(bb1, bb2) -> float:
    # exact early-out: when the axis-aligned hulls are disjoint in BEV x/z
    # or in y, the oriented 3D IoU is exactly 0 — skips the ConvexHull
    # clipping for the vast majority of pred/gt pairs (measured ~10x on the
    # full AP pass, TUNING.md)
    if (bb1[:, 0].min() >= bb2[:, 0].max()
            or bb2[:, 0].min() >= bb1[:, 0].max()
            or bb1[:, 2].min() >= bb2[:, 2].max()
            or bb2[:, 2].min() >= bb1[:, 2].max()
            or min(bb1[0, 1], bb2[0, 1]) <= max(bb1[4, 1], bb2[4, 1])):
        return 0.0
    return box3d_iou(bb1, bb2)[0]
