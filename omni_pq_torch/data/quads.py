"""Layout-quad GT extraction from SceneCAD plane annotations.

The port's own copy of `omni_pq_tpu/data/quads.py`.

Rebuilds scannet/scannet_planes.py: LSQ plane fit with vertical fallback
(get_normal:28-58 — note its `center` argument is unused in the reference
too; the normal sign is whatever the fit produces), rectangle
parameterization (:60-95), and get_quads (:118-155): json verts (y/z swap) ->
axis-align transform -> keep 4-vertex planar quads -> split vertical
(|n_z|<0.2) vs horizontal (|n_z|>0.8).
"""
from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np


def four_points_in_same_plane(p0, p1, p2, p3, error) -> bool:
    s1, s2, s3 = p1 - p0, p2 - p0, p3 - p0
    det = (s1[0] * s2[1] * s3[2] + s1[1] * s2[2] * s3[0]
           + s1[2] * s2[0] * s3[1] - s1[2] * s2[1] * s3[0]
           - s1[0] * s2[2] * s3[1] - s1[1] * s2[0] * s3[2])
    return -error <= det <= error


def get_normal(quad_vert: np.ndarray) -> np.ndarray:
    """LSQ plane fit z = px+qy+r -> unit normal; vertical fallback fits
    ax+by+1=0 when the system is singular."""
    A = np.concatenate([quad_vert[:, 0:2], np.ones((4, 1))], axis=1)
    b = quad_vert[:, 2:3]
    AtA = A.T @ A
    if np.linalg.det(AtA) > 1e-10:
        fit = np.linalg.solve(AtA, A.T @ b).ravel()
        normal = np.array([fit[0] / fit[2], fit[1] / fit[2], -1.0 / fit[2]])
    else:
        # vertical fallback; pinv also covers planes through the origin (the
        # reference's matrix inverse would raise there)
        A2 = A[:, 0:2]
        b2 = -np.ones((4, 1))
        fit = (np.linalg.pinv(A2.T @ A2) @ (A2.T @ b2)).ravel()
        if np.linalg.norm(fit) < 1e-12:
            # ax+by+1=0 unsolvable (plane through origin): direction from the
            # in-plane edges instead
            e1 = quad_vert[1] - quad_vert[0]
            e2 = quad_vert[2] - quad_vert[0]
            n = np.cross(e1, e2)
            fit = n[0:2] / max(np.linalg.norm(n[0:2]), 1e-12)
        normal = np.array([fit[0], fit[1], 0.0])
    return normal / np.linalg.norm(normal)


def rectangle(quad_vert: np.ndarray) -> np.ndarray:
    """4 vertices -> (center(3), vertical unit normal(3), w, h)."""
    center = np.mean(quad_vert, axis=0)
    normal = get_normal(quad_vert)
    vn = np.array([normal[0], normal[1], 0.0])
    vn = vn / np.linalg.norm(vn)
    edge = quad_vert[0] - quad_vert[1]
    cos_theta = edge[2] / max(np.linalg.norm(edge), 1e-12)
    l1 = np.linalg.norm(quad_vert[0] - quad_vert[1])
    l2 = np.linalg.norm(quad_vert[1] - quad_vert[2])
    l3 = np.linalg.norm(quad_vert[2] - quad_vert[3])
    l4 = np.linalg.norm(quad_vert[3] - quad_vert[0])
    l5, l6 = (l1 + l3) / 2, (l2 + l4) / 2
    if abs(cos_theta) > 0.5:
        h, w = l5, l6
    else:
        h, w = l6, l5
    return np.concatenate([center, vn, [w], [h]])


def load_axis_align_matrix(meta_file: str) -> np.ndarray:
    for line in open(meta_file).readlines():
        if "axisAlignment" in line:
            vals = [float(x) for x in
                    line.rstrip().strip("axisAlignment = ").split(" ")]
            return np.array(vals).reshape(4, 4)
    return np.eye(4)


def transform_verts(verts: np.ndarray, axis_align_matrix: np.ndarray) -> np.ndarray:
    pts = np.ones((verts.shape[0], 4))
    pts[:, 0:3] = verts[:, 0:3]
    return (pts @ axis_align_matrix.T)[:, 0:3]


def get_quads(planes_json_path: str, transform_meta_path: str = None
              ) -> Tuple[np.ndarray, int, np.ndarray]:
    """-> (vertical rectangles (M,8), total quad count, horizontal quads
    (K,4,3))."""
    with open(planes_json_path) as f:
        plane_dict = json.load(f)
    quad_dict = plane_dict["quads"]
    total = len(quad_dict)
    verts = np.array(plane_dict["verts"], dtype=np.float64)
    # json stores (x, z, -y); swap back (scannet_planes.py:124-129)
    verts = np.stack([verts[:, 0], -verts[:, 2], verts[:, 1]], axis=1)
    if transform_meta_path and os.path.exists(transform_meta_path):
        verts = transform_verts(verts, load_axis_align_matrix(transform_meta_path))

    quads = [q for q in quad_dict if len(q) == 4]
    quad_verts = np.asarray([[verts[j] for j in q] for q in quads])
    planar = [qv for qv in quad_verts
              if four_points_in_same_plane(qv[0], qv[1], qv[2], qv[3], 100)]
    vertical = [qv for qv in planar if abs(get_normal(qv)[2]) < 0.2]
    horizontal = np.asarray([qv for qv in planar if abs(get_normal(qv)[2]) > 0.8])
    rectangles = (np.array([rectangle(qv) for qv in vertical])
                  if vertical else np.zeros((0, 8)))
    return rectangles, total, horizontal


def arkit_quads_from_annotation(annotation_json_path: str, height: float = 2.0,
                                center_z: float = 1.0) -> np.ndarray:
    """ARKitScenes annotation boxes -> quads (ARKitScenes/
    arkitscenes_utils.py:11-47): width = max(dx,dy), normal along the thin
    axis, height/center_z supplied by the caller from z-percentiles."""
    with open(annotation_json_path) as f:
        js = json.load(f)
    data = js["labels"]
    if len(data) == 0:
        return np.zeros((0, 8))
    center = np.stack([[b["box3d"]["location"][k] for k in "xyz"]
                       for b in data])
    center[:, 2] = center_z
    dxyz = np.stack([[b["box3d"]["dimension"][k]
                      for k in ("width", "length", "height")] for b in data])
    width = np.max(dxyz[:, :2], axis=1)
    normal_dir = np.argmin(dxyz[:, :2], axis=1)[:, None]
    normal = (np.array([[1.0, 0, 0]]) * (1 - normal_dir)
              + np.array([[0, 1.0, 0]]) * normal_dir)
    size = np.stack([width, np.full(len(data), height)], axis=1)
    return np.concatenate([center, normal, size], axis=1)
