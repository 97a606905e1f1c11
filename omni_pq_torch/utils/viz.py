"""Qualitative dump helpers: PLY point clouds and box/quad meshes.

The port's own copy of the PLY writers and result dumps of
`omni_pq_tpu/utils/viz.py` (numpy only): models/dump_helper.py:25-183,
models/dump_helper_quad.py:23-245 (quad OBB dumps,
DUMP_CONF_THRESH=0.995) and the relevant utils/pc_util.py writers
(:359-533) without the trimesh dependency — plain ASCII PLY is written
directly.
"""
from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from ..evals.box_ops import flip_axis_to_depth, get_3d_box_batch
from ..evals.quad import heading_from_normal, softmax

DUMP_CONF_THRESH = 0.995


def write_ply_points(points: np.ndarray, path: str,
                     colors: np.ndarray = None):
    """ASCII PLY point cloud."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i,0]:.6f} {points[i,1]:.6f} {points[i,2]:.6f}"
            if colors is not None:
                row += f" {int(colors[i,0])} {int(colors[i,1])} {int(colors[i,2])}"
            f.write(row + "\n")


def write_ply_boxes(corners_list: Sequence[np.ndarray], path: str):
    """List of (8,3) box corners -> ASCII PLY mesh (12 triangles per box) —
    the role of pc_util.write_oriented_bbox without trimesh."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    faces8 = [(0, 1, 2), (0, 2, 3), (4, 6, 5), (4, 7, 6),
              (0, 4, 5), (0, 5, 1), (1, 5, 6), (1, 6, 2),
              (2, 6, 7), (2, 7, 3), (3, 7, 4), (3, 4, 0)]
    verts, faces = [], []
    for bi, c in enumerate(corners_list):
        base = 8 * bi
        verts.extend(np.asarray(c).tolist())
        faces.extend([(base + a, base + b, base + d) for a, b, d in faces8])
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b, c_ in faces:
            f.write(f"3 {a} {b} {c_}\n")


def dump_quad_results(ep: Dict, dump_dir: str, prefix: str = "last_",
                      conf_thresh: float = DUMP_CONF_THRESH):
    """Predicted quads above conf -> thin-box PLYs per scene
    (dump_helper_quad.dump_results_quad:53-245)."""
    os.makedirs(dump_dir, exist_ok=True)
    centers = np.asarray(ep[f"{prefix}quad_center"])
    sizes = np.asarray(ep[f"{prefix}quad_size"])
    normals = np.asarray(ep[f"{prefix}normal_vector"])
    probs = softmax(np.asarray(ep[f"{prefix}quad_scores"]))[..., 1]
    B, K = centers.shape[:2]
    for i in range(B):
        boxes = []
        for j in range(K):
            if probs[i, j] <= conf_thresh:
                continue
            heading = heading_from_normal(normals[i, j])
            c_cam = np.array([centers[i, j, 0], centers[i, j, 2],
                              -centers[i, j, 1]])
            corners = get_3d_box_batch(
                np.array([sizes[i, j, 0], 0.1, sizes[i, j, 1]]), heading,
                c_cam)
            boxes.append(flip_axis_to_depth(corners))
        if boxes:
            write_ply_boxes(boxes, os.path.join(dump_dir, f"{i:03d}_pred_quads.ply"))


def dump_object_results(ep: Dict, config, dump_dir: str, prefix: str = "last_",
                        conf_thresh: float = 0.5):
    """Predicted object boxes above objectness conf -> PLYs per scene
    (dump_helper.dump_results:25-183)."""
    os.makedirs(dump_dir, exist_ok=True)
    centers = np.asarray(ep[f"{prefix}center"])
    size_scores = np.asarray(ep[f"{prefix}size_scores"])
    size_residuals = np.asarray(ep[f"{prefix}size_residuals"])
    obj = np.asarray(ep[f"{prefix}objectness_scores"])
    prob = 1.0 / (1.0 + np.exp(-obj))[..., 1]
    B, K = centers.shape[:2]
    for i in range(B):
        boxes = []
        for j in range(K):
            if prob[i, j] <= conf_thresh:
                continue
            cls = int(np.argmax(size_scores[i, j]))
            size = config.class2size_batch(cls, size_residuals[i, j, cls])
            c_cam = np.array([centers[i, j, 0], centers[i, j, 2],
                              -centers[i, j, 1]])
            boxes.append(flip_axis_to_depth(get_3d_box_batch(size, 0.0,
                                                             c_cam)))
        if boxes:
            write_ply_boxes(boxes, os.path.join(dump_dir, f"{i:03d}_pred_boxes.ply"))
