"""Synthetic room generator: reference-shaped batches with no data on disk.

The port's own copy of `make_scene` / `make_batch` / `SyntheticDataset`
from `omni_pq_tpu/data/synthetic.py`: the same seed gives the same scenes.

Generates rectangular rooms (4 walls + floor + ceiling) containing a few
axis-aligned objects, sampled into fixed-shape batches with exactly the
reference dataset's ~30 keys (scannet/scannet_detection_dataset.py:255-312 —
see SURVEY.md §3.4). The port's tests and chip_smoke.py use it, so nothing
needs ScanNet on disk.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..config import SCANNET_MEAN_SIZES
from .spatial import spatial_sort

MAX_NUM_OBJ = 64
MAX_NUM_QUAD = 32
NUM_PROPOSAL = 256
GT_VOTE_FACTOR = 3


def make_scene(rng: np.random.Generator, num_points: int = 40000,
               num_objects: int = 6, num_proposal: int = NUM_PROPOSAL,
               w_range=(3.0, 7.0), d_range=(3.0, 7.0),
               h_range=(2.2, 3.0)) -> Dict[str, np.ndarray]:
    """One synthetic scene with the full reference ret_dict key set.

    w/d/h_range control the room dimensions; defaults are ScanNet-like.
    Smaller rooms raise the density of FPS queries near wall centers, which
    is what the convergence tests use to guarantee positive assignments
    under the 0.3 m NEAR radius (loss_helper_pq.py:17)."""
    W = rng.uniform(*w_range)
    D = rng.uniform(*d_range)
    H = rng.uniform(*h_range)
    cx, cy = rng.uniform(1.0, 2.0, 2)  # keep room away from the origin

    # quads: 4 walls, normals pointing inward
    walls = [
        # (center, normal, width)
        (np.array([cx, cy - D / 2, H / 2]), np.array([0.0, 1.0, 0.0]), W),
        (np.array([cx, cy + D / 2, H / 2]), np.array([0.0, -1.0, 0.0]), W),
        (np.array([cx - W / 2, cy, H / 2]), np.array([1.0, 0.0, 0.0]), D),
        (np.array([cx + W / 2, cy, H / 2]), np.array([-1.0, 0.0, 0.0]), D),
    ]
    quad_centers = np.stack([w[0] for w in walls])
    quad_normals = np.stack([w[1] for w in walls])
    quad_sizes = np.stack([[w[2], H] for w in walls])

    # horizontal quads: floor + ceiling corner lists (4,3) each
    corners_xy = np.array([[cx - W / 2, cy - D / 2], [cx + W / 2, cy - D / 2],
                           [cx + W / 2, cy + D / 2], [cx - W / 2, cy + D / 2]])
    floor = np.concatenate([corners_xy, np.zeros((4, 1))], axis=1)
    ceiling = np.concatenate([corners_xy, np.full((4, 1), H)], axis=1)

    # objects: axis-aligned boxes with class-consistent sizes
    n_obj = int(rng.integers(2, num_objects + 1))
    obj_cls = rng.integers(0, 18, n_obj)
    obj_size = SCANNET_MEAN_SIZES[obj_cls] * rng.uniform(0.8, 1.2, (n_obj, 3))
    obj_center = np.stack([
        rng.uniform(cx - W / 2 + 0.5, cx + W / 2 - 0.5, n_obj),
        rng.uniform(cy - D / 2 + 0.5, cy + D / 2 - 0.5, n_obj),
        obj_size[:, 2] / 2,
    ], axis=1)

    # point sampling proportional to surface areas
    surfaces = []
    areas = []
    for (c, n, w), h in [(walls[i], H) for i in range(4)]:
        t = np.array([-n[1], n[0], 0.0])  # in-plane horizontal direction
        surfaces.append(("wall", c, n, t, w, h))
        areas.append(w * h)
    surfaces.append(("floor", np.array([cx, cy, 0.0]), np.array([0, 0, 1.0]),
                     None, W, D))
    areas.append(W * D)
    surfaces.append(("ceil", np.array([cx, cy, H]), np.array([0, 0, -1.0]),
                     None, W, D))
    areas.append(W * D)
    for i in range(n_obj):
        surfaces.append(("box", obj_center[i], None, None, i, None))
        areas.append(2.0 * (obj_size[i, 0] * obj_size[i, 1]
                            + obj_size[i, 1] * obj_size[i, 2]
                            + obj_size[i, 0] * obj_size[i, 2]))
    areas = np.array(areas)
    counts = rng.multinomial(num_points, areas / areas.sum())

    pts, nrm, inst, sem = [], [], [], []
    for (kind, c, n, t, a, b), cnt in zip(surfaces, counts):
        if cnt == 0:
            continue
        if kind == "wall":
            u = rng.uniform(-a / 2, a / 2, cnt)
            v = rng.uniform(0, b, cnt)
            p = c[None] + u[:, None] * t[None] + v[:, None] * np.array([0, 0, 1.0])
            p[:, 2] = v
            pts.append(p)
            nrm.append(np.tile(n, (cnt, 1)))
            inst.append(np.full(cnt, -1))
            sem.append(np.full(cnt, 0))
        elif kind in ("floor", "ceil"):
            p = np.stack([rng.uniform(c[0] - a / 2, c[0] + a / 2, cnt),
                          rng.uniform(c[1] - b / 2, c[1] + b / 2, cnt),
                          np.full(cnt, c[2])], axis=1)
            pts.append(p)
            nrm.append(np.tile(n, (cnt, 1)))
            inst.append(np.full(cnt, -1))
            sem.append(np.full(cnt, 0))
        else:  # box surface: jitter around the box
            i = a
            p = obj_center[i][None] + rng.uniform(-0.5, 0.5, (cnt, 3)) * obj_size[i][None]
            pts.append(p)
            v = rng.normal(size=(cnt, 3))
            nrm.append(v / np.linalg.norm(v, axis=1, keepdims=True))
            inst.append(np.full(cnt, i))
            sem.append(np.full(cnt, obj_cls[i]))
    point_cloud = np.concatenate(pts)[:num_points]
    normals = np.concatenate(nrm)[:num_points]
    instance = np.concatenate(inst)[:num_points]
    # pad if multinomial trimming undershot (shouldn't, but be safe)
    if point_cloud.shape[0] < num_points:
        pad = num_points - point_cloud.shape[0]
        point_cloud = np.concatenate([point_cloud, point_cloud[:pad]])
        normals = np.concatenate([normals, normals[:pad]])
        instance = np.concatenate([instance, instance[:pad]])
    # Morton order: spatially-coherent chunks for the ball-query bbox skip
    perm = spatial_sort(point_cloud)
    point_cloud, normals, instance = point_cloud[perm], normals[perm], instance[perm]

    # votes: box points vote to their instance center
    votes = np.zeros((num_points, 3))
    votes_mask = np.zeros(num_points)
    for i in range(n_obj):
        ind = instance == i
        votes[ind] = obj_center[i] - point_cloud[ind]
        votes_mask[ind] = 1.0
    votes = np.tile(votes, (1, GT_VOTE_FACTOR))

    # assemble fixed-shape labels
    center_label = np.zeros((MAX_NUM_OBJ, 3))
    center_label[n_obj:] += 1000.0  # padding far away, like the reference
    center_label[:n_obj] = obj_center
    size_class = np.zeros(MAX_NUM_OBJ, np.int64)
    size_class[:n_obj] = obj_cls
    size_res = np.zeros((MAX_NUM_OBJ, 3))
    size_res[:n_obj] = obj_size - SCANNET_MEAN_SIZES[obj_cls]
    sem_label = np.zeros(MAX_NUM_OBJ, np.int64)
    sem_label[:n_obj] = obj_cls
    box_mask = np.zeros(MAX_NUM_OBJ)
    box_mask[:n_obj] = 1.0
    size_gts = np.zeros((MAX_NUM_OBJ, 3))
    size_gts[:n_obj] = obj_size

    gt_quad_centers = np.zeros((MAX_NUM_QUAD, 3))
    gt_quad_centers[:4] = quad_centers
    gt_quad_sizes = np.zeros((MAX_NUM_QUAD, 2))
    gt_quad_sizes[:4] = quad_sizes
    gt_normal_vectors = np.zeros((MAX_NUM_QUAD, 3))
    gt_normal_vectors[:4] = quad_normals

    horizontal = np.zeros((4, 4, 3))
    horizontal[0] = ceiling
    horizontal[1] = floor

    # teacher view: an independent jittered resample, Morton-ordered
    ema_pc = point_cloud[rng.permutation(num_points)] \
        + rng.normal(scale=0.005, size=(num_points, 3))
    ema_pc = ema_pc[spatial_sort(ema_pc)]

    return {
        "point_clouds": point_cloud.astype(np.float32),
        "ema_point_clouds": ema_pc.astype(np.float32),
        "vertex_normals": normals.astype(np.float32),
        "center_label": center_label.astype(np.float32),
        "heading_class_label": np.zeros(MAX_NUM_OBJ, np.int64),
        "heading_residual_label": np.zeros(MAX_NUM_OBJ, np.float32),
        "size_class_label": size_class,
        "size_residual_label": size_res.astype(np.float32),
        "size_gts": size_gts.astype(np.float32),
        "size_label": size_gts.astype(np.float32),  # ARKit-style weak key
        "sem_cls_label": sem_label,
        "box_label_mask": box_mask.astype(np.float32),
        "num_gt_boxes": np.int64(n_obj),
        "vote_label": votes.astype(np.float32),
        "vote_label_mask": votes_mask.astype(np.int64),
        "gt_quad_centers": gt_quad_centers.astype(np.float32),
        "gt_quad_sizes": gt_quad_sizes.astype(np.float32),
        "gt_normal_vectors": gt_normal_vectors.astype(np.float32),
        "num_gt_quads": np.int64(4),
        "num_total_quads": np.int64(6),
        "horizontal_quads": horizontal.astype(np.float32),
        "flip_x_axis": np.int64(0),
        "flip_y_axis": np.int64(0),
        "rot_mat": np.eye(3, dtype=np.float32),
        "scale": np.float32(1.0),
        "use_gt": np.bool_(True),
    }


def make_batch(rng: np.random.Generator, batch_size: int = 2,
               num_points: int = 40000, **kw) -> Dict[str, np.ndarray]:
    scenes = [make_scene(rng, num_points, **kw) for _ in range(batch_size)]
    return {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}



class SyntheticDataset:
    """Map-style dataset of deterministic synthetic rooms (scene i is
    reproducible from seed+i, the same scene as the JAX package's
    SyntheticDataset gives): a stand-in for the ScanNet loader in smoke
    training without data on disk."""

    def __init__(self, n_scenes: int = 32, num_points: int = 40000,
                 seed: int = 0, **kw):
        self.n_scenes = n_scenes
        self.num_points = num_points
        self.seed = seed
        self.kw = kw

    def __len__(self):
        return self.n_scenes

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        s = make_scene(rng, self.num_points, **self.kw)
        s["scan_idx"] = np.int64(idx)
        return s
