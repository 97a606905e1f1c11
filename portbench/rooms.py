"""The benchmark's rooms: a frozen copy of the port's synthetic room generator
(`omni_pq_torch/data/synthetic.py`: `make_scene`, `make_batch`) and of the
loaders' Morton order (`omni_pq_torch/data/spatial.py`: `spatial_sort`), at
commit 4c1c1dacbb14fd55b2b315e6b58815882cf32f9c. Kept here so that no later
change to the program moves the yardstick: the same seed gives the same
rooms on both sides of a check.

Rectangular rooms (4 walls, floor and ceiling) with a few axis-aligned
objects, 40 000 points a room by default, with the ScanNet loader's label
keys, put in Morton (z-order) order as the port's loaders give a cloud: the
ball query's chunk skip depends on that order.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

# the ScanNet class mean sizes (l, w, h) of the published scannet_means.npz
SCANNET_MEAN_SIZES = np.array([
    [0.76966726, 0.81160211, 0.92573741],
    [1.876858, 1.84255952, 1.19315654],
    [0.61327999, 0.61486087, 0.71827014],
    [1.39550063, 1.51215451, 0.83443565],
    [0.97949596, 1.06751485, 0.63296875],
    [0.53166301, 0.59555772, 1.75001483],
    [0.96247056, 0.72462326, 1.14818682],
    [0.83221924, 1.04909355, 1.68756634],
    [0.21132214, 0.4206159, 0.53728459],
    [1.44400728, 1.89708334, 0.26985747],
    [1.02942616, 1.40407966, 0.87554322],
    [1.37664116, 0.65521793, 1.68131292],
    [0.66508189, 0.71111926, 1.29885307],
    [0.41999174, 0.37906947, 1.75139715],
    [0.59359559, 0.59124924, 0.73919014],
    [0.50867595, 0.50656087, 0.30136236],
    [1.15115265, 1.0546296, 0.49706794],
    [0.47535286, 0.49249493, 0.58021168],
], dtype=np.float32)


def _spread_bits(v: np.ndarray) -> np.ndarray:
    """Insert two zero bits between each of the low 10 bits (for 3D Morton)."""
    v = v.astype(np.uint64) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_code(points: np.ndarray) -> np.ndarray:
    """(N,3) float points -> (N,) uint64 Morton codes (10 bits per axis)."""
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    scale = np.where(hi > lo, 1023.0 / (hi - lo), 0.0)
    q = np.clip(((points - lo) * scale), 0, 1023).astype(np.uint64)
    return (_spread_bits(q[:, 0]) | (_spread_bits(q[:, 1]) << 1)
            | (_spread_bits(q[:, 2]) << 2))


def spatial_sort(points: np.ndarray) -> np.ndarray:
    """(N,3+) points -> permutation putting them in Morton order."""
    return np.argsort(morton_code(points[:, :3]), kind="stable")


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
