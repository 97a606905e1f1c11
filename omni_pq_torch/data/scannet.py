"""ScanNet detection dataset: preprocessed .npy scenes -> fixed-shape numpy
dicts.

The port's own copy of `omni_pq_tpu/data/scannet.py`: the same seed gives
the same samples, sample by sample.

Rebuilds scannet/scannet_detection_dataset.py:36-312 against the same disk
layout:
    <root>/scannet_train_detection_data/<scan>_{vert,ins_label,sem_label,bbox}.npy
    <root>/scannet_train_detection_data_normals/<scan>.normal.npy
    <root>/scannet_planes/<scan>.json      (SceneCAD quads)
    <root>/scans_transform/<scan>/<scan>.txt (axisAlignment meta)
    <root>/meta_data/scannetv2_{train,val}.txt
Label-rate splits slice the sorted scan list by [start_proportion,
end_proportion) (:64-72). Student and teacher ("ema") views are two
independent random 40k downsamples of the same scene (:133-136). Augmentation
(flips, +-5deg + k*90deg z-rotation, 0.85-1.15 scale) matches :160-218 and is
recorded in flip/rot/scale keys for the consistency-loss un-augmentation; the
reference's training entry point constructs this dataset with augment=False
(train.py:223) — same default here. `reseed()` starts the dataset's draws
again from its seed (the train CLI's evaluation draws the same val clouds
in every pass).
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..config import SCANNET_MEAN_SIZES, SCANNET_NYU40_IDS
from ..native import compute_votes, morton_argsort
from .quads import get_quads

MAX_NUM_OBJ = 64
MAX_NUM_QUAD = 32
MEAN_COLOR_RGB = np.array([109.8, 97.2, 83.8])


def rotz(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def random_sampling(pc, num_sample, rng, return_choices=False):
    replace = pc.shape[0] < num_sample
    choices = rng.choice(pc.shape[0], num_sample, replace=replace)
    return (pc[choices], choices) if return_choices else pc[choices]


def rotate_aligned_boxes(boxes, rot_mat):
    """model_util_scannet.py:73-94 — rotate centers, recompute axis-aligned
    extents from rotated corners."""
    centers, lengths = boxes[:, 0:3], boxes[:, 3:6]
    new_centers = centers @ rot_mat.T
    dx, dy = lengths[:, 0] / 2.0, lengths[:, 1] / 2.0
    new_x = np.zeros((dx.shape[0], 4))
    new_y = np.zeros((dx.shape[0], 4))
    for i, (cx, cy) in enumerate([(-1, -1), (1, -1), (1, 1), (-1, 1)]):
        crnrs = np.zeros((dx.shape[0], 3))
        crnrs[:, 0] = cx * dx
        crnrs[:, 1] = cy * dy
        crnrs = crnrs @ rot_mat.T
        new_x[:, i] = crnrs[:, 0]
        new_y[:, i] = crnrs[:, 1]
    new_lengths = np.stack([2.0 * new_x.max(1), 2.0 * new_y.max(1),
                            lengths[:, 2]], axis=1)
    return np.concatenate([new_centers, new_lengths], axis=1)


def rotate_quad(rect, rot_mat):
    out = rect.copy()
    out[:, 0:3] = rect[:, 0:3] @ rot_mat.T
    out[:, 3:6] = rect[:, 3:6] @ rot_mat.T
    return out


class ScannetDetectionDataset:
    def __init__(self, data_root: str, split_set: str = "train",
                 num_points: int = 40000, use_color: bool = False,
                 use_height: bool = False, augment: bool = False,
                 start_proportion: float = 0.0, end_proportion: float = 1.0,
                 seed: int = 0):
        self.data_root = data_root
        self.data_path = os.path.join(data_root, "scannet_train_detection_data")
        self.normals_path = os.path.join(
            data_root, "scannet_train_detection_data_normals")
        self.planes_path = os.path.join(data_root, "scannet_planes")
        self.transform_path = os.path.join(data_root, "scans_transform")

        all_scan_names = sorted(set(
            os.path.basename(x)[0:12] for x in os.listdir(self.planes_path)
            if x.startswith("scene")))
        if split_set == "all":
            self.scan_names = list(all_scan_names)
        elif split_set in ("train", "val"):
            split_file = os.path.join(data_root, "meta_data",
                                      f"scannetv2_{split_set}.txt")
            with open(split_file) as f:
                names = f.read().splitlines()
            names = sorted(n for n in names if n in all_scan_names)
            bak = names
            self.start_idx = int(len(names) * start_proportion)
            self.end_idx = int(len(names) * end_proportion)
            names = names[self.start_idx:self.end_idx]
            if len(names) == 0:
                names = [bak[-1]]
            self.scan_names = names
        else:
            raise ValueError(f"illegal split {split_set}")
        self.num_points = num_points
        self.use_color = use_color
        self.use_height = use_height
        self.augment = augment
        self.start_proportion = start_proportion
        self.seed = seed
        self.reseed()

    def reseed(self):
        """Start the random draws (downsamples, augmentation) again from
        the dataset's seed."""
        self.rng = np.random.default_rng(self.seed)

    def __len__(self):
        return len(self.scan_names)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = self.rng
        scan_name = self.scan_names[idx]
        mesh_vertices = np.load(os.path.join(self.data_path, scan_name + "_vert.npy"))
        instance_labels = np.load(os.path.join(self.data_path, scan_name + "_ins_label.npy"))
        semantic_labels = np.load(os.path.join(self.data_path, scan_name + "_sem_label.npy"))
        instance_bboxes = np.load(os.path.join(self.data_path, scan_name + "_bbox.npy"))
        vertex_normals = np.load(os.path.join(self.normals_path, scan_name + ".normal.npy"))

        if not self.use_color:
            point_cloud = mesh_vertices[:, 0:3]
        else:
            point_cloud = mesh_vertices[:, 0:6].copy()
            point_cloud[:, 3:] = (point_cloud[:, 3:] - MEAN_COLOR_RGB) / 256.0
        if self.use_height:
            floor_height = np.percentile(point_cloud[:, 2], 0.99)
            height = point_cloud[:, 2] - floor_height
            point_cloud = np.concatenate(
                [point_cloud, height[:, None]], axis=1)

        target_bboxes = np.zeros((MAX_NUM_OBJ, 6))
        target_bboxes_mask = np.zeros(MAX_NUM_OBJ)
        size_classes = np.zeros(MAX_NUM_OBJ)
        size_residuals = np.zeros((MAX_NUM_OBJ, 3))
        size_gts = np.zeros((MAX_NUM_OBJ, 3))

        # two independent downsamples: teacher (ema) and student views;
        # both emitted in Morton order (see data/spatial.py)
        ema_point_clouds, _ = random_sampling(point_cloud, self.num_points,
                                              rng, return_choices=True)
        ema_point_clouds = ema_point_clouds[morton_argsort(ema_point_clouds)]
        point_cloud, choices = random_sampling(point_cloud, self.num_points,
                                               rng, return_choices=True)
        sperm = morton_argsort(point_cloud)
        point_cloud = point_cloud[sperm]
        choices = choices[sperm]
        instance_labels = instance_labels[choices]
        semantic_labels = semantic_labels[choices]
        vertex_normals = vertex_normals[choices]

        n_box = instance_bboxes.shape[0]
        target_bboxes_mask[:n_box] = 1
        target_bboxes[:n_box, :] = instance_bboxes[:, 0:6]

        rectangles, total_quad_num, horizontal_quads = get_quads(
            os.path.join(self.planes_path, scan_name + ".json"),
            os.path.join(self.transform_path, scan_name, scan_name + ".txt"))

        flip_YZ_XZ = np.array([False, False])
        rot_mat = np.identity(3)
        scale_ratio = np.array(1.0)
        if self.augment:
            if rng.random() > 0.5:
                flip_YZ_XZ[0] = True
                point_cloud[:, 0] *= -1
                target_bboxes[:, 0] *= -1
                vertex_normals[:, 0] *= -1
                if rectangles.shape[0] > 0:
                    rectangles[:, 0] *= -1
                    rectangles[:, 3] *= -1
                if horizontal_quads.shape[0] > 0:
                    horizontal_quads[..., 0] *= -1
            if rng.random() > 0.5:
                flip_YZ_XZ[1] = True
                point_cloud[:, 1] *= -1
                target_bboxes[:, 1] *= -1
                vertex_normals[:, 1] *= -1
                if rectangles.shape[0] > 0:
                    rectangles[:, 1] *= -1
                    rectangles[:, 4] *= -1
                if horizontal_quads.shape[0] > 0:
                    horizontal_quads[..., 1] *= -1
            rot_angle = (rng.random() * np.pi / 18 - np.pi / 36)
            rot_angle += int(rng.integers(0, 4)) * np.pi / 2
            rot_mat = rotz(rot_angle)
            point_cloud[:, 0:3] = point_cloud[:, 0:3] @ rot_mat.T
            vertex_normals[:, 0:3] = vertex_normals[:, 0:3] @ rot_mat.T
            target_bboxes = rotate_aligned_boxes(target_bboxes, rot_mat)
            if rectangles.shape[0] > 0:
                rectangles = rotate_quad(rectangles, rot_mat)
            if horizontal_quads.shape[0] > 0:
                horizontal_quads[..., 0:3] = horizontal_quads[..., 0:3] @ rot_mat.T
            scale_ratio = np.array(rng.random() * 0.3 + 0.85)
            point_cloud[:, 0:3] *= scale_ratio
            target_bboxes[:, 0:3] *= scale_ratio
            target_bboxes[:, 3:6] *= scale_ratio
            if rectangles.shape[0] > 0:
                rectangles[:, 0:3] *= scale_ratio
                rectangles[:, 6:8] *= scale_ratio
            if horizontal_quads.shape[0] > 0:
                horizontal_quads[..., 0:3] *= scale_ratio
            if self.use_height:
                point_cloud[:, -1] *= scale_ratio

        gt_centers = target_bboxes[:, 0:3].copy()
        gt_centers[n_box:, :] += 1000.0

        # votes from instance membership (:229-246), native C++ core
        # (native/loader_core.cpp)
        sem_in_care = np.isin(semantic_labels, SCANNET_NYU40_IDS)
        point_votes, point_votes_mask, point_instance_label = compute_votes(
            point_cloud[:, :3].astype(np.float32),
            instance_labels.astype(np.int64), sem_in_care, gt_centers)
        point_votes = np.tile(point_votes, (1, 3))

        nyu2class = {int(v): i for i, v in enumerate(SCANNET_NYU40_IDS)}
        class_ind = [nyu2class[int(x)] for x in instance_bboxes[:, -1]]
        size_classes[:n_box] = class_ind
        size_residuals[:n_box, :] = (target_bboxes[:n_box, 3:6]
                                     - SCANNET_MEAN_SIZES[class_ind])
        size_gts[:n_box, :] = target_bboxes[:n_box, 3:6]
        sem_cls = np.zeros(MAX_NUM_OBJ)
        sem_cls[:n_box] = class_ind

        target_quad_centers = np.zeros((MAX_NUM_QUAD, 3))
        target_normal_vectors = np.zeros((MAX_NUM_QUAD, 3))
        target_quad_sizes = np.zeros((MAX_NUM_QUAD, 2))
        n_quad = min(rectangles.shape[0], MAX_NUM_QUAD)
        if n_quad > 0:
            target_quad_centers[:n_quad] = rectangles[:n_quad, 0:3]
            target_normal_vectors[:n_quad] = rectangles[:n_quad, 3:6]
            target_quad_sizes[:n_quad] = rectangles[:n_quad, 6:8]

        target_horizontal = np.zeros((4, 4, 3))
        if len(horizontal_quads) > 0:
            k = min(len(horizontal_quads), 4)
            target_horizontal[:k] = horizontal_quads[:k]

        return {
            "point_clouds": point_cloud.astype(np.float32),
            "ema_point_clouds": ema_point_clouds.astype(np.float32),
            "vertex_normals": vertex_normals.astype(np.float32),
            "semantic_labels": semantic_labels.astype(np.float32),
            "center_label": target_bboxes[:, 0:3].astype(np.float32),
            "heading_class_label": np.zeros(MAX_NUM_OBJ, np.int64),
            "heading_residual_label": np.zeros(MAX_NUM_OBJ, np.float32),
            "size_class_label": size_classes.astype(np.int64),
            "size_residual_label": size_residuals.astype(np.float32),
            "size_gts": size_gts.astype(np.float32),
            "size_label": size_gts.astype(np.float32),
            "sem_cls_label": sem_cls.astype(np.int64),
            "box_label_mask": target_bboxes_mask.astype(np.float32),
            "num_gt_boxes": np.int64(n_box),
            "vote_label": point_votes.astype(np.float32),
            "vote_label_mask": point_votes_mask.astype(np.int64),
            "point_instance_label": point_instance_label.astype(np.int64),
            "scan_idx": np.int64(idx),
            "use_gt": np.bool_(self.start_proportion == 0),
            "flip_x_axis": np.int64(flip_YZ_XZ[0]),
            "flip_y_axis": np.int64(flip_YZ_XZ[1]),
            "rot_mat": rot_mat.astype(np.float32),
            "scale": np.float32(scale_ratio),
            "gt_quad_centers": target_quad_centers.astype(np.float32),
            "gt_quad_sizes": target_quad_sizes.astype(np.float32),
            "gt_normal_vectors": target_normal_vectors.astype(np.float32),
            "num_gt_quads": np.int64(rectangles.shape[0]),
            "num_total_quads": np.int64(total_quad_num),
            "horizontal_quads": target_horizontal.astype(np.float32),
        }
