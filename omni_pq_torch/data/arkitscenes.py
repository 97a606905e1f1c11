"""ARKitScenes weak/unlabeled dataset.

The port's own copy of `omni_pq_tpu/data/arkitscenes.py`: the same seed
gives the same samples, sample by sample.

Rebuilds ARKitScenes/arkitscenes_dataset.py:42-233 against the same disk
layout:
    <root>/dataset/{train,valid}_filtered.txt
    <root>/dataset/3dod/{Training,Validation}/<scan>/<scan>_offline_prepared_data/
        <scan>_{pc,normal,bbox}.npy
    <root>/data/file.txt                 (valid scan -> annotation mapping)
    <root>/data/annotations/<name>.json  (human quad annotations, valid only)
OBB-median scene axis-alignment + percentile recentering (:102-126); the
train split carries weak object boxes only; the valid split attaches quad GT
from the annotation JSONs with height/center_z from z-percentiles (:202-231). `reseed()` starts the draws again from the
seed.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .quads import arkit_quads_from_annotation
from .scannet import rotz, random_sampling, rotate_aligned_boxes
from .spatial import spatial_sort

MAX_NUM_OBJ = 64
MAX_NUM_QUAD = 32

ARKIT_TYPE2CLASS = {
    "cabinet": 0, "refrigerator": 12, "shelf": 7, "stove": 9, "bed": 1,
    "sink": 15, "washer": 17, "toilet": 14, "bathtub": 16, "oven": 9,
    "dishwasher": 9, "fireplace": 9, "stool": 2, "chair": 2, "table": 4,
    "tv_monitor": 8, "sofa": 3,
}


def is_valid_mapping_name(name: str) -> bool:
    return name.strip() not in ("", "-")


class ARKitSceneDataset:
    def __init__(self, data_root: str, split_set: str = "train",
                 num_points: int = 40000, augment: bool = False,
                 start_proportion: float = 0.0, end_proportion: float = 1.0,
                 seed: int = 0):
        assert split_set in ("train", "valid")
        self.split_set = split_set
        self.data_root = data_root
        base = os.path.join(data_root, "dataset")
        with open(os.path.join(base, f"{split_set}_filtered.txt")) as f:
            names = f.read().strip().split("\n")
        if split_set == "train":
            self.data_path = os.path.join(base, "3dod/Training")
        else:
            self.data_path = os.path.join(base, "3dod/Validation")
            self.valid_mapping = {
                line.split(",")[0]: line.split(",")[1]
                for line in open(os.path.join(data_root, "data", "file.txt")
                                 ).read().strip().split("\n")}
        names = sorted(names)
        bak = names
        start = int(len(names) * start_proportion)
        end = int(len(names) * end_proportion)
        names = names[start:end]
        if split_set == "valid":
            names = [n for n in names
                     if is_valid_mapping_name(self.valid_mapping[n])]
        if len(names) == 0:
            names = [bak[-1]]
        self.scan_names = names
        self.num_points = num_points
        self.augment = augment
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
        scan_dir = os.path.join(self.data_path, scan_name,
                                f"{scan_name}_offline_prepared_data")
        mesh_vertices = np.load(os.path.join(scan_dir, f"{scan_name}_pc.npy"))
        vertex_normals = np.load(os.path.join(scan_dir, f"{scan_name}_normal.npy"))
        bboxes = np.load(os.path.join(scan_dir, f"{scan_name}_bbox.npy"),
                         allow_pickle=True).item()
        boxes = np.array(bboxes["bboxes"], dtype=np.float64)

        # OBB-median axis alignment + percentile recentering (:102-126)
        angle = np.percentile(boxes[..., -1] % (np.pi / 2), 50)
        rot_align = rotz(angle)
        z_lo = np.percentile(mesh_vertices[..., 2], 15)
        z_hi = np.percentile(mesh_vertices[..., 2], 85)
        mask = (mesh_vertices[..., 2] >= z_lo) & (mesh_vertices[..., 2] <= z_hi)
        offset = np.array([np.percentile(mesh_vertices[mask, 0], 50),
                           np.percentile(mesh_vertices[mask, 1], 50),
                           np.percentile(mesh_vertices[..., 2], 5)])
        boxes[..., :3] = boxes[..., :3] @ rot_align.T - offset
        boxes[..., 6] = (boxes[..., 6] - angle) % (2 * np.pi)
        rev = (((np.pi / 4 <= boxes[..., 6]) & (boxes[..., 6] <= 3 * np.pi / 4))
               | ((5 * np.pi / 4 <= boxes[..., 6]) & (boxes[..., 6] <= 7 * np.pi / 4)))
        dx, dy = boxes[..., 3].copy(), boxes[..., 4].copy()
        boxes[..., 3] = np.where(rev, dy, dx)
        boxes[..., 4] = np.where(rev, dx, dy)

        target_bboxes = np.zeros((MAX_NUM_OBJ, 6))
        n_box = min(boxes.shape[0], MAX_NUM_OBJ)
        target_bboxes[:n_box] = boxes[:n_box, 0:6]
        sem_cls = np.zeros(MAX_NUM_OBJ)
        for i in range(n_box):
            sem_cls[i] = ARKIT_TYPE2CLASS.get(str(bboxes["types"][i]), 0)

        point_cloud, choices = random_sampling(mesh_vertices, self.num_points,
                                               rng, return_choices=True)
        sperm = spatial_sort(point_cloud)
        point_cloud = point_cloud[sperm]
        choices = choices[sperm]
        sel_normals = vertex_normals[choices]
        ema_point_clouds, _ = random_sampling(mesh_vertices, self.num_points,
                                              rng, return_choices=True)
        ema_point_clouds = ema_point_clouds[spatial_sort(ema_point_clouds)]

        flip_YZ_XZ = np.array([False, False])
        rot_mat = np.identity(3)
        scale_ratio = np.array(1.0)
        if self.augment:
            if rng.random() > 0.5:
                flip_YZ_XZ[0] = True
                point_cloud[:, 0] *= -1
                target_bboxes[:, 0] *= -1
                sel_normals[:, 0] *= -1
            if rng.random() > 0.5:
                flip_YZ_XZ[1] = True
                point_cloud[:, 1] *= -1
                target_bboxes[:, 1] *= -1
                sel_normals[:, 1] *= -1
            rot_angle = (rng.random() * np.pi / 18 - np.pi / 36)
            rot_angle += int(rng.integers(0, 4)) * np.pi / 2
            rot_mat = rotz(rot_angle)
            point_cloud[:, 0:3] = point_cloud[:, 0:3] @ rot_mat.T
            sel_normals[:, 0:3] = sel_normals[:, 0:3] @ rot_mat.T
            target_bboxes = rotate_aligned_boxes(target_bboxes, rot_mat)
            scale_ratio = np.array(rng.random() * 0.3 + 0.85)
            point_cloud[:, 0:3] *= scale_ratio
            target_bboxes[:, 0:3] *= scale_ratio
            target_bboxes[:, 3:6] *= scale_ratio

        ret: Dict[str, np.ndarray] = {
            "point_clouds": point_cloud.astype(np.float32),
            "vertex_normals": sel_normals.astype(np.float32),
            "ema_point_clouds": ema_point_clouds.astype(np.float32),
            "flip_x_axis": np.int64(flip_YZ_XZ[0]),
            "flip_y_axis": np.int64(flip_YZ_XZ[1]),
            "rot_mat": rot_mat.astype(np.float32),
            "scale": np.float32(scale_ratio),
            "center_label": target_bboxes[:, 0:3].astype(np.float32),
            "heading_class_label": np.zeros(MAX_NUM_OBJ, np.int64),
            "heading_residual_label": np.zeros(MAX_NUM_OBJ, np.float32),
            "size_label": target_bboxes[:, 3:6].astype(np.float32),
            "sem_cls_label": sem_cls.astype(np.int64),
            "num_gt_boxes": np.int64(n_box),
        }

        if self.split_set == "valid":
            mapping_name = self.valid_mapping[scan_name]
            z = point_cloud[..., -1]
            height_a = np.percentile(z, 98)
            height_b = np.percentile(z, 5)
            rects = arkit_quads_from_annotation(
                os.path.join(self.data_root, "data", "annotations",
                             f"{mapping_name}.json"),
                height=height_a - height_b,
                center_z=(height_a + height_b) / 2)
            qc = np.zeros((MAX_NUM_QUAD, 3))
            qn = np.zeros((MAX_NUM_QUAD, 3))
            qs = np.zeros((MAX_NUM_QUAD, 2))
            k = min(rects.shape[0], MAX_NUM_QUAD)
            if k > 0:
                qc[:k] = rects[:k, 0:3]
                qn[:k] = rects[:k, 3:6]
                qs[:k] = rects[:k, 6:8]
            ret["gt_quad_centers"] = qc.astype(np.float32)
            ret["gt_quad_sizes"] = qs.astype(np.float32)
            ret["gt_normal_vectors"] = qn.astype(np.float32)
            ret["num_gt_quads"] = np.int64(rects.shape[0])
            ret["num_total_quads"] = np.int64(rects.shape[0])
            ret["horizontal_quads"] = np.zeros((4, 4, 3), np.float32)
        return ret
