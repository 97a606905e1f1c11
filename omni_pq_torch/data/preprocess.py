"""Offline ScanNet preprocessing: raw scans -> the training .npy layout.

The port's own copy of `omni_pq_tpu/data/preprocess.py` (numpy and the
native loader core only; the normals always come from the native core,
which raises if it cannot be built).

Rebuilds the one-time pipeline of scannet/load_scannet_data.py:57-135,
batch_load_scannet_data.py:25-55 and compute_normal_for_pc.py:7-52 without
the plyfile / pymeshlab dependencies:
  - minimal binary/ascii PLY reader for *_vh_clean_2.ply
  - aggregation + segmentation json -> per-vertex nyu40 semantic + instance
    ids; per-instance axis-aligned boxes (cx,cy,cz,dx,dy,dz,label)
  - axis alignment from the scene meta txt
  - 50k random subsample, filtering wall/floor-don't-care ids {1, 2, 22}
    from the semantic labels only (they stay in the cloud like the reference)
  - k-NN PCA point normals (k=100 neighborhood), flipped to point toward the
    scene's inner viewpoint like the reference's pymeshlab pass (:40-48)

Usage:
    python -m omni_pq_torch.data.preprocess --scannet_dir <raw>/scans \
        --output_dir <root>/scannet_train_detection_data \
        --label_map <meta>/scannetv2-labels.combined.tsv
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import struct
from typing import Dict, Tuple

import numpy as np

from ..native import estimate_normals_native
from .quads import load_axis_align_matrix

MAX_NUM_POINT = 50000
OBJ_CLASS_IDS = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28,
                          33, 34, 36, 39])


def read_ply_xyzrgb(path: str) -> np.ndarray:
    """Minimal PLY reader for ScanNet's *_vh_clean_2.ply (x y z r g b a,
    binary little endian or ascii). Returns (N, 6) xyz + rgb."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a ply file")
        fmt = None
        n = 0
        props = []
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1].decode()
            elif line.startswith(b"element vertex"):
                n = int(line.split()[-1])
            elif line.startswith(b"element"):
                pass
            elif line.startswith(b"property") and n and not props_done(props, line):
                props.append(line.split()[1:])
            elif line == b"end_header":
                break
        type_map = {b"float": ("f", 4), b"float32": ("f", 4),
                    b"double": ("d", 8), b"uchar": ("B", 1),
                    b"uint8": ("B", 1), b"int": ("i", 4), b"uint": ("I", 4),
                    b"short": ("h", 2), b"ushort": ("H", 2)}
        if fmt == "ascii":
            rows = [f.readline().split() for _ in range(n)]
            data = np.array(rows, dtype=np.float64)[:, :6]
            return data
        codes = "".join(type_map[p[0]][0] for p in props if len(p) == 2)
        rec = struct.Struct("<" + codes)
        raw = f.read(rec.size * n)
        out = np.zeros((n, 6))
        for i in range(n):
            vals = rec.unpack_from(raw, i * rec.size)
            out[i, :6] = vals[:6]
        return out


def props_done(props, line):
    # vertex properties end when a face element begins; handled by caller
    return b"list" in line


def read_label_mapping(tsv_path: str, label_from="raw_category",
                       label_to="nyu40id") -> Dict[str, int]:
    mapping = {}
    with open(tsv_path) as f:
        reader = csv.DictReader(f, delimiter="\t")
        for row in reader:
            try:
                mapping[row[label_from]] = int(row[label_to])
            except (ValueError, KeyError):
                continue
    return mapping


def read_aggregation(path: str):
    object_id_to_segs: Dict[int, list] = {}
    label_to_segs: Dict[str, list] = {}
    with open(path) as f:
        data = json.load(f)
    for group in data["segGroups"]:
        object_id = group["objectId"] + 1  # 1-indexed instances
        label = group["label"]
        segs = group["segments"]
        object_id_to_segs[object_id] = segs
        label_to_segs.setdefault(label, []).extend(segs)
    return object_id_to_segs, label_to_segs


def read_segmentation(path: str):
    with open(path) as f:
        data = json.load(f)
    seg_ids = np.array(data["segIndices"])
    seg_to_verts: Dict[int, np.ndarray] = {}
    for seg in np.unique(seg_ids):
        seg_to_verts[int(seg)] = np.where(seg_ids == seg)[0]
    return seg_to_verts, len(seg_ids)


def export_scene(scan_dir: str, scan_name: str, label_map: Dict[str, int]
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """-> (verts (N,6), sem_labels (N,), ins_labels (N,), bboxes (M,7))."""
    mesh = read_ply_xyzrgb(os.path.join(scan_dir, scan_name + "_vh_clean_2.ply"))
    mat = load_axis_align_matrix(os.path.join(scan_dir, scan_name + ".txt"))
    pts = np.ones((mesh.shape[0], 4))
    pts[:, :3] = mesh[:, :3]
    mesh[:, :3] = (pts @ mat.T)[:, :3]

    object_id_to_segs, label_to_segs = read_aggregation(
        os.path.join(scan_dir, scan_name + ".aggregation.json"))
    seg_to_verts, num_verts = read_segmentation(
        os.path.join(scan_dir, scan_name + "_vh_clean_2.0.010000.segs.json"))

    label_ids = np.zeros(num_verts, np.uint32)
    object_id_to_label = {}
    for label, segs in label_to_segs.items():
        lid = label_map.get(label, 0)
        for seg in segs:
            label_ids[seg_to_verts[seg]] = lid
    instance_ids = np.zeros(num_verts, np.uint32)
    for object_id, segs in object_id_to_segs.items():
        for seg in segs:
            verts = seg_to_verts[seg]
            instance_ids[verts] = object_id
            if object_id not in object_id_to_label:
                object_id_to_label[object_id] = label_ids[verts[0]]

    num_instances = len(object_id_to_segs)
    bboxes = np.zeros((num_instances, 7))
    for obj_id in object_id_to_segs:
        pc = mesh[instance_ids == obj_id, :3]
        if len(pc) == 0:
            continue
        lo, hi = pc.min(0), pc.max(0)
        bboxes[obj_id - 1] = np.concatenate(
            [(lo + hi) / 2, hi - lo, [object_id_to_label[obj_id]]])
    return mesh, label_ids, instance_ids, bboxes


def estimate_normals(points: np.ndarray, k: int = 100) -> np.ndarray:
    """k-NN PCA normals, flipped toward the reference viewpoint (scene
    centroid raised halfway to the ceiling), then flipped to point inward —
    matching compute_normal_for_pc.py:36-48's pymeshlab pass semantically
    (the native core's grid-hash k-NN and 3x3 Jacobi)."""
    center = points.mean(0)
    center[2] = (points[:, 2].max() + center[2]) / 2
    return estimate_normals_native(points, min(k, len(points)),
                                   center).astype(np.float64)


def process_scan(scannet_dir: str, scan_name: str, output_dir: str,
                 normals_dir: str, label_map: Dict[str, int],
                 rng: np.random.Generator, max_points: int = MAX_NUM_POINT):
    scan_dir = os.path.join(scannet_dir, scan_name)
    mesh, sem, ins, bboxes = export_scene(scan_dir, scan_name, label_map)
    bboxes = bboxes[np.isin(bboxes[:, -1], OBJ_CLASS_IDS)]
    if mesh.shape[0] > max_points:
        choices = rng.choice(mesh.shape[0], max_points, replace=False)
        mesh, sem, ins = mesh[choices], sem[choices], ins[choices]
    os.makedirs(output_dir, exist_ok=True)
    os.makedirs(normals_dir, exist_ok=True)
    pre = os.path.join(output_dir, scan_name)
    np.save(pre + "_vert.npy", mesh)
    np.save(pre + "_sem_label.npy", sem)
    np.save(pre + "_ins_label.npy", ins)
    np.save(pre + "_bbox.npy", bboxes)
    normals = estimate_normals(mesh[:, :3])
    np.save(os.path.join(normals_dir, scan_name + ".normal.npy"), normals)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--scannet_dir", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--normals_dir", default=None)
    parser.add_argument("--label_map", required=True)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    normals_dir = args.normals_dir or os.path.join(
        os.path.dirname(args.output_dir), "scannet_train_detection_data_normals")
    label_map = read_label_mapping(args.label_map)
    rng = np.random.default_rng(args.seed)
    scans = sorted(os.listdir(args.scannet_dir))
    for i, scan in enumerate(scans):
        print(f"[{i + 1}/{len(scans)}] {scan}")
        try:
            process_scan(args.scannet_dir, scan, args.output_dir, normals_dir,
                         label_map, rng)
        except Exception as e:
            print(f"  failed: {e}")


if __name__ == "__main__":
    main()
