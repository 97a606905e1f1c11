#!/usr/bin/env python
"""Standalone dataset debug-viz dumps (the reference's three viz scripts), on
the PyTorch port's helpers: scripts/viz_data.py with omni_pq_torch in place
of omni_pq_tpu (numpy only; neither imports torch here).

Covers, without open3d/trimesh (plain ASCII PLY via utils/viz.py writers and
the repo's own PLY reader):
  --mode scannet-scene      scannet/data_viz.py: a preprocessed scan's RGB /
                            instance-colored / semantic-colored clouds + GT
                            boxes as PLYs
  --mode scannet-transform  scannet/viz_transformed_ply.py: axis-align a raw
                            scan's *_vh_clean_2.ply by the meta axisAlignment
                            matrix and dump the transformed cloud
  --mode arkit-clean        ARKitScenes/viz_clean_ply.py: OBB-median rotate,
                            percentile recenter, 0.032 m voxel dedup and top
                            20%% z-crop of an ARKit scene mesh cloud

Examples:
  python scripts/viz_data_torch.py --mode scannet-scene \
      --scan scannet_train_detection_data/scene0002_00 --out viz_dump/
  python scripts/viz_data_torch.py --mode scannet-transform \
      --scan scans/scene0002_00 --out viz_dump/
  python scripts/viz_data_torch.py --mode arkit-clean \
      --scan 3dod/Training/41125722 --out viz_dump/
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from omni_pq_torch.utils.viz import (  # noqa: E402
    write_ply_boxes, write_ply_points)


def _label_colors(labels: np.ndarray) -> np.ndarray:
    """Deterministic distinct color per label id (pc_util.write_ply_color's
    colormap role)."""
    rng = np.random.default_rng(0)
    uniq = np.unique(labels)
    table = {u: rng.integers(40, 255, 3) for u in uniq}
    return np.stack([table[v] for v in labels]).astype(np.uint8)


def scannet_scene(scan: str, out: str):
    """data_viz.py:18-38: dump vert/instance/semantic clouds + GT boxes."""
    from omni_pq_torch.evals.box_ops import (get_3d_box_batch,
                                           flip_axis_to_camera,
                                           flip_axis_to_depth)

    data = np.load(scan + "_vert.npy")
    pts, colors = data[:, 0:3], data[:, 3:6]
    ins = np.load(scan + "_ins_label.npy")
    sem = np.load(scan + "_sem_label.npy")
    bboxes = np.load(scan + "_bbox.npy")
    os.makedirs(out, exist_ok=True)
    write_ply_points(pts, os.path.join(out, "scene.ply"),
                     colors.astype(np.uint8))
    write_ply_points(pts, os.path.join(out, "scene_instance.ply"),
                     _label_colors(ins))
    write_ply_points(pts, os.path.join(out, "scene_semantic.ply"),
                     _label_colors(sem))
    if len(bboxes):
        corners = flip_axis_to_depth(get_3d_box_batch(
            bboxes[:, 3:6], np.zeros(len(bboxes)),
            flip_axis_to_camera(bboxes[:, 0:3])))
        write_ply_boxes(list(corners), os.path.join(out, "gt_boxes.ply"))
    print(f"wrote {out}/scene*.ply ({len(pts)} pts, {len(bboxes)} boxes)")


def scannet_transform(scan_dir: str, out: str):
    """viz_transformed_ply.py: apply the meta axisAlignment to the clean
    mesh's vertices and dump."""
    from omni_pq_torch.data.preprocess import read_ply_xyzrgb

    scan_name = os.path.basename(os.path.normpath(scan_dir))
    meta_file = os.path.join(scan_dir, scan_name + ".txt")
    mat = None
    for line in open(meta_file):
        if "axisAlignment" in line:
            mat = np.array([float(x) for x in
                            line.rstrip().replace("axisAlignment = ", "")
                            .split(" ")]).reshape(4, 4)
            break
    if mat is None:
        raise ValueError(f"no axisAlignment in {meta_file}")
    cloud = read_ply_xyzrgb(os.path.join(scan_dir,
                                         scan_name + "_vh_clean_2.ply"))
    pts = np.concatenate([cloud[:, :3], np.ones((len(cloud), 1))], axis=1)
    pts = (pts @ mat.T)[:, :3]
    os.makedirs(out, exist_ok=True)
    write_ply_points(pts, os.path.join(out, scan_name + "_transformed.ply"),
                     cloud[:, 3:6].astype(np.uint8))
    print(f"wrote {out}/{scan_name}_transformed.ply ({len(pts)} pts)")


def arkit_clean(scan_dir: str, out: str):
    """viz_clean_ply.py:16-60: OBB-median rotation, percentile recentering,
    0.032 m voxel dedup (vertex-clustering role), top-20% z-crop."""
    from omni_pq_torch.data.preprocess import read_ply_xyzrgb

    scan_name = os.path.basename(os.path.normpath(scan_dir))
    prep = os.path.join(scan_dir, f"{scan_name}_offline_prepared_data")
    mesh_file = os.path.join(scan_dir, f"{scan_name}_3dod_mesh.ply")
    bboxes = np.load(os.path.join(prep, f"{scan_name}_bbox.npy"),
                     allow_pickle=True).item()
    angle = np.percentile(bboxes["bboxes"][..., -1] % (np.pi / 2), 50)
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    cloud = read_ply_xyzrgb(mesh_file)
    pts = cloud[:, :3] @ rot.T
    zl, zh = np.percentile(pts[:, 2], 15), np.percentile(pts[:, 2], 85)
    mid = (pts[:, 2] >= zl) & (pts[:, 2] <= zh)
    offset = -np.array([np.percentile(pts[mid, 0], 50),
                        np.percentile(pts[mid, 1], 50),
                        np.percentile(pts[:, 2], 5)])
    pts = pts + offset

    # 0.032 m voxel dedup: one averaged point per occupied cell
    keys = np.floor(pts / 0.032).astype(np.int64)
    _, first, inv = np.unique(keys, axis=0, return_index=True,
                              return_inverse=True)
    acc = np.zeros((len(first), 3))
    cnt = np.zeros(len(first))
    np.add.at(acc, inv, pts)
    np.add.at(cnt, inv, 1)
    pts = acc / cnt[:, None]
    colors = cloud[first, 3:6].astype(np.uint8)

    keep = pts[:, 2] < np.percentile(pts[:, 2], 80)
    pts, colors = pts[keep], colors[keep]
    os.makedirs(out, exist_ok=True)
    write_ply_points(pts, os.path.join(out, scan_name + "_clean.ply"), colors)
    print(f"wrote {out}/{scan_name}_clean.ply ({len(pts)} pts)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", required=True,
                    choices=["scannet-scene", "scannet-transform",
                             "arkit-clean"])
    ap.add_argument("--scan", required=True,
                    help="scan path/prefix (see module docstring)")
    ap.add_argument("--out", default="viz_dump")
    args = ap.parse_args()
    if args.mode == "scannet-scene":
        scannet_scene(args.scan, args.out)
    elif args.mode == "scannet-transform":
        scannet_transform(args.scan, args.out)
    else:
        arkit_clean(args.scan, args.out)


if __name__ == "__main__":
    main()
