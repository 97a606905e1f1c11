"""Fake ScanNet and ARKitScenes trees in the reference's disk layout,
written with numpy only (copies of `tests/test_data.py`'s
`write_fake_scannet` and `write_fake_arkit`: the same rng gives the same
files). The port's CPU tests and `chip_smoke.py` use them; neither may
import `tests/test_data.py`, which imports the JAX package."""
import json
import os

import numpy as np


def write_fake_scannet(root, scan_names, rng, n_verts=2000):
    os.makedirs(f"{root}/scannet_train_detection_data", exist_ok=True)
    os.makedirs(f"{root}/scannet_train_detection_data_normals", exist_ok=True)
    os.makedirs(f"{root}/scannet_planes", exist_ok=True)
    os.makedirs(f"{root}/meta_data", exist_ok=True)
    for scan in scan_names:
        verts = rng.uniform(0, 4, (n_verts, 6)).astype(np.float32)
        np.save(f"{root}/scannet_train_detection_data/{scan}_vert.npy", verts)
        ins = rng.integers(0, 5, n_verts)
        np.save(f"{root}/scannet_train_detection_data/{scan}_ins_label.npy", ins)
        sem = np.where(ins < 3, 4, 1)  # nyu40 id 4 (bed) for instances 0-2
        np.save(f"{root}/scannet_train_detection_data/{scan}_sem_label.npy", sem)
        bbox = np.zeros((3, 7))
        bbox[:, 0:3] = rng.uniform(1, 3, (3, 3))
        bbox[:, 3:6] = rng.uniform(0.5, 1.5, (3, 3))
        bbox[:, 6] = 4  # nyu40 id
        np.save(f"{root}/scannet_train_detection_data/{scan}_bbox.npy", bbox)
        nrm = rng.normal(size=(n_verts, 3)).astype(np.float32)
        np.save(f"{root}/scannet_train_detection_data_normals/{scan}.normal.npy", nrm)
        # a room of 2 vertical quads + 1 floor; json stores (x, z, -y)
        verts3 = [[0, 0, 2], [4, 0, 2], [4, 2.5, 2], [0, 2.5, 2],   # wall y=-2
                  [0, 0, -2], [0, 2.5, -2], [4, 2.5, -2], [4, 0, -2],  # wall y=2
                  [0, 0.25, 2], [4, 0.25, 2], [4, 0.25, -2], [0, 0.25, -2]]  # floor z=0.25
        quads = [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
        with open(f"{root}/scannet_planes/{scan}.json", "w") as f:
            json.dump({"verts": verts3, "quads": quads}, f)
    with open(f"{root}/meta_data/scannetv2_train.txt", "w") as f:
        f.write("\n".join(scan_names[:-1]))
    with open(f"{root}/meta_data/scannetv2_val.txt", "w") as f:
        f.write(scan_names[-1])


def write_fake_arkit(root, scans, rng, n_verts=3000, valid_scans=()):
    os.makedirs(f"{root}/dataset/3dod/Training", exist_ok=True)
    os.makedirs(f"{root}/data/annotations", exist_ok=True)
    with open(f"{root}/dataset/train_filtered.txt", "w") as f:
        f.write("\n".join(scans))

    def write_scan(d, scan):
        os.makedirs(d, exist_ok=True)
        np.save(f"{d}/{scan}_pc.npy",
                rng.uniform(-3, 3, (n_verts, 3)).astype(np.float32))
        np.save(f"{d}/{scan}_normal.npy",
                rng.normal(size=(n_verts, 3)).astype(np.float32))
        boxes = {"bboxes": rng.uniform(0.3, 2.0, (4, 7)),
                 "types": ["chair", "table", "bed", "sofa"]}
        np.save(f"{d}/{scan}_bbox.npy", boxes, allow_pickle=True)

    for scan in scans:
        write_scan(f"{root}/dataset/3dod/Training/{scan}/"
                   f"{scan}_offline_prepared_data", scan)
    if valid_scans:
        os.makedirs(f"{root}/dataset/3dod/Validation", exist_ok=True)
        with open(f"{root}/dataset/valid_filtered.txt", "w") as f:
            f.write("\n".join(valid_scans))
        with open(f"{root}/data/file.txt", "w") as f:
            f.write("\n".join(f"{s},anno_{s}" for s in valid_scans))
        for scan in valid_scans:
            write_scan(f"{root}/dataset/3dod/Validation/{scan}/"
                       f"{scan}_offline_prepared_data", scan)
            labels = []
            for _ in range(3):
                c = rng.uniform(-2, 2, 3)
                dim = sorted(rng.uniform(0.1, 3.0, 2))
                labels.append({"box3d": {
                    "location": {"x": c[0], "y": c[1], "z": c[2]},
                    "dimension": {"width": dim[1], "length": dim[0],
                                  "height": float(rng.uniform(1.5, 2.5))}}})
            with open(f"{root}/data/annotations/anno_{scan}.json", "w") as f:
                json.dump({"labels": labels}, f)
