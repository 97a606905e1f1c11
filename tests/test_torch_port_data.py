"""The port's data tier against the JAX package's, bitwise: the ScanNet and
ARKitScenes loaders sample by sample on fake trees (tests/test_data.py's
writers, a few hundred vertices a scan), the quad extraction, the PLY
reader, the offline preprocessing of a scan, the native loader core, and
the batching (Loader in every shuffle / drop_last / shard combination,
PrefetchLoader, DoubleLoader, endless)."""
import filecmp
import json
import os
import struct

import numpy as np
import pytest

from omni_pq_tpu import data as jdata
from omni_pq_tpu import native as jnative
from omni_pq_tpu.data import preprocess as jpre
from omni_pq_torch import data as tdata
from omni_pq_torch import native as tnative
from omni_pq_torch.data import preprocess as tpre
from omni_pq_torch.utils.viz import write_ply_points
from tests import torch_fake_data
from tests.test_data import write_fake_arkit, write_fake_scannet

N_VERTS = 400
SCANS = [f"scene{i:04d}_00" for i in range(5)]
ARKIT_TRAIN = ["41048190", "41048191", "41048192"]
ARKIT_VALID = ["47331587", "47331588"]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    rng = np.random.default_rng(0)
    write_fake_scannet(str(base / "scannet"), SCANS, rng, n_verts=N_VERTS)
    write_fake_arkit(str(base / "arkit"), ARKIT_TRAIN, rng, n_verts=N_VERTS,
                     valid_scans=ARKIT_VALID)
    # an axis alignment for one scan: get_quads transforms its planes
    os.makedirs(base / "scannet/scans_transform/scene0001_00")
    (base / "scannet/scans_transform/scene0001_00/scene0001_00.txt"
     ).write_text("axisAlignment = 0 -1 0 1.5 1 0 0 -0.5 0 0 1 0.1 "
                  "0 0 0 1\n")
    return str(base / "scannet"), str(base / "arkit")


def assert_same_sample(got, want, where):
    assert set(got) == set(want), where
    for k, v in want.items():
        g = got[k]
        assert np.asarray(g).dtype == np.asarray(v).dtype, (where, k)
        np.testing.assert_array_equal(g, v, err_msg=f"{where} {k}")


def test_fake_writers_write_the_same_files(tmp_path):
    write_fake_scannet(str(tmp_path / "a"), SCANS[:3],
                       np.random.default_rng(5), n_verts=50)
    torch_fake_data.write_fake_scannet(str(tmp_path / "b"), SCANS[:3],
                                       np.random.default_rng(5), n_verts=50)
    write_fake_arkit(str(tmp_path / "c"), ARKIT_TRAIN, np.random.default_rng(6),
                     n_verts=50, valid_scans=ARKIT_VALID)
    torch_fake_data.write_fake_arkit(str(tmp_path / "d"), ARKIT_TRAIN,
                                     np.random.default_rng(6), n_verts=50,
                                     valid_scans=ARKIT_VALID)
    for a, b in (("a", "b"), ("c", "d")):
        files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / a)
                       for d, _, fs in os.walk(tmp_path / a) for f in fs)
        files_b = sorted(os.path.relpath(os.path.join(d, f), tmp_path / b)
                         for d, _, fs in os.walk(tmp_path / b) for f in fs)
        assert files == files_b and files
        for f in files:
            assert filecmp.cmp(tmp_path / a / f, tmp_path / b / f,
                               shallow=False), f


@pytest.mark.parametrize("split,start,end,augment,color,height,npts", [
    ("train", 0.0, 1.0, False, False, False, 256),
    ("train", 0.0, 0.5, True, True, True, 256),
    ("train", 0.5, 1.0, True, False, True, 512),   # more points than verts
    ("val", 0.0, 1.0, False, True, False, 256),
    ("all", 0.0, 1.0, True, False, False, 128),
])
def test_scannet_dataset_matches_jax(roots, split, start, end, augment, color,
                                     height, npts):
    kw = dict(num_points=npts, use_color=color, use_height=height,
              augment=augment, start_proportion=start, end_proportion=end,
              seed=7)
    want = jdata.ScannetDetectionDataset(roots[0], split, **kw)
    got = tdata.ScannetDetectionDataset(roots[0], split, **kw)
    assert got.scan_names == want.scan_names and len(got) > 0
    for i in range(len(want)):  # one rng stream: the same order of draws
        assert_same_sample(got[i], want[i], f"{split} {i}")
    # reseed() starts the draws again: the first sample comes back
    got.reseed()
    assert_same_sample(got[0], jdata.ScannetDetectionDataset(
        roots[0], split, **kw)[0], f"{split} reseeded")


@pytest.mark.parametrize("split,augment", [("train", False), ("train", True),
                                           ("valid", False)])
def test_arkit_dataset_matches_jax(roots, split, augment):
    kw = dict(num_points=256, augment=augment, seed=3)
    want = jdata.ARKitSceneDataset(roots[1], split, **kw)
    got = tdata.ARKitSceneDataset(roots[1], split, **kw)
    assert got.scan_names == want.scan_names and len(got) > 0
    for i in range(len(want)):
        assert_same_sample(got[i], want[i], f"{split} {i}")
    assert ("gt_quad_centers" in got[0]) == (split == "valid")


def test_quads_match_jax(roots):
    scannet, arkit = roots
    for scan, meta in (("scene0000_00", None), ("scene0001_00", os.path.join(
            scannet, "scans_transform/scene0001_00/scene0001_00.txt"))):
        path = os.path.join(scannet, "scannet_planes", scan + ".json")
        got = tdata.get_quads(path, meta)
        want = jdata.get_quads(path, meta)
        assert got[1] == want[1] == 3
        for g, w in ((got[0], want[0]), (got[2], want[2])):
            assert g.shape == w.shape and g.size
            np.testing.assert_array_equal(g, w)
    anno = os.path.join(arkit, "data/annotations", f"anno_{ARKIT_VALID[0]}.json")
    got = tdata.arkit_quads_from_annotation(anno, height=2.3, center_z=1.1)
    want = jdata.arkit_quads_from_annotation(anno, height=2.3, center_z=1.1)
    assert got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)


def test_read_ply_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-2, 5, (300, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (300, 3))
    write_ply_points(pts, str(tmp_path / "ascii.ply"), cols)
    # binary little endian with an alpha channel and a face element, as
    # ScanNet's *_vh_clean_2.ply
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex 300\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\nproperty uchar blue\n"
              "property uchar alpha\nelement face 1\n"
              "property list uchar int vertex_indices\nend_header\n")
    body = b"".join(struct.pack("<fffBBBB", *p, *c, 255)
                    for p, c in zip(pts.tolist(), cols.tolist()))
    (tmp_path / "binary.ply").write_bytes(
        header.encode() + body + struct.pack("<Biii", 3, 0, 1, 2))
    for name in ("ascii.ply", "binary.ply"):
        got = tpre.read_ply_xyzrgb(str(tmp_path / name))
        want = jpre.read_ply_xyzrgb(str(tmp_path / name))
        assert got.shape == (300, 6)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got[:, :3], pts, atol=1e-6)
        np.testing.assert_array_equal(got[:, 3:], cols)


def test_process_scan_matches_jax(tmp_path):
    """export_scene (PLY, aggregation, segments, axis alignment), the 50k
    cap's subsample and the native normals, on a small raw scan."""
    rng = np.random.default_rng(2)
    scan = "scene0007_00"
    d = tmp_path / "scans" / scan
    d.mkdir(parents=True)
    n = 600
    pts = rng.uniform(0, 4, (n, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (n, 3))
    write_ply_points(pts, str(d / f"{scan}_vh_clean_2.ply"), cols)
    seg = rng.integers(0, 12, n)
    (d / f"{scan}_vh_clean_2.0.010000.segs.json").write_text(
        json.dumps({"segIndices": seg.tolist()}))
    groups = [{"objectId": i, "label": lab, "segments": [2 * i, 2 * i + 1]}
              for i, lab in enumerate(["bed", "chair", "wall", "table"])]
    (d / f"{scan}.aggregation.json").write_text(
        json.dumps({"segGroups": groups}))
    (d / f"{scan}.txt").write_text(
        "axisAlignment = 1 0 0 -2 0 1 0 -2 0 0 1 0 0 0 0 1\n")
    tsv = tmp_path / "labels.tsv"
    tsv.write_text("raw_category\tnyu40id\nbed\t4\nchair\t5\nwall\t1\n"
                   "table\t7\n")
    outs = {}
    for name, pre in (("jax", jpre), ("torch", tpre)):
        out, nrm = tmp_path / name / "data", tmp_path / name / "normals"
        pre.process_scan(str(tmp_path / "scans"), scan, str(out), str(nrm),
                         pre.read_label_mapping(str(tsv)),
                         np.random.default_rng(4), max_points=500)
        outs[name] = {f: np.load(p / f) for p in (out, nrm)
                      for f in sorted(os.listdir(p))}
    assert set(outs["torch"]) == set(outs["jax"]) and len(outs["jax"]) == 5
    for f, want in outs["jax"].items():
        got = outs["torch"][f]
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert outs["torch"][f"{scan}_vert.npy"].shape == (500, 6)
    assert outs["torch"][f"{scan}_bbox.npy"].shape[0] == 3  # bed, chair, table


def test_native_helpers_match_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-3, 5, (3000, 3)).astype(np.float32)
    pts[:50] = pts[50:100]  # ties in the Morton order
    np.testing.assert_array_equal(tnative.morton_argsort(pts),
                                  jnative.morton_argsort(pts))
    n = 2000
    pc = rng.uniform(0, 4, (n, 3)).astype(np.float32)
    inst = rng.integers(-1, 6, n).astype(np.int64)
    care = rng.uniform(size=n) > 0.3
    gt = rng.uniform(0, 4, (8, 3)).astype(np.float32)
    got = tnative.compute_votes(pc, inst, care, gt)
    assert got[1].sum() > 0
    for g, w, p in zip(got, jnative.compute_votes(pc, inst, care, gt),
                       tnative.compute_votes_plain(pc, inst, care, gt)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)
    src = rng.normal(size=(100, 7)).astype(np.float32)
    ch = rng.integers(0, 100, 300).astype(np.int64)
    np.testing.assert_array_equal(tnative.gather_rows(src, ch),
                                  jnative.gather_rows(src, ch))
    np.testing.assert_array_equal(tnative.gather_rows(src, ch),
                                  tnative.gather_rows_plain(src, ch))
    with pytest.raises(IndexError):  # checked before the pointer is passed
        tnative.gather_rows(src, np.array([0, 100]))
    vp = np.float32([2.0, 1.0, 3.0])
    got = tnative.estimate_normals_native(pts, 30, vp)
    np.testing.assert_array_equal(got,
                                  jnative.estimate_normals_native(pts, 30, vp))
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No silent fallback: a library that cannot be built raises with the
    compiler's message."""
    bad = tmp_path / "loader_core.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SRC", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="build failed"):
        tnative.morton_argsort(np.zeros((4, 3), np.float32))


class IndexDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int64(i), "x": np.full(3, i, np.float32)}


@pytest.mark.parametrize("num_shards", [1, 3])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_order_matches_jax(shuffle, drop_last, num_shards):
    for shard in range(num_shards):
        kw = dict(batch_size=3, shuffle=shuffle, drop_last=drop_last, seed=4,
                  shard_id=shard, num_shards=num_shards)
        got_l = tdata.Loader(IndexDataset(10), **kw)
        want_l = jdata.Loader(IndexDataset(10), **kw)
        for epoch in (0, 1):
            got_l.set_epoch(epoch)
            want_l.set_epoch(epoch)
            got = [b["i"].tolist() for b in got_l]
            want = [b["i"].tolist() for b in want_l]
            assert got == want and len(got_l) == len(want_l) == len(got)
            if not drop_last:  # the last partial batch is kept
                assert sum(map(len, got)) == -(-10 // num_shards)


def test_prefetch_loader_gives_the_loaders_batches(roots):
    plain = tdata.Loader(IndexDataset(11), 3, seed=2, drop_last=False)
    pre = tdata.PrefetchLoader(tdata.Loader(IndexDataset(11), 3, seed=2,
                                            drop_last=False), num_workers=3)
    for epoch in (0, 1):
        plain.set_epoch(epoch)
        pre.set_epoch(epoch)
        a, b = list(plain), list(pre)
        assert len(a) == len(b) == len(pre) == 4
        for x, y in zip(a, b):
            assert_same_sample(y, x, f"epoch {epoch}")
    # a dataset with one random stream, drawn in order by one worker: the
    # same samples as the plain loader's, and as the JAX loader's
    kw = dict(num_points=256, seed=5)
    got = list(tdata.PrefetchLoader(tdata.Loader(
        tdata.ScannetDetectionDataset(roots[0], "train", **kw), 2, seed=1),
        num_workers=1))
    want = list(jdata.Loader(
        jdata.ScannetDetectionDataset(roots[0], "train", **kw), 2, seed=1))
    assert len(got) == len(want) == 2
    for x, y in zip(got, want):
        assert_same_sample(x, y, "scannet batch")
    # a sample that fails raises in the consumer instead of hanging it

    class Broken(IndexDataset):
        def __getitem__(self, i):
            if i == 4:
                raise OSError("unreadable scan")
            return super().__getitem__(i)
    with pytest.raises(OSError, match="unreadable"):
        list(tdata.PrefetchLoader(tdata.Loader(Broken(8), 2, shuffle=False),
                                  num_workers=2))


def test_double_loader_and_endless_match_jax():
    def run(pkg):
        a = pkg.Loader(IndexDataset(7), 2, seed=1)
        b = pkg.Loader(IndexDataset(3), 2, seed=2, drop_last=False)
        double = [x["i"].tolist() for x in pkg.DoubleLoader(a, b)]
        stream = pkg.endless(pkg.Loader(IndexDataset(5), 2, seed=3))
        return double, [next(stream)["i"].tolist() for _ in range(7)]
    assert run(tdata) == run(jdata)
    with pytest.raises(ValueError, match="no batch"):
        next(tdata.endless(tdata.Loader(IndexDataset(1), 2)))
