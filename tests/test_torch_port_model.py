"""The port's whole serving slice against the JAX package, plus the port's
hygiene (no JAX at import, entry points that need a card) and its CLI.

Whole slice: one set of TINY weights (BN statistics from numpy noise) in
both packages, the same 2 synthetic scenes (each package's own make_batch
from one seed), every end_points key compared (indices bitwise, floats
within 1e-4 abs + rel: the 1e-5 per-module drift of test_torch_port_modules
stacked through the decoder layers), then decode + NMS + corner-F1: equal
NMS masks, corner lists within 1e-4 and equal F1.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from omni_pq_tpu import evals as jevals
from omni_pq_tpu.data.synthetic import make_batch as jax_make_batch
from omni_pq_tpu.models import PQTransformer as JaxPQTransformer
from omni_pq_torch.cli import infer as infer_cli
from omni_pq_torch.config import SMOKE_MODEL, ModelConfig
from omni_pq_torch.data import make_batch, make_scene
from omni_pq_torch.evals import parse_predictions
from omni_pq_torch.infer import (EVAL_CONFIG, build_model, eval_forward,
                                 evaluate_quad_f1, load_model)
from omni_pq_torch.interop import flax_to_state_dict
from tests.test_torch_port_modules import port_config, randomised_variables
from tests.util import TINY

PACKAGE = Path(__file__).resolve().parents[1] / "omni_pq_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "omni_pq_tpu")


@pytest.fixture(scope="module")
def slice_outputs():
    batch = make_batch(np.random.default_rng(0), 2, TINY.num_points)
    jax_batch = jax_make_batch(np.random.default_rng(0), 2, TINY.num_points)
    jmodel = JaxPQTransformer(TINY)
    variables = randomised_variables(jmodel, batch["point_clouds"], seed=1)
    ep_j = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(batch["point_clouds"]))
    model = load_model(flax_to_state_dict(variables), port_config(TINY),
                       "cpu")
    ep_t = eval_forward(model, batch["point_clouds"])
    return batch, jax_batch, jax.tree.map(np.asarray, ep_j), ep_t


def test_synthetic_scenes_match_jax(slice_outputs):
    batch, jax_batch, _, _ = slice_outputs
    assert set(batch) == set(jax_batch)
    for k in batch:
        np.testing.assert_array_equal(batch[k], jax_batch[k], err_msg=k)


def test_every_end_point_matches_jax(slice_outputs):
    _, _, ep_j, ep_t = slice_outputs
    assert set(ep_t) == set(ep_j) and len(ep_t) == 21 + 14 * 3
    for k, want in ep_j.items():
        got = ep_t[k].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, k
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                       err_msg=k)


def _jax_quad_f1(ep, labels):
    """The JAX package's decode + F1 loop (cli/train.py::evaluate)."""
    merged = {**ep, **labels}
    pred_cls, mask, corners = jevals.parse_quad_predictions(
        merged, EVAL_CONFIG, "last_")
    gt_cls, gt_corners = jevals.parse_quad_groundtruths(merged, EVAL_CONFIG)
    calc = jevals.QuadAPCalculator(ap_iou_thresh=0.25)
    calc.step(pred_cls, gt_cls, corners, gt_corners,
              list(labels["horizontal_quads"]))
    return calc.compute_F1(calculated=True), mask, corners


def _assert_same_decode(got, want):
    f1, mask, corners = want
    np.testing.assert_array_equal(got["pred_mask"], mask)
    assert [len(c) for c in got["pred_corners"]] == [len(c) for c in corners]
    for a, b in zip(got["pred_corners"], corners):
        if b:
            np.testing.assert_allclose(np.stack(a), np.stack(b), rtol=1e-4,
                                       atol=1e-4)
    assert got["f1"] == f1


def test_decode_and_corner_f1_match_jax(slice_outputs):
    batch, _, ep_j, ep_t = slice_outputs
    got = evaluate_quad_f1(ep_t, batch)
    want = _jax_quad_f1(ep_j, batch)
    assert sum(map(len, want[2])) > 0  # some quads clear the 0.5 gate
    _assert_same_decode(got, want)
    # the object decode of the same path (3D NMS per class)
    _, obj_mask = parse_predictions({k: v.numpy() for k, v in ep_t.items()},
                                    EVAL_CONFIG, "last_")
    _, jobj_mask = jevals.parse_predictions(ep_j, EVAL_CONFIG, "last_")
    np.testing.assert_array_equal(obj_mask, jobj_mask)


def test_corner_f1_of_exact_predictions():
    """Predictions placed on the ground-truth walls: both packages' decode
    gives the same, non-zero F1 (the matching path, not just misses)."""
    labels = make_batch(np.random.default_rng(3), 2, 2000)
    K = 8
    ep = {"last_quad_center": np.zeros((2, K, 3), np.float32),
          "last_quad_size": np.ones((2, K, 2), np.float32),
          "last_normal_vector": np.tile(np.float32([1, 0, 0]), (2, K, 1)),
          "last_quad_scores": np.tile(np.float32([0, -4]), (2, K, 1))}
    ep["last_quad_center"][:, :4] = labels["gt_quad_centers"][:, :4]
    ep["last_quad_size"][:, :4] = labels["gt_quad_sizes"][:, :4]
    ep["last_normal_vector"][:, :4] = labels["gt_normal_vectors"][:, :4]
    ep["last_quad_scores"][:, :4] = [-4, 4]
    got = evaluate_quad_f1(ep, labels)
    want = _jax_quad_f1(ep, labels)
    assert want[0] > 0
    _assert_same_decode(got, want)


def test_import_loads_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import omni_pq_torch\n"
        "for m in pkgutil.walk_packages(omni_pq_torch.__path__, "
        "'omni_pq_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(json.dumps(sorted(k for k in sys.modules "
        f"if k.split('.')[0] in {FORBIDDEN!r})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PACKAGE.parent, env=env, check=True,
                         timeout=300)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_jax_import_in_the_package_source():
    """The package, chip_smoke.py and the fake-data writer it loads."""
    paths = [*PACKAGE.rglob("*.py"), PACKAGE.parent / "chip_smoke.py",
             PACKAGE.parent / "tests" / "torch_fake_data.py"]
    for sub in ("native", "utils", "data/scannet.py", "cli/eval.py",
                "train/checkpoint.py"):
        assert any(str(p).startswith(str(PACKAGE / sub)) for p in paths), sub
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(ModelConfig(**SMOKE_MODEL))
    model = build_model(ModelConfig(**SMOKE_MODEL), "cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        load_model(model.state_dict(), ModelConfig(**SMOKE_MODEL))
    torch.save(model.state_dict(), tmp_path / "w.pth")
    np.save(tmp_path / "scene.npy", np.ones((600, 3), np.float32))
    with pytest.raises(RuntimeError, match="cuda"):
        infer_cli.main(["--checkpoint_path", str(tmp_path / "w.pth"),
                        "--input", str(tmp_path / "scene.npy"), "--smoke",
                        "--num_point", "512"])


def test_infer_cli_smoke_on_cpu(tmp_path):
    """cli.infer --device cpu at the --smoke size on a saved .pth laid out as
    the reference saves it ({"model": state_dict}, DDP 'module.' prefix)."""
    cfg = ModelConfig(num_points=512, **SMOKE_MODEL)
    model = build_model(cfg, "cpu", seed=2)
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    torch.save({"model": sd, "epoch": 3}, tmp_path / "ckpt.pth")
    scene = make_scene(np.random.default_rng(0), 2000)
    np.save(tmp_path / "scene.npy", scene["point_clouds"])
    out = tmp_path / "det.json"
    quads, objects = infer_cli.main([
        "--checkpoint_path", str(tmp_path / "ckpt.pth"),
        "--input", str(tmp_path / "scene.npy"), "--output", str(out),
        "--num_point", "512", "--smoke", "--device", "cpu",
        "--quad_conf", "0.0", "--obj_conf", "0.0"])
    saved = json.loads(out.read_text())
    assert set(saved) == {"quads", "objects"}
    assert saved["quads"] == quads and len(quads) > 0 and len(objects) > 0
    assert {"center", "normal", "size", "score"} == set(quads[0])
