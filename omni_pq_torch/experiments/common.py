"""What the port's experiment drivers share: the decode settings, the F1
helpers, the synthetic pools and their protocols, the step over pools on
the device, and the results' writers.

Counterparts in the JAX drivers: `CONFIG_DICT` (scripts/convergence_tpu.py:
37-40, scripts/semi_sup_ab.py:76-79), `quad_f1` (convergence_tpu.py:50-68),
`held_out_f1` and `QUAD_KEYS` (semi_sup_ab.py:184-200), `load_pool`
(:177-185), `center_pool` (`_center_pool`, :139-162), `QUAD_GT_KEYS`
(:166-167) and `make_pool_step` (`make_fused_step`, :203-226).

Pools live on the device, and a step's scene indices are drawn there from a
`torch.Generator` on the same device, so a step makes no host transfer and
waits for nothing: the host waits only where a driver reads a loss or runs
an eval.
"""
from __future__ import annotations

import json
import os
import subprocess
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import DatasetConfig
from ..data.synthetic import SyntheticDataset
from ..evals import (QuadAPCalculator, parse_quad_groundtruths,
                     parse_quad_predictions)

# the drivers' decode settings (no per-class proposals, no quad_thresh key:
# the corner-F1 gates at evals.quad.QUAD_THRES)
CONFIG_DICT = {"remove_empty_box": False, "use_3d_nms": True,
               "nms_iou": 0.25, "use_old_type_nms": False, "cls_nms": True,
               "per_class_proposal": False, "conf_thresh": 0.0,
               "nms_iou_quad": 0.25, "dataset_config": DatasetConfig()}

# the end points the corner-F1 decodes: the only ones fetched to the host
QUAD_KEYS = ("last_quad_center", "last_quad_size", "last_normal_vector",
             "last_quad_scores")

# the rooms of every driver but fitted_mixture: 2.0-2.6 m put ~2 positive
# quad queries on each wall under the fixed 0.3 m NEAR radius
ROOM = dict(num_objects=3, w_range=(2.0, 2.6), d_range=(2.0, 2.6),
            h_range=(2.0, 2.4))

# per-scene absolute-coordinate keys (everything else is relative: votes,
# normals, sizes, masks, augmentation parameters)
ABS_KEYS = ("point_clouds", "ema_point_clouds", "center_label",
            "gt_quad_centers", "horizontal_quads")

# weak-pool keys that ARKit train-split scenes do not have
# (arkitscenes_dataset.py:42-233 returns object boxes only)
QUAD_GT_KEYS = ("gt_quad_centers", "gt_quad_sizes", "gt_normal_vectors",
                "num_gt_quads", "num_total_quads", "horizontal_quads")


def _corner_f1(quads: Mapping[str, np.ndarray], labels: Mapping
               ) -> QuadAPCalculator:
    merged = dict(quads)
    merged.update(labels)
    pred_cls, _, pred_corners = parse_quad_predictions(merged, CONFIG_DICT,
                                                       "last_")
    gt_cls, gt_corners = parse_quad_groundtruths(merged, CONFIG_DICT)
    calc = QuadAPCalculator()
    calc.step(pred_cls, gt_cls, pred_corners, gt_corners,
              list(labels["horizontal_quads"]))
    return calc


def fetch_quads(end_points: Mapping) -> Dict[str, np.ndarray]:
    """The four `QUAD_KEYS` of the end points as float32 numpy arrays."""
    return {k: (v.detach().float().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v)) for k, v in
            ((k, end_points[k]) for k in QUAD_KEYS)}


def quad_f1(end_points: Mapping, labels: Mapping) -> Tuple[float, int, int]:
    """(corner-F1, true positives, false positives) of the `last_` quads
    against the labels (numpy): ap_helper_pq.py:695-736's F1, and each kept
    prediction counted as matched or not."""
    calc = _corner_f1(fetch_quads(end_points), labels)
    f1 = calc.compute_F1(calculated=True)
    tp = fp = 0
    for i in range(calc.scan_cnt):
        for pc_ in calc.pred_corners[i]:
            if calc.compute_correctness(pc_, calc.gt_corners[i]):
                tp += 1
            else:
                fp += 1
    return f1, tp, fp


def held_out_f1(eval_step: Callable, state, clouds: torch.Tensor,
                labels: Mapping, use_ema: bool = False) -> float:
    """The corner-F1 of the state's model (its EMA teacher with `use_ema`)
    in eval mode on held-out clouds against their labels (numpy)."""
    ep = eval_step(state, clouds, use_ema=use_ema)
    return _corner_f1(fetch_quads(ep), labels).compute_F1(calculated=True)


def load_pool(seed: int, n: int, num_points: int = 40000
              ) -> Dict[str, np.ndarray]:
    """n synthetic `ROOM`s of `SyntheticDataset(seed=seed)` stacked by key
    (numpy, `scan_idx` dropped): the JAX package's rooms for the same
    seed."""
    ds = SyntheticDataset(n, num_points, seed=seed, **ROOM)
    scenes = [ds[i] for i in range(n)]
    return {k: np.stack([s[k] for s in scenes]) for k in scenes[0]
            if k != "scan_idx"}


def center_pool(pool: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The reference's ARKit centring (arkitscenes_dataset.py:109-118): each
    scene shifted by the median xy of its cloud, so that it straddles the
    origin; one rigid translation a scene, applied to the cloud, the teacher
    view and every absolute-coordinate label (z stays: floors are at z=0,
    so the ARKit loss's (0, 0, 1) pseudo centre sits mid-wall). Zero
    padding rows of the quad labels stay zero."""
    med = np.median(pool["point_clouds"][..., :2], axis=1)  # (n, 2)
    shift = np.concatenate([med, np.zeros((med.shape[0], 1))],
                           axis=1).astype(np.float32)  # (n, 3)
    out = dict(pool)
    for k in ABS_KEYS:
        v = pool[k]
        s = shift.reshape((v.shape[0],) + (1,) * (v.ndim - 2) + (3,))
        if k in ("gt_quad_centers", "horizontal_quads"):
            valid = (np.abs(v).sum(axis=-1, keepdims=True) > 0)
            out[k] = np.where(valid, v - s, v)
        else:
            out[k] = v - s
    return out


def zero_quad_gt(pool: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The pool with its quad ground truth zeroed: the shape of ARKit
    train-split scenes, which carry object boxes only."""
    return {k: (np.zeros_like(v) if k in QUAD_GT_KEYS else v)
            for k, v in pool.items()}


def draw(pool: Mapping[str, torch.Tensor], bs: int,
         generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """bs distinct scenes of a pool on the device, chosen on the device."""
    n = pool["point_clouds"].shape[0]
    idx = torch.randperm(n, generator=generator,
                         device=generator.device)[:bs]
    return {k: v.index_select(0, idx) for k, v in pool.items()}


def make_pool_step(train_step: Callable, bs: int, semi: bool) -> Callable:
    """fn(state, labeled_pool, weak_pool, consistency_weight, generator) ->
    stats: one train step on bs labeled scenes (and, with `semi`, bs weak
    scenes) drawn from the device pools. The draws and the step take their
    randomness from the one generator, in this order: labeled scenes, weak
    scenes, then the step's (dropout, the gamma criterion)."""

    def pool_step(state, labeled_pool, weak_pool, consistency_weight,
                  generator):
        labeled = draw(labeled_pool, bs, generator)
        weak = draw(weak_pool, bs, generator) if semi else labeled
        return train_step(state, labeled, weak, generator,
                          consistency_weight)

    return pool_step


def backfill_teacher(state) -> None:
    """The teacher := the student, at the fine-tune protocol's resume
    (train.py:167-173): every parameter and BatchNorm buffer copied into
    the teacher's own storage."""
    teacher = state.ema_model.state_dict()
    with torch.no_grad():
        for k, v in state.model.state_dict().items():
            teacher[k].copy_(v)


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    idx = device.index or 0
    lines = out.splitlines()
    return lines[idx] if idx < len(lines) else torch.cuda.get_device_name(idx)


def peak_gib(device: torch.device) -> Optional[float]:
    """The card's peak allocated memory so far, GiB (None on the CPU)."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def write_json(path: str, obj) -> None:
    """obj as indented JSON at path (its directory made)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def write_text(path: str, lines) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def print_result(tag: str, obj) -> None:
    """The run's results on stdout, one line `<tag> <json>`: what comes
    back from a machine whose files do not."""
    print(f"{tag} {json.dumps(obj)}", flush=True)
