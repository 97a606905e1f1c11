"""Inference driver: one checkpoint + one point cloud (.npy or .ply) ->
layout quads + object boxes as JSON, and with --dump_ply the input cloud
and the confident quads as PLY files (the port of
`omni_pq_tpu/cli/infer.py`).

The checkpoint is a `.pth` holding a reference-layout state_dict, either
bare or under "model" as the reference and the train CLI save it (a DDP
'module.' prefix is stripped); a file tagged 'ema_best' gives its teacher
(`ema_model`), as the JAX CLI does. Runs on the card unless `--device cpu`
is given. The model computes in bfloat16, as the JAX infer CLI always does
(its parameters stay float32); `--bf16` is accepted and changes nothing.

Run:  python -m omni_pq_torch.cli.infer --checkpoint_path best.pth \
          --input scene.ply --output out.json [--dump_ply out_dir]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def load_cloud(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)[:, :3].astype(np.float32)
    if path.endswith(".ply"):
        from ..data.preprocess import read_ply_xyzrgb
        return read_ply_xyzrgb(path)[:, :3].astype(np.float32)
    raise ValueError(f"unsupported input {path} (expected .npy or .ply)")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_path", required=True,
                        help=".pth with a reference-layout state_dict")
    parser.add_argument("--input", required=True,
                        help=".npy (N, 3+) or .ply cloud")
    parser.add_argument("--output", default="detections.json")
    parser.add_argument("--dump_ply", default=None,
                        help="directory for input.ply and the quads' PLY")
    parser.add_argument("--num_point", type=int, default=40000)
    parser.add_argument("--quad_conf", type=float, default=0.5)
    parser.add_argument("--obj_conf", type=float, default=0.5)
    parser.add_argument("--nms_iou_quad", type=float, default=0.25)
    parser.add_argument("--smoke", action="store_true",
                        help="the tiny --smoke model of the train CLI")
    parser.add_argument("--bf16", action="store_true",
                        help="accepted for the JAX CLI's scripts: the model "
                             "computes in bfloat16 either way")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from ..config import SMOKE_MODEL, DatasetConfig, ModelConfig
    from ..data.spatial import spatial_sort
    from ..evals import parse_predictions, parse_quad_predictions
    from ..evals.quad import softmax
    from ..infer import eval_forward, load_model, resolve_device

    device = resolve_device(args.device)
    cfg = ModelConfig(num_points=args.num_point, compute_dtype="bfloat16",
                      **(SMOKE_MODEL if args.smoke else {}))
    payload = torch.load(args.checkpoint_path, map_location="cpu",
                         weights_only=True)
    state_dict = payload
    if "model" in payload:
        state_dict = payload["ema_model" if payload.get("tag") == "ema_best"
                             else "model"]
    model = load_model(state_dict, cfg, device)

    pts = load_cloud(args.input)
    rng = np.random.default_rng(0)
    choice = rng.choice(pts.shape[0], args.num_point,
                        replace=pts.shape[0] < args.num_point)
    pts = pts[choice]
    pts = pts[spatial_sort(pts)]
    ep = eval_forward(model, pts[None])
    ep = {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
          for k, v in ep.items()}

    config_dict = {"nms_iou_quad": args.nms_iou_quad, "conf_thresh": 0.0,
                   "use_old_type_nms": False, "dataset_config": DatasetConfig(),
                   "remove_empty_box": False, "use_3d_nms": True,
                   "cls_nms": True, "per_class_proposal": False,
                   "nms_iou": 0.25}
    _, quad_mask, _ = parse_quad_predictions(ep, config_dict, "last_")
    obj_pred, _ = parse_predictions(ep, config_dict, "last_")

    quad_prob = softmax(ep["last_quad_scores"])[0, :, 1]
    quads = [{"center": ep["last_quad_center"][0, j].tolist(),
              "normal": ep["last_normal_vector"][0, j].tolist(),
              "size": ep["last_quad_size"][0, j].tolist(),
              "score": float(quad_prob[j])}
             for j in range(quad_prob.shape[0])
             if quad_mask[0, j] == 1 and quad_prob[j] > args.quad_conf]
    objects = [{"class": int(c), "corners": np.asarray(box).tolist(),
                "score": float(s)}
               for (c, box, s) in obj_pred[0] if s > args.obj_conf]

    with open(args.output, "w") as f:
        json.dump({"quads": quads, "objects": objects}, f, indent=2)
    print(f"{len(quads)} quads, {len(objects)} objects -> {args.output}")

    if args.dump_ply:
        from ..utils.viz import dump_quad_results, write_ply_points
        os.makedirs(args.dump_ply, exist_ok=True)
        write_ply_points(pts, os.path.join(args.dump_ply, "input.ply"))
        dump_quad_results(ep, args.dump_ply, conf_thresh=args.quad_conf)
    return quads, objects


if __name__ == "__main__":
    main()
