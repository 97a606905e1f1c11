"""The port's serving path: build or load a model, run the eval forward, and
score the decoded quads with the corner-F1.

`eval_forward` is the JAX package's `train/step.py::make_eval_step` (eval-mode
BatchNorm, no dropout); `evaluate_quad_f1` is the decode + F1 loop of its
`cli/train.py::evaluate` for one batch. Entry points take `device` and run on
"cuda" unless the caller passes "cpu"; asking for "cuda" without a card
raises. The model computes at its config's `compute_dtype`; its parameters
are float32, or float64 for `compute_dtype="float64"` (a built model, or a
loaded float64 state_dict), and a loaded float32 state_dict stays float32
under any compute dtype (cast up where it is used, as flax does).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

from .config import DatasetConfig, ModelConfig, ThreeDETRConfig
from .evals import (QuadAPCalculator, parse_quad_groundtruths,
                    parse_quad_predictions)
from .models import MultiHeadAttention, PQTransformer
from .models.pointnet2 import Conv, acc_dtype, torch_dtype
from .models.three_detr import FourierEmbedding, ThreeDETR
from .utils.trace import span

# the eval decode settings of the JAX package's cli/train.py::evaluate
EVAL_CONFIG = {"remove_empty_box": False, "use_3d_nms": True,
               "nms_iou": 0.25, "use_old_type_nms": False, "cls_nms": True,
               "per_class_proposal": True, "conf_thresh": 0.0,
               "quad_thresh": 0.5, "dataset_config": DatasetConfig(),
               "nms_iou_quad": 0.25}


def resolve_device(device) -> torch.device:
    """torch.device(device), raising if it is a CUDA device and no card is
    visible (the port never falls back to the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but torch sees no "
                           "CUDA card; pass device='cpu' to run on the CPU")
    return device


# the standard deviation of a unit normal truncated to [-2, 2]: flax's
# variance_scaling divides its truncated draws' scale by it
TRUNC_NORMAL_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's `nn.initializers.lecun_normal()` (nn.Dense's default kernel
    init) on a weight of shape (out, in, ...): a normal truncated at two of
    its standard deviations, scaled so that the variance is 1/fan_in."""
    std = math.sqrt(1.0 / weight.shape[1]) / TRUNC_NORMAL_STD
    torch.nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=generator)


@torch.no_grad()
def init_weights(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Random weights from `generator`: every 1x1 conv / linear / attention
    projection from flax's lecun_normal (`lecun_normal_`), biases 0; a
    Fourier embedding's Gaussian matrix as the published 3DETR draws it.
    BatchNorm and LayerNorm keep their constructor values (scale 1, bias 0,
    running stats 0/1)."""
    for m in model.modules():
        if isinstance(m, Conv):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, MultiHeadAttention):
            lecun_normal_(m.in_proj_weight, generator)
            m.in_proj_bias.zero_()
        elif isinstance(m, FourierEmbedding):
            m.reset(generator)


def _model(cfg) -> torch.nn.Module:
    """The model a configuration describes: a `ThreeDETR` for a
    `ThreeDETRConfig`, else a `PQTransformer`."""
    return ThreeDETR(cfg) if isinstance(cfg, ThreeDETRConfig) else (
        PQTransformer(cfg))


def build_model(cfg: ModelConfig = ModelConfig(), device="cuda",
                seed: int = 0) -> PQTransformer:
    """An eval-mode PQTransformer at `cfg` (its compute_dtype included), or
    a ThreeDETR for a `ThreeDETRConfig`, with random float32 weights made on
    the CPU from `seed` (the same weights on every device and in every
    compute dtype; float64 parameters holding them under float64), moved to
    `device`."""
    device = resolve_device(device)
    model = _model(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    if cfg.compute_dtype == "float64":
        model.double()
    return model.to(device).eval()


def load_model(state_dict: Mapping[str, torch.Tensor],
               cfg: ModelConfig = ModelConfig(), device="cuda") -> PQTransformer:
    """An eval-mode PQTransformer at `cfg` (its compute_dtype included), or
    a ThreeDETR for a `ThreeDETRConfig`, holding a reference-layout
    state_dict (a DDP 'module.' prefix is stripped), on `device`. Its
    parameters take the state_dict's type: a float64 one (a float64 flax
    tree, `interop.flax_to_state_dict`) makes a float64 model, with no cast
    to float32 on the way."""
    device = resolve_device(device)
    if any(k.startswith("module.") for k in state_dict):
        state_dict = {k.removeprefix("module."): v
                      for k, v in state_dict.items()}
    model = _model(cfg)
    if any(v.dtype == torch.float64 for v in state_dict.values()):
        model.double()
    model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval()


def eval_forward(model: PQTransformer, point_clouds) -> Dict[str, torch.Tensor]:
    """The eval-mode forward on (B, N, 3+C) clouds (a tensor or an array),
    on the model's device, at the model's compute dtype. The clouds are
    taken as float32, or float64 under float64 (`acc_dtype`: the JAX
    package's float64 route takes float64 clouds). While a profiler runs,
    it records the `utils.trace` span `eval.forward` around it."""
    with span("eval.forward"):
        device = next(model.parameters()).device
        dtype = acc_dtype(torch_dtype(model.cfg.compute_dtype))
        pc = torch.as_tensor(point_clouds, dtype=dtype, device=device)
        with torch.inference_mode():
            return model(pc)


def evaluate_quad_f1(end_points: Mapping, labels: Mapping) -> Dict:
    """Decode the `last_` quads with NMS and score them against the batch's
    quad labels: the corner-matching F1 with synthesised ceilings/floors
    (`QuadAPCalculator.compute_F1(calculated=True)`).

    Returns {"f1", "pred_mask" (B, K), "pred_corners" (per scene, a list of
    (4, 3) corner arrays)}. bfloat16 end points are decoded as float32,
    float32 and float64 ones as they are."""
    ep = {k: ((v.detach().float() if v.dtype == torch.bfloat16 else v)
              .cpu().numpy() if torch.is_tensor(v) else v)
          for k, v in end_points.items()}
    merged = {**ep, **labels}
    pred_cls, pred_mask, pred_corners = parse_quad_predictions(
        merged, EVAL_CONFIG, "last_")
    gt_cls, gt_corners = parse_quad_groundtruths(merged, EVAL_CONFIG)
    calc = QuadAPCalculator(ap_iou_thresh=0.25)
    calc.step(pred_cls, gt_cls, pred_corners, gt_corners,
              list(labels["horizontal_quads"]))
    return {"f1": calc.compute_F1(calculated=True), "pred_mask": pred_mask,
            "pred_corners": pred_corners}
