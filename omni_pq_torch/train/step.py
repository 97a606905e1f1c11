"""The semi-supervised train step and the eval step (the port of
`omni_pq_tpu/train/step.py`).

One step = the student's train-mode forward (batch-statistic BatchNorm,
running stats updated in place, decoder dropout from the caller's
torch.Generator) on the labeled batch, or on the double batch (labeled ‖
weak) when any semi-supervised loss is on; the EMA teacher's forward on the
double batch's `ema_point_clouds`, in train mode under `torch.no_grad()`
(its BN running stats update in place, as the JAX step's
`new_ema_batch_stats`); the four loss families of the JAX step: supervised
`get_loss` on the labeled half, gamma-mixture pseudo-labels on the weak
half, mean-teacher consistency over the double batch (times the ramped
`consistency_weight`), the ARKit pc loss on the weak half; backward, the
global gradient norm before clipping (`grad_norm`), the clipped AdamW
update, and the EMA update of the teacher.

The generator's draws come in a fixed order: the student's dropout masks,
the teacher's dropout masks, then the gamma criterion's choice of quads and
points (`losses.gamma.draw_choice`). With TrainFlags(ema=False,
gamma_mixture=False, arkit=False) the step is the `sup` baseline of
docs/SEMI_SUP.md. The student computes at its config's compute_dtype;
`teacher_bf16` runs the teacher's forward at bfloat16 compute on the same
float32 EMA parameters and BN state (`models.with_compute_dtype`), and its
end points go to the consistency loss in float32, as the JAX step casts
them; losses stay float32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..infer import eval_forward
from ..models.pointnet2 import with_compute_dtype
from ..losses import (gamma_mixture_guide_criterion, get_arkit_pc_loss,
                      get_consistency_loss, get_loss)
from .state import TrainState, global_norm


@dataclasses.dataclass(frozen=True)
class TrainFlags:
    """Static loss toggles: the JAX package's TrainFlags, with the same
    names and defaults (the reference's semi-supervised configuration)."""
    ema: bool = True
    gamma_mixture: bool = True
    arkit: bool = False
    pc_loss: bool = True
    use_fitted_mixture: bool = False
    # the EMA teacher's forward at bfloat16 compute (its parameters and BN
    # state stay float32; the student and the losses keep their dtype)
    teacher_bf16: bool = False
    ema_decay: float = 0.999
    lambda_metric_normal: float = 5e-4
    lambda_metric_vertical: float = 5e-4
    lambda_metric_size: float = 5e-4
    lambda_metric_score: float = 5e-4
    lambda_arkit_pc_loss: float = 0.0
    near_threshold: float = 0.3
    far_threshold: float = 0.6


SUPERVISED = TrainFlags(ema=False, gamma_mixture=False, arkit=False)


def batch_to_tensors(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy arrays) as tensors on `device`: floats as
    float32, integers as int64, booleans kept."""
    out = {}
    for k, v in batch.items():
        if torch.is_tensor(v):
            out[k] = v.to(device)
            continue
        a = np.asarray(v)
        if a.dtype.kind == "f":
            a = a.astype(np.float32)
        elif a.dtype.kind in "iu":
            a = a.astype(np.int64)
        elif a.dtype.kind != "b":
            continue
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def make_train_step(model, cfg: ModelConfig, mean_size_arr,
                    flags: TrainFlags = SUPERVISED):
    """Returns fn(state, labeled, weak=None, generator=None,
    consistency_weight=0.0) -> stats: one step on `state` (updated in place:
    parameters, optimiser moments, BN running stats of student and
    teacher, the EMA parameters, step). `labeled` and `weak` are batches of
    tensors on the model's device (`batch_to_tensors`); `weak` must be
    given when flags.ema, gamma_mixture or arkit is set, and `generator`
    when cfg.dropout > 0 or gamma_mixture is set. Stats are detached 0-d
    tensors under the JAX step's names: every `get_loss` stat, the gamma,
    consistency and ARKit stats of the flags that are on, `total_loss` and
    `grad_norm` (the global norm before clipping)."""
    num_layer = cfg.num_decoder_layers
    double = flags.ema or flags.gamma_mixture or flags.arkit

    def _teacher_forward(teacher, clouds, generator):
        """The EMA teacher's train-mode forward under no_grad (bfloat16
        compute with teacher_bf16), its floating end points in float32."""
        teacher.train()
        try:
            with torch.no_grad():
                if flags.teacher_bf16:
                    with with_compute_dtype(teacher, torch.bfloat16):
                        ep = teacher(clouds, generator=generator)
                else:
                    ep = teacher(clouds, generator=generator)
        finally:
            teacher.eval()
        return {k: v.float() if v.is_floating_point() else v
                for k, v in ep.items()}

    def train_step(state: TrainState, labeled: Mapping,
                   weak: Optional[Mapping] = None,
                   generator: Optional[torch.Generator] = None,
                   consistency_weight=0.0) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the state holds another model than the step")
        if double and weak is None:
            raise ValueError("ema, gamma_mixture and arkit need a weak batch")
        if flags.ema and state.ema_model is None:
            raise ValueError("flags.ema needs a TrainState with ema=True")
        B = labeled["point_clouds"].shape[0]
        inputs = labeled["point_clouds"]
        if double:
            inputs = torch.cat([inputs, weak["point_clouds"]])
        model.train()
        ep = model(inputs, generator=generator)
        if flags.ema:
            ema_ep = _teacher_forward(
                state.ema_model, torch.cat([labeled["ema_point_clouds"],
                                            weak["ema_point_clouds"]]),
                generator)

        # 1. supervised loss on the labeled half
        merged = {k: v[:B] for k, v in ep.items()}
        merged.update(labeled)
        total, stats = get_loss(merged, mean_size_arr, num_layer=num_layer,
                                pc_loss=flags.pc_loss,
                                near=flags.near_threshold,
                                far=flags.far_threshold)

        # 2. gamma-mixture pseudo-labels on the weak half
        if flags.gamma_mixture:
            gm_ep = {k: v[B:] for k, v in ep.items()}
            gm_ep["point_clouds"] = weak["point_clouds"][..., :3]
            gm_ep["vertex_normals"] = weak["vertex_normals"]
            mn, mv, ms, msc, engaged = gamma_mixture_guide_criterion(
                gm_ep, generator, use_fitted=flags.use_fitted_mixture)
            gm_loss = (flags.lambda_metric_normal * mn
                       + flags.lambda_metric_vertical * mv
                       + flags.lambda_metric_size * ms
                       + flags.lambda_metric_score * msc)
            stats.update(metric_normal=mn, metric_vertical=mv, metric_size=ms,
                         metric_score=msc, gamma_mixture_filter_loss=gm_loss,
                         gamma_engaged_frac=engaged)
            total = total + gm_loss

        # 3. mean-teacher consistency over the full double batch
        if flags.ema:
            cons_ep = dict(ep)
            for key in ("flip_x_axis", "flip_y_axis", "rot_mat", "scale"):
                cons_ep[key] = torch.cat([labeled[key], weak[key]])
            cons_loss, cons_stats = get_consistency_loss(
                cons_ep, ema_ep, mean_size_arr, num_layer=num_layer)
            cons_loss = cons_loss * consistency_weight
            stats.update(cons_stats)
            # cons_stats["consistency_loss"] is the reference's per-prefix
            # object mean; this is the ramped-weight total
            stats["weighted_consistency_loss"] = cons_loss
            total = total + cons_loss

        # 4. ARKit omni-supervised pc loss on the weak half
        if flags.arkit:
            ark_loss, collisions = get_arkit_pc_loss(
                ep, {k: weak[k] for k in ("center_label", "size_label",
                                          "num_gt_boxes")})
            ark_loss = ark_loss * flags.lambda_arkit_pc_loss
            stats["arkit_pc_loss"] = ark_loss
            stats["arkit_collisions"] = collisions
            total = total + ark_loss

        stats["total_loss"] = total
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        with torch.no_grad():
            stats["grad_norm"] = global_norm(
                p.grad for p in model.parameters() if p.grad is not None)
        state.apply_gradients()
        if flags.ema:
            state.ema_update(flags.ema_decay)
        return {k: torch.as_tensor(v).detach() for k, v in stats.items()}

    return train_step


def make_eval_step():
    """Returns fn(state, point_clouds, use_ema=False) -> end_points: the
    eval-mode forward (running BN stats, no dropout) of the state's model or
    of its EMA replica."""

    def eval_step(state: TrainState, point_clouds, use_ema: bool = False):
        model = state.ema_model if use_ema else state.model
        if model is None:
            raise ValueError("use_ema=True on a TrainState without an EMA "
                             "replica")
        was_training = model.training
        model.eval()
        try:
            return eval_forward(model, point_clouds)
        finally:
            model.train(was_training)

    return eval_step
