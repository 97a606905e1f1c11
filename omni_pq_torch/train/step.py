"""The supervised train step and the eval step (the port of
`omni_pq_tpu/train/step.py`).

One step = the train-mode forward (batch-statistic BatchNorm, running stats
updated in place, decoder dropout from the caller's torch.Generator), the
supervised loss `get_loss` on the labeled batch, backward, the global
gradient norm before clipping (`grad_norm`), and the clipped AdamW update.
This is the `sup` baseline of docs/SEMI_SUP.md: TrainFlags(ema=False,
gamma_mixture=False, arkit=False). The semi-supervised parts of the JAX step
(EMA-teacher consistency, gamma-mixture pseudo-labels, ARKit pc loss, a
bfloat16 teacher) are not ported yet, and flags that ask for them raise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..infer import eval_forward
from ..losses import get_loss
from .state import TrainState, global_norm


@dataclasses.dataclass(frozen=True)
class TrainFlags:
    """Static loss toggles: the JAX package's TrainFlags fields that the
    supervised step reads or must refuse, with the same names and defaults.
    Fields of the semi-supervised losses come with the slice that reads
    them."""
    ema: bool = True
    gamma_mixture: bool = True
    arkit: bool = False
    pc_loss: bool = True
    teacher_bf16: bool = False
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
    """Returns fn(state, labeled, generator=None) -> stats: one supervised
    step on `state` (updated in place: parameters, optimiser moments, BN
    running stats, step). `labeled` is a batch of tensors on the model's
    device (`batch_to_tensors`); `generator` draws the dropout masks and
    must be given when cfg.dropout > 0. Stats are detached 0-d tensors:
    every `get_loss` stat, `total_loss` and `grad_norm` (the global norm
    before clipping)."""
    for name in ("ema", "gamma_mixture", "arkit", "teacher_bf16"):
        if getattr(flags, name):
            raise NotImplementedError(
                f"TrainFlags.{name}=True: the port's train step runs the "
                "supervised baseline only (ema, gamma_mixture, arkit and "
                "teacher_bf16 all False)")
    num_layer = cfg.num_decoder_layers

    def train_step(state: TrainState, labeled: Mapping,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the state holds another model than the step")
        model.train()
        ep = model(labeled["point_clouds"], generator=generator)
        merged = dict(ep)
        merged.update(labeled)
        loss, stats = get_loss(merged, mean_size_arr, num_layer=num_layer,
                               pc_loss=flags.pc_loss,
                               near=flags.near_threshold,
                               far=flags.far_threshold)
        stats["total_loss"] = loss
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        with torch.no_grad():
            stats["grad_norm"] = global_norm(
                p.grad for p in model.parameters() if p.grad is not None)
        state.apply_gradients()
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
