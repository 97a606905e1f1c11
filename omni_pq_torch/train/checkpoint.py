"""Checkpoints as `.pth` files (the port of `omni_pq_tpu/train/checkpoint.py`).

One file per tag, `<log_dir>/ckpt_epoch_{tag}.pth`, laid out as the
reference saves it (train.py:153-207): `model` and `ema_model` (state
dicts), `optimizer`, `scheduler` and `epoch`; beside them the port's `step`
(the TrainState's count of updates) and the `tag`, stored in the payload as
the JAX package stores its tag code. The optimiser's moments are keyed by
parameter name: {"state": {name: {"mu", "nu"[, "acc"]}}, "count",
"mini_step"}; `scheduler` records the position of the LR schedule, which
is a function of the optimiser's count ({"last_epoch": count}).

Loading restores into an existing TrainState in place, with the epoch
sentinels of the reference (train.py:157-160): tag 'last' -> epoch 600,
'best' and 'ema_best' -> 0. A file without `ema_model` (a supervised
reference checkpoint) backfills the teacher from the student, its DDP
'module.' prefix stripped (train.py:167-173); a file whose `optimizer` is
not in the port's layout (a reference checkpoint) leaves the optimiser as
it is.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, Tuple

import torch

from .state import TrainState

TAGS = ("", "best", "ema_best", "last")


def _strip_module(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k.removeprefix("module."): v for k, v in sd.items()}


def checkpoint_path(log_dir: str, tag) -> str:
    return os.path.join(log_dir, f"ckpt_epoch_{tag}.pth")


def optimizer_state(state: TrainState) -> Dict:
    """The AdamW moments (and accumulated gradients) keyed by parameter
    name, with the update and accumulation counts."""
    opt = state.optimizer
    moments = {name: {k: v.detach().cpu().clone()
                      for k, v in opt.state[p].items()}
               for name, p in state.model.named_parameters()
               if p in opt.state}
    return {"state": moments, "count": opt.count,
            "mini_step": opt.mini_step}


def load_optimizer_state(state: TrainState, payload: Mapping) -> None:
    opt = state.optimizer
    params = dict(state.model.named_parameters())
    unknown = set(payload["state"]) - set(params)
    if unknown:
        raise KeyError(f"optimizer state for unknown parameters: "
                       f"{sorted(unknown)[:5]}")
    opt.state.clear()
    for name, moments in payload["state"].items():
        p = params[name]
        opt.state[p] = {k: v.to(device=p.device, dtype=p.dtype).clone()
                        for k, v in moments.items()}
    opt.count = int(payload["count"])
    opt.mini_step = int(payload["mini_step"])


def save_checkpoint(log_dir: str, tag, state: TrainState, epoch: int) -> str:
    """tag: an epoch number or 'best' / 'ema_best' / 'last'. Returns the
    file's path."""
    tag = str(tag)
    teacher = state.ema_model if state.ema_model is not None else state.model
    payload = {
        "model": state.model.state_dict(),
        "ema_model": teacher.state_dict(),
        "optimizer": optimizer_state(state),
        "scheduler": {"last_epoch": state.optimizer.count},
        "epoch": int(epoch),
        "step": int(state.step),
        "tag": tag if tag in TAGS else "",
    }
    os.makedirs(log_dir, exist_ok=True)
    path = checkpoint_path(log_dir, tag)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, state: TrainState
                    ) -> Tuple[TrainState, int, str]:
    """Restore `path` into `state` (student, teacher, optimiser, step);
    returns (state, epoch, tag) with tag '' (a periodic checkpoint),
    'best', 'ema_best' or 'last' and the epoch sentinels of the reference."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    student = _strip_module(payload["model"])
    state.model.load_state_dict(student)
    if state.ema_model is not None:
        teacher = payload.get("ema_model")
        state.ema_model.load_state_dict(
            _strip_module(teacher) if teacher is not None else student)
    opt = payload.get("optimizer")
    if isinstance(opt, Mapping) and "count" in opt:
        load_optimizer_state(state, opt)
    state.step = int(payload.get("step", state.step))
    epoch = int(payload.get("epoch", 0))
    tag = payload.get("tag", "")
    if tag == "last":
        epoch = 600
    elif tag in ("best", "ema_best"):
        epoch = 0
    return state, epoch, tag
