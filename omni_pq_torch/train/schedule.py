"""LR schedule and consistency ramp (the port of
`omni_pq_tpu/train/schedule.py`).

The reference's utils/lr_scheduler.py: per-iteration CosineAnnealingLR with
T_max=(max_epoch-warmup)*iters_per_epoch and eta_min=1e-6, optionally wrapped
in GradualWarmupScheduler (lr = base/mult * ((mult-1)*t/warmup + 1) for
t <= warmup). The arithmetic is float32, as the JAX package's jnp schedule.
Consistency-weight sigmoid rampup: train.py:441-454.
"""
from __future__ import annotations

import numpy as np

ETA_MIN = 1e-6


def warmup_cosine(base_lr: float, total_steps: int, warmup_steps: int = 0,
                  warmup_multiplier: float = 100.0, eta_min: float = ETA_MIN):
    """Returns a schedule fn step -> lr (a Python float)."""
    cosine_steps = max(total_steps - warmup_steps, 1)

    def schedule(step) -> float:
        step = np.float32(step)
        cos_t = np.clip(step - warmup_steps, 0, cosine_steps).astype(
            np.float32)
        cos_lr = eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + np.cos(np.pi * cos_t / cosine_steps))
        if warmup_steps <= 0:
            return float(cos_lr)
        warm_lr = base_lr / warmup_multiplier * (
            (warmup_multiplier - 1.0) * step / warmup_steps + 1.0)
        return float(warm_lr if step <= warmup_steps else cos_lr)

    return schedule


def consistency_weight(epoch: float, base_weight: float, rampup_epochs: int):
    """Sigmoid rampup exp(-5(1-t)^2) (train.py:441-454)."""
    if rampup_epochs == 0:
        return base_weight
    t = float(np.clip(epoch, 0.0, rampup_epochs)) / rampup_epochs
    return base_weight * float(np.exp(-5.0 * (1.0 - t) ** 2))
