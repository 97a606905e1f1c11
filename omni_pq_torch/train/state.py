"""Train state: the model, its optimiser, the step count and the optional
EMA replica (the port of `omni_pq_tpu/train/state.py`).

The optimiser mirrors the reference's train.py:364-374 as the JAX package
builds it with optax: AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay 5e-4)
with two learning-rate groups, parameters whose top-level module name
contains 'decoder' at the decoder LR (1e-4) and all others at the base LR
(2e-3); one global-norm gradient clip (0.1) over all parameters before the
update (train.py:565-566); --step_freq > 1 accumulates the running mean of
that many gradients and updates on the last (optax.MultiSteps). The
arithmetic is optax's, written out in torch:
    g    <- g * (1 if |g| < clip else clip / |g|)    (|g| over all params)
    mu   <- (1-b1) g + b1 mu;  nu <- (1-b2) g^2 + b2 nu
    u    <- (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t)) + eps) + wd * p
    p    <- p - lr(t-1) * u
so it is not torch.optim.AdamW (which orders the decay and the bias
corrections differently). It runs as multi-tensor (`torch._foreach_*`)
ops, a few launches a step instead of several per parameter.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .schedule import warmup_cosine


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 2e-3
    decoder_learning_rate: float = 1e-4
    weight_decay: float = 5e-4
    clip_norm: float = 0.1
    total_steps: int = 100000
    warmup_steps: int = 0
    warmup_multiplier: float = 100.0
    step_freq: int = 1


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every element of every tensor, as the
    root of the per-tensor norms' squares (one multi-tensor launch)."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(list(tensors))))


def is_decoder_param(name: str) -> bool:
    """The JAX package's label_fn: the top-level module name holds
    'decoder' (decoder layers and their position embeddings, the query/key
    projections)."""
    return "decoder" in name.split(".")[0]


class AdamW(torch.optim.Optimizer):
    """optax.chain(clip_by_global_norm, multi_transform({base, decoder}:
    adamw)), wrapped in MultiSteps when step_freq > 1. `step()` reads the
    parameters' .grad (None counts as zero) and returns nothing."""

    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]],
                 cfg: OptimizerConfig):
        base, dec = [], []
        for name, p in named_params:
            (dec if is_decoder_param(name) else base).append(p)
        sched = dict(total_steps=cfg.total_steps,
                     warmup_steps=cfg.warmup_steps,
                     warmup_multiplier=cfg.warmup_multiplier)
        groups = [
            dict(params=base, name="base",
                 schedule=warmup_cosine(cfg.learning_rate, **sched)),
            dict(params=dec, name="decoder",
                 schedule=warmup_cosine(cfg.decoder_learning_rate, **sched))]
        super().__init__([g for g in groups if g["params"]],
                         dict(b1=0.9, b2=0.999, eps=1e-8,
                              weight_decay=cfg.weight_decay))
        self.clip_norm = cfg.clip_norm
        self.step_freq = cfg.step_freq
        self.count = 0      # updates applied (optax's inner count)
        self.mini_step = 0  # gradients accumulated toward the next update

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self.step_freq > 1:
            accs = [self.state[p].setdefault("acc", torch.zeros_like(p))
                    for p in params]
            diffs = torch._foreach_sub(grads, accs)
            torch._foreach_div_(diffs, float(self.mini_step + 1))
            torch._foreach_add_(accs, diffs)
            self.mini_step += 1
            if self.mini_step < self.step_freq:
                return None
            grads = [a.clone() for a in accs]
            torch._foreach_zero_(accs)
            self.mini_step = 0
        # the clip as a factor, so the host never waits for the norm
        norm = global_norm(grads)
        factor = torch.where(norm < self.clip_norm, 1.0,
                             self.clip_norm / norm)
        grads = torch._foreach_mul(grads, factor)
        by_param = dict(zip(map(id, params), grads))
        t = self.count + 1
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            lr = group["schedule"](self.count)
            bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
            bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
            ps = group["params"]
            gs = [by_param[id(p)] for p in ps]
            for p in ps:
                if "mu" not in self.state[p]:
                    self.state[p]["mu"] = torch.zeros_like(p)
                    self.state[p]["nu"] = torch.zeros_like(p)
            mus = [self.state[p]["mu"] for p in ps]
            nus = [self.state[p]["nu"] for p in ps]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(gs, 1 - b1))
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(
                torch._foreach_mul(gs, gs), 1 - b2))
            denom = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
            torch._foreach_add_(denom, eps)
            u = torch._foreach_div(torch._foreach_div(mus, bc1), denom)
            torch._foreach_add_(u, torch._foreach_mul(ps, group["weight_decay"]))
            torch._foreach_add_(ps, torch._foreach_mul(u, -lr))
        self.count += 1
        return None


class TrainState:
    """The model being trained, its optimiser, the step count (every
    `apply_gradients` call, as the JAX TrainState.step) and, with
    `ema=True`, an EMA replica of the model (a deep copy: parameters and
    BatchNorm statistics)."""

    def __init__(self, model: nn.Module, opt_cfg: OptimizerConfig,
                 ema: bool = False):
        self.model = model
        self.optimizer = AdamW(model.named_parameters(), opt_cfg)
        self.step = 0
        self.ema_model: Optional[nn.Module] = (
            copy.deepcopy(model).eval() if ema else None)

    def apply_gradients(self) -> None:
        """One optimiser step from the parameters' .grad."""
        self.optimizer.step()
        self.step += 1

    @torch.no_grad()
    def ema_update(self, decay: float) -> None:
        """update_ema_variables (train.py:435-439): alpha ramps with the
        step, alpha = min(1 - 1/(step+1), decay); ema = alpha*ema +
        (1-alpha)*param over the parameters."""
        if self.ema_model is None:
            raise ValueError("this TrainState has no EMA replica")
        alpha = float(min(np.float32(1.0) - np.float32(1.0)
                          / (np.float32(self.step) + np.float32(1.0)),
                          np.float32(decay)))
        for e, p in zip(self.ema_model.parameters(), self.model.parameters()):
            e.copy_(alpha * e + (1.0 - alpha) * p)
