"""Plain PyTorch reference of the Omni-PQ train step: the student's
train-mode forward (batch-statistic BatchNorm, running stats moved in
place, decoder dropout), the EMA teacher's train-mode forward under no_grad,
the four loss families, the backward, the global-norm clip, AdamW and the
EMA update.

The arithmetic of the published train.py (lines 364-374, 435-439,
565-566) as the JAX package writes it with optax, and as
`omni_pq_torch/train/{step,state}.py` at commit
4c1c1dacbb14fd55b2b315e6b58815882cf32f9c does:
    g    <- g * min(1, clip / |g|)             (|g| over all parameters)
    mu   <- (1-b1) g + b1 mu;  nu <- (1-b2) g^2 + b2 nu
    p    <- p - lr(t-1) ((mu / (1-b1^t)) / (sqrt(nu / (1-b2^t)) + eps) + wd p)
b1 0.9, b2 0.999, eps 1e-8, weight decay 5e-4, clip 0.1; the learning rate
2e-3, or 1e-4 for parameters whose top-level module name holds 'decoder',
on a cosine from step 0 of `total_steps` down to 1e-6; the bias
corrections and the rates in float32. EMA: alpha = min(1 - 1/(t+1),
decay) after the t-th update, teacher = alpha teacher + (1-alpha) student
over the parameters (the BatchNorm buffers move in the teacher's own
forward). The generator's draws come in the program's order: the student's
dropout masks, the teacher's, then the gamma criterion's quad and points.
"""
from __future__ import annotations

import copy
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .pq_transformer_losses import (consistency_loss, gamma_criterion,
                                    supervised_loss)

B1, B2, EPS = 0.9, 0.999, 1e-8
ETA_MIN = 1e-6


def cosine_lr(base: float, total: int, step: int) -> float:
    t = np.float32(min(max(step, 0), total))
    return float(ETA_MIN + (base - ETA_MIN) * 0.5 * (
        1.0 + np.cos(np.pi * t / max(total, 1))))


def bias_correction(decay: float, t: int) -> float:
    return float(np.float32(1) - np.float32(decay) ** np.float32(t))


class Trainer:
    """A student, its optimiser state and (with `flags['ema']`) its EMA
    teacher; `step` runs one update in place and returns the total loss
    (the supervised loss's terms are kept in `parts`). `opt` holds
    learning_rate, decoder_learning_rate, weight_decay, clip_norm and
    total_steps; `flags` the traffic file's loss switches."""

    def __init__(self, model: torch.nn.Module, opt: Mapping, flags: Mapping):
        self.model, self.opt, self.flags = model, opt, flags
        self.teacher = copy.deepcopy(model) if flags["ema"] else None
        self.names = [n for n, _ in model.named_parameters()]
        self.mu = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
        self.nu = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
        self.count = 0
        self.clipped_grads: Dict[str, torch.Tensor] = {}

    def _teacher_forward(self, clouds, generator):
        self.teacher.train()
        with torch.no_grad():
            ep = self.teacher(clouds, generator=generator)
        self.teacher.eval()
        return ep

    def loss(self, labeled: Mapping, weak: Optional[Mapping],
             generator, consistency_weight: float) -> torch.Tensor:
        flags = self.flags
        L = self.model.cfg["num_decoder_layers"]
        B = labeled["point_clouds"].shape[0]
        double = flags["ema"] or flags["gamma_mixture"]
        inputs = labeled["point_clouds"]
        if double:
            inputs = torch.cat([inputs, weak["point_clouds"]])
        self.model.train()
        ep = self.model(inputs, generator=generator)
        if flags["ema"]:
            ema_ep = self._teacher_forward(
                torch.cat([labeled["ema_point_clouds"],
                           weak["ema_point_clouds"]]), generator)
            ema_ep = {k: v.to(torch.promote_types(v.dtype, torch.float32))
                      if v.is_floating_point() else v
                      for k, v in ema_ep.items()}
        merged = {k: v[:B] for k, v in ep.items()}
        merged.update(labeled)
        self.parts = {}
        total = supervised_loss(merged, L, flags["pc_loss"], self.parts)
        if flags["gamma_mixture"]:
            mets = gamma_criterion({k: v[B:] for k, v in ep.items()},
                                   weak["point_clouds"][..., :3],
                                   weak["vertex_normals"], generator)
            lam = (flags["lambda_metric_normal"],
                   flags["lambda_metric_vertical"],
                   flags["lambda_metric_size"], flags["lambda_metric_score"])
            total = total + sum(w * m for w, m in zip(lam, mets))
        if flags["ema"]:
            aug = {k: torch.cat([labeled[k], weak[k]])
                   for k in ("flip_x_axis", "flip_y_axis", "rot_mat",
                             "scale")}
            total = total + consistency_weight * consistency_loss(
                ep, ema_ep, aug, L)
        return total

    def step(self, labeled, weak, generator, consistency_weight) -> float:
        total = self.loss(labeled, weak, generator, consistency_weight)
        self.model.zero_grad(set_to_none=True)
        total.backward()
        self.update()
        return float(total.detach())

    @torch.no_grad()
    def update(self) -> None:
        params = dict(self.model.named_parameters())
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        factor = min(1.0, self.opt["clip_norm"] / float(norm))
        t = self.count + 1
        bc1, bc2 = bias_correction(B1, t), bias_correction(B2, t)
        for n, p in params.items():
            g = grads[n] * factor
            self.clipped_grads[n] = g
            self.mu[n] = B1 * self.mu[n] + (1 - B1) * g
            self.nu[n] = B2 * self.nu[n] + (1 - B2) * g * g
            base = (self.opt["decoder_learning_rate"]
                    if "decoder" in n.split(".")[0]
                    else self.opt["learning_rate"])
            lr = cosine_lr(base, self.opt["total_steps"], self.count)
            u = ((self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + EPS)
                 + self.opt["weight_decay"] * p)
            p.sub_(lr * u)
        self.count += 1
        if self.teacher is not None:
            alpha = float(min(np.float32(1.0) - np.float32(1.0)
                              / (np.float32(self.count) + np.float32(1.0)),
                              np.float32(self.flags["ema_decay"])))
            for e, p in zip(self.teacher.parameters(),
                            self.model.parameters()):
                e.copy_(alpha * e + (1.0 - alpha) * p)
