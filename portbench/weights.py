"""The benchmark's weights, made from the seed on the device.

The port's initialisation (flax's lecun_normal on every 1x1 convolution,
linear and attention projection: a normal truncated at two standard
deviations, scaled to variance 1/fan_in; biases 0; BatchNorm and LayerNorm
scale 1 and bias 0, running statistics 0 and 1), drawn in one call of a
generator on the device and cut into the parameters of a reference model.
Each model's check (`reference/<model>_check.py`) builds its reference
with its published parameter layout, fills it here and hands its
state_dict to both sides of the comparison: the program loads it through
its own entry point, the reference through `load_state_dict`.
"""
from __future__ import annotations

import math

import torch

# the standard deviation of a unit normal truncated to [-2, 2]
TRUNC_NORMAL_STD = 0.87962566103423978


def weight_seed(seed: int) -> int:
    """The weights' generator seed: a stream of its own for each run seed."""
    return (seed * 2654435761 + 0x5EED) % (2 ** 63)


@torch.no_grad()
def fill(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Fill `model`'s parameters in place from `seed` (on its device)."""
    params = [(n, p) for n, p in model.named_parameters()]
    drawn = [p for n, p in params if p.dim() >= 2]
    flat = torch.empty(sum(p.numel() for p in drawn), device=drawn[0].device)
    gen = torch.Generator(device=flat.device).manual_seed(weight_seed(seed))
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    at = 0
    for p in drawn:
        n = p.numel()
        std = math.sqrt(1.0 / p.shape[1]) / TRUNC_NORMAL_STD
        p.copy_(flat[at:at + n].view_as(p) * std)
        at += n
    for name, p in params:
        if p.dim() == 1:
            p.fill_(1.0 if name.endswith("weight") else 0.0)
    for name, b in model.named_buffers():
        if name.endswith("running_mean"):
            b.zero_()
        elif name.endswith("running_var"):
            b.fill_(1.0)
    return model
