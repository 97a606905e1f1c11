"""The benchmark's weights, made from the seed on the device.

The published model's parameter layout (the reference's module tree) with
the initialisation the port's `infer.build_model` uses (flax's
lecun_normal on every 1x1 convolution, linear and attention projection: a
normal truncated at two standard deviations, scaled to variance 1/fan_in;
biases 0; BatchNorm and LayerNorm scale 1 and bias 0, running statistics
0 and 1), drawn in one call of a generator on the device and cut into the
parameters. Both sides of the comparison get the same state_dict: the
program loads it through its `infer.load_model`, the reference through
`load_state_dict`.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.pq_transformer import PQTransformer

# the standard deviation of a unit normal truncated to [-2, 2]
TRUNC_NORMAL_STD = 0.87962566103423978


def weight_seed(seed: int) -> int:
    """The weights' generator seed: a stream of its own for each run seed."""
    return (seed * 2654435761 + 0x5EED) % (2 ** 63)


@torch.no_grad()
def fill(model: PQTransformer, seed: int) -> PQTransformer:
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


def reference_model(cfg: Dict, seed: int, device, low: bool = False
                    ) -> PQTransformer:
    """The reference PQ-Transformer at `cfg` on `device`, with the seed's
    weights, in eval mode (held in float64 where `cfg` computes in it)."""
    with torch.device(device):
        model = PQTransformer(cfg, low=low)
    model = fill(model, seed).eval()
    return model.double() if cfg["compute_dtype"] == "float64" else model


def state_dict(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seed's weights under the published state_dict names."""
    return reference_model(cfg, seed, device).state_dict()
