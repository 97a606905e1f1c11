"""The least time of the fused SA-MLP kernel in one forward: its work is
one Dense chain over every grouped row of the SA layers it takes (the
layers whose MLP widths are multiples of 128 and whose sample count is a
multiple of 8 in float32, 16 in bfloat16: the routing rule of the
program's `ops.fused_mlp.supports` at commit
4c1c1dacbb14fd55b2b315e6b58815882cf32f9c; vote aggregation's 288 stays
unfused), at the compute dtype's peak; its bytes are the grouped rows and
weights read once and the pooled rows written once (chip_smoke.py's kernel
table counts so). In train mode a call also writes the batch means and
variances; the backward is not the kernel's."""
from __future__ import annotations

from typing import Dict

from ..peaks import OPS_PER_S, bound_s
from .layers import chain_flops, sa_layers

K_QUANTUM = {"float32": 8, "bfloat16": 16}


def fused_layers(cfg: Dict):
    q = K_QUANTUM[cfg["compute_dtype"]]
    return [layer for layer in sa_layers(cfg)
            if layer[3] % q == 0 and all(c % 128 == 0 for c in layer[5][1:])]


def forward_bound_s(cfg: Dict, B: int, train: bool) -> float:
    size = 4 if cfg["compute_dtype"] == "float32" else 2
    total = 0.0
    for _, _, S, K, _, chans in fused_layers(cfg):
        rows = B * S * K
        nbytes = 4 * (rows * chans[0]
                      + sum(a * b for a, b in zip(chans[:-1], chans[1:]))
                      + (2 * sum(chans[1:]) if train else 0))
        nbytes += size * B * S * chans[-1]
        total += bound_s(nbytes, chain_flops(rows, chans),
                         OPS_PER_S[cfg["compute_dtype"]])
    return total
