"""The least time of one call of the program's fused SA-MLP kernel: its
work is one Dense chain over every grouped row of the SA layer (B x S
centres x K samples), at the compute dtype's peak; its bytes are the
grouped rows and weights read once and the pooled rows written once
(chip_smoke.py's kernel table counts so). In train mode a call also writes
the batch means and variances; the backward is not the kernel's. The
kernel takes a layer whose MLP widths are multiples of 128 and whose
sample count is a multiple of 8 in float32, 16 in bfloat16: the routing
rule of the program's `ops.fused_mlp.supports` at commit
4c1c1dacbb14fd55b2b315e6b58815882cf32f9c. A model's counts
(`counts/<model>.py`) add these up over the layers it fuses."""
from __future__ import annotations

from ..peaks import OPS_PER_S, bound_s
from .layers import chain_flops

K_QUANTUM = {"float32": 8, "bfloat16": 16}


def takes(dtype: str, K: int, chans) -> bool:
    """Whether the kernel takes an SA layer of K samples and MLP `chans`
    (the input width first)."""
    return K % K_QUANTUM[dtype] == 0 and all(c % 128 == 0 for c in chans[1:])


def call_bound_s(dtype: str, B: int, S: int, K: int, chans,
                 train: bool) -> float:
    size = 4 if dtype == "float32" else 2
    rows = B * S * K
    nbytes = 4 * (rows * chans[0]
                  + sum(a * b for a, b in zip(chans[:-1], chans[1:]))
                  + (2 * sum(chans[1:]) if train else 0))
    nbytes += size * B * S * chans[-1]
    return bound_s(nbytes, chain_flops(rows, chans), OPS_PER_S[dtype])
