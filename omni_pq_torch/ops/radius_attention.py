"""Radius-masked self-attention (3DETR's masked encoder): the hand-written
CUDA kernel and its plain version.

`radius_attention` takes the plain version for tensors on the CPU and
launches the CUDA kernel (`omni_pq_torch/csrc/radius_attention.cu`) for
tensors on the card, at every shape: there is no size threshold and no
fallback. It replaces no TPU kernel (the JAX package has no 3DETR): the
kernel keeps the (B, H, N, N) logits, their softmax and the (B, N, N) mask
out of device memory. Forward only: no gradient (3DETR's training is not
ported).

A pair of tokens (i, j) is kept where ((dx*dx + dy*dy) + dz*dz) < r2 for
d = xyz[i] - xyz[j], each operation rounded once in float32 (the ball
query's order: `reference._sq_dist`; the kernel spells it with `__f*_rn`),
r2 the float32 square of the radius (`reference.radius_sq`), so both
versions keep the same pairs. 3DETR masks a pair whose `torch.cdist`
distance is >= the radius; the distances here are squared and rounded in a
fixed order instead, so that the mask does not depend on cdist's route.
"""
from __future__ import annotations

import functools

import torch

from . import cuda
from .reference import _sq_dist, radius_sq


def keep_mask(xyz: torch.Tensor, r2: float) -> torch.Tensor:
    """(B, N, 3) float32 points -> the (B, N, N) pairs closer than sqrt(r2)."""
    return _sq_dist(xyz[:, :, None, :], xyz[:, None, :, :]) < r2


def radius_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           xyz: torch.Tensor, radius: float) -> torch.Tensor:
    """Plain version of `radius_attention`: the logits, the masked fill,
    the softmax and the product, as ordinary tensor ops, one batch row at a
    time (its (H, N, N) logits, not the batch's)."""
    r2 = radius_sq(radius)
    rows = []
    for b in range(q.shape[0]):
        logits = torch.einsum("hqd,hkd->hqk", q[b], k[b])
        logits = logits.masked_fill(~keep_mask(xyz[b:b + 1], r2),
                                    float("-inf"))
        rows.append(torch.einsum("hqk,hkd->qhd",
                                 torch.softmax(logits, dim=-1), v[b]))
    return torch.stack(rows)


@functools.lru_cache(maxsize=None)
def head_size() -> int:
    """The head size the kernel takes, read from the built library."""
    return cuda.library("radius_attention")[2].radius_attention_head_size()


def radius_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     xyz: torch.Tensor, radius: float) -> torch.Tensor:
    """Self-attention of N point tokens masked to the pairs within `radius`.

    q, k, v (B, H, N, hd) float32, q already scaled by 1/sqrt(hd); xyz
    (B, N, 3) float32 -> (B, N, H, hd): for each head the softmax of q . k
    over the kept keys, times v, with the heads side by side (the layout the
    output projection reads). Every token keeps itself. On the card hd must
    be the kernel's `head_size()` (64)."""
    if q.device.type == "cpu":
        return radius_attention_plain(q, k, v, xyz, radius)
    B, H, N, hd = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda.check_cuda_tensor(f"radius_attention {name}", t, torch.float32,
                               4, last=head_size())
        if t.shape != q.shape:
            raise ValueError(f"radius_attention {name}: shape "
                             f"{tuple(t.shape)}, q has {tuple(q.shape)}")
    cuda.check_cuda_tensor("radius_attention xyz", xyz, torch.float32, 3,
                           last=3)
    if xyz.shape[:2] != (B, N):
        raise ValueError(f"radius_attention xyz: shape {tuple(xyz.shape)} "
                         f"for {B} rows of {N} tokens")
    out = torch.empty(B, N, H, hd, dtype=torch.float32, device=q.device)
    cuda.launch("radius_attention", q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), xyz.data_ptr(), out.data_ptr(), B, H, N,
                radius_sq(radius))
    radius_attention.launches += 1
    return out


radius_attention.launches = 0  # kernel launches since the count was set to 0
