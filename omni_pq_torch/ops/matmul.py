"""bfloat16 products that sum in float32 on the card, as XLA sums them.

cuBLAS may reduce a bfloat16 GEMM in bfloat16 where PyTorch lets it
(`torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`, on
by default). `matmul` and `linear` run a bfloat16 product on the card, and
the two products of its backward, with that switch off, so that no caller
has to set it. Elsewhere (float32, or the CPU, which sums bfloat16 products
in float32) they are `torch.matmul` and `F.linear`.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _f32_sums():
    m = torch.backends.cuda.matmul
    saved = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction = saved


class _Matmul(torch.autograd.Function):
    """a @ b, a (..., m, k) and b (k, n) or (..., k, n) with a's batch
    shape, its forward and backward products summed in float32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with _f32_sums():
            return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        with _f32_sums():
            if ctx.needs_input_grad[0]:
                ga = torch.matmul(g, b.mT)
            if ctx.needs_input_grad[1]:
                gb = (a.reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1])
                      if b.dim() == 2 else a.mT @ g)
        return ga, gb


def _on_card_bf16(t: torch.Tensor) -> bool:
    return t.is_cuda and t.dtype == torch.bfloat16


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.matmul(a, b) for b (k, n) or with a's batch shape."""
    return _Matmul.apply(a, b) if _on_card_bf16(a) else torch.matmul(a, b)


def linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """F.linear(x, weight) without a bias: x @ weight.T."""
    return (_Matmul.apply(x, weight.T) if _on_card_bf16(x)
            else F.linear(x, weight))
