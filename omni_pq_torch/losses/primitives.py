"""Loss primitives (the port of `omni_pq_tpu/losses/primitives.py`).

smoothl1_loss and huber_loss live in ops/nn_distance.py; the focal loss
mirrors the reference's SigmoidFocalClassificationLoss
(models/utils/losses.py:21-81), unused by its main path but part of its API.
"""
from __future__ import annotations

import functools

import torch

from ..ops.nn_distance import smoothl1_loss, huber_loss  # noqa: F401 (re-export)


def constant(values, like: torch.Tensor) -> torch.Tensor:
    """`like.new_tensor(values)` for a float or a tuple of floats, made once
    a dtype and device and shared after: a copy from the host synchronises,
    which a captured CUDA graph of the train step cannot hold. Read it,
    never write it."""
    return _constant(values, like.dtype, like.device)


@functools.lru_cache(maxsize=None)
def _constant(values, dtype: torch.dtype, device: torch.device
              ) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def sigmoid_focal_loss(prediction: torch.Tensor, target: torch.Tensor,
                       weights, gamma: float = 2.0, alpha: float = 0.25):
    """Per-entry sigmoid focal loss: weights * alpha_t * (1-p_t)^gamma * CE.

    prediction/target (..., num_classes) logits / one-hot; weights
    broadcastable (the reference expands a (..., 1) weight)."""
    p = torch.sigmoid(prediction)
    ce = (torch.relu(prediction) - prediction * target
          + torch.log1p(torch.exp(-prediction.abs())))
    p_t = target * p + (1.0 - target) * (1.0 - p)
    modulator = (1.0 - p_t) ** gamma if gamma else 1.0
    alpha_w = ((target * alpha + (1.0 - target) * (1.0 - alpha))
               if alpha is not None else 1.0)
    return modulator * alpha_w * ce * weights
