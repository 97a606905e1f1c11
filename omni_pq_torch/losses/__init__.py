"""Losses of the port: the supervised detection + layout loss (`get_loss`)
and its primitives, and the semi-supervised losses: mean-teacher
consistency, gamma-mixture pseudo-labels and the ARKit pc loss."""
from .supervised import (get_loss, compute_vote_loss, weighted_ce,
                         compute_physical_constraints_loss, get_2d_box_corners,
                         prefixes_for)
from .primitives import sigmoid_focal_loss, smoothl1_loss, huber_loss
from .consistency import get_consistency_loss
from .gamma import (gamma_mixture_guide_criterion, gamma_mixture_em,
                    mixture_keep_mask, masked_quantile, gamma_logpdf,
                    quad_point_mixture_metric)
from .arkit import get_arkit_pc_loss

__all__ = [
    "get_loss", "compute_vote_loss", "weighted_ce",
    "compute_physical_constraints_loss", "get_2d_box_corners", "prefixes_for",
    "sigmoid_focal_loss", "smoothl1_loss", "huber_loss",
    "get_consistency_loss", "gamma_mixture_guide_criterion",
    "gamma_mixture_em", "mixture_keep_mask", "masked_quantile",
    "gamma_logpdf", "quad_point_mixture_metric", "get_arkit_pc_loss",
]
