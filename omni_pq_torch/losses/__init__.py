"""Losses of the port: the supervised detection + layout loss (`get_loss`)
and its primitives, and the semi-supervised losses: mean-teacher
consistency, gamma-mixture pseudo-labels and the ARKit pc loss; and the
legacy losses off the train step's path: the EMA teacher as pseudo ground
truth (`teacher.py`) and the distance-based layout loss (`distance.py`)."""
from .supervised import (get_loss, compute_vote_loss, weighted_ce,
                         compute_physical_constraints_loss, get_2d_box_corners,
                         prefixes_for)
from .primitives import sigmoid_focal_loss, smoothl1_loss, huber_loss
from .consistency import get_consistency_loss
from .gamma import (gamma_mixture_guide_criterion, gamma_mixture_em,
                    mixture_keep_mask, masked_quantile, gamma_logpdf,
                    quad_point_mixture_metric)
from .arkit import get_arkit_pc_loss
from .teacher import get_loss_teacher, get_loss_mean_teacher
from .distance import (calc_distance_vertically, distance_loss_gamma_mixture,
                       spectral_layout_clustering)

__all__ = [
    "get_loss", "compute_vote_loss", "weighted_ce",
    "compute_physical_constraints_loss", "get_2d_box_corners", "prefixes_for",
    "sigmoid_focal_loss", "smoothl1_loss", "huber_loss",
    "get_consistency_loss", "gamma_mixture_guide_criterion",
    "gamma_mixture_em", "mixture_keep_mask", "masked_quantile",
    "gamma_logpdf", "quad_point_mixture_metric", "get_arkit_pc_loss",
    "get_loss_teacher", "get_loss_mean_teacher", "calc_distance_vertically",
    "distance_loss_gamma_mixture", "spectral_layout_clustering",
]
