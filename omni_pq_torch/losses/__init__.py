"""Losses of the port: the supervised detection + layout loss (`get_loss`)
and its primitives."""
from .supervised import (get_loss, compute_vote_loss, weighted_ce,
                         compute_physical_constraints_loss, get_2d_box_corners,
                         prefixes_for)
from .primitives import sigmoid_focal_loss, smoothl1_loss, huber_loss

__all__ = [
    "get_loss", "compute_vote_loss", "weighted_ce",
    "compute_physical_constraints_loss", "get_2d_box_corners", "prefixes_for",
    "sigmoid_focal_loss", "smoothl1_loss", "huber_loss",
]
