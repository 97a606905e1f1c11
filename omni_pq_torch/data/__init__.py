from .spatial import spatial_sort
from .synthetic import make_scene, make_batch

__all__ = ["spatial_sort", "make_scene", "make_batch"]
