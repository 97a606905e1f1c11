from .spatial import spatial_sort
from .synthetic import make_scene, make_batch, SyntheticDataset
from .loader import Loader, collate

__all__ = ["spatial_sort", "make_scene", "make_batch", "SyntheticDataset",
           "Loader", "collate"]
