from .spatial import spatial_sort
from .synthetic import make_scene, make_batch, SyntheticDataset
from .loader import Loader, collate, endless

__all__ = ["spatial_sort", "make_scene", "make_batch", "SyntheticDataset",
           "Loader", "collate", "endless"]
