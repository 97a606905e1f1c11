from .spatial import spatial_sort
from .synthetic import make_scene, make_batch, SyntheticDataset
from .scannet import ScannetDetectionDataset
from .arkitscenes import ARKitSceneDataset
from .loader import Loader, PrefetchLoader, DoubleLoader, collate, endless
from .quads import get_quads, rectangle, get_normal, arkit_quads_from_annotation

__all__ = [
    "spatial_sort", "make_scene", "make_batch", "SyntheticDataset",
    "ScannetDetectionDataset", "ARKitSceneDataset", "Loader",
    "PrefetchLoader", "DoubleLoader", "collate", "endless", "get_quads",
    "rectangle", "get_normal", "arkit_quads_from_annotation",
]
