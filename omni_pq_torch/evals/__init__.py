"""Host numpy metrics (the port's own copies of `omni_pq_tpu/evals`): quad
and object decode with NMS, oriented-box AP, the quad corner-F1 and the
axis-aligned precision/recall helpers; the JAX package's export list."""
from .box_ops import (get_3d_box, box3d_iou, get_iou_obb, flip_axis_to_camera,
                      polygon_clip, convex_hull_intersection)
from .nms import nms_2d_faster, nms_3d_faster, nms_3d_faster_samecls
from .ap import voc_ap, eval_det_cls, eval_det, APCalculator
from .quad import (parse_quad_predictions, parse_quad_groundtruths,
                   QuadAPCalculator, get_verts, heading_from_normal)
from .objects import parse_predictions, parse_groundtruths
from .metric_util import (calc_iou, single_scene_precision_recall,
                          multi_scene_precision_recall, precision_recall)

__all__ = [
    "get_3d_box", "box3d_iou", "get_iou_obb", "flip_axis_to_camera",
    "polygon_clip", "convex_hull_intersection", "nms_2d_faster",
    "nms_3d_faster", "nms_3d_faster_samecls", "voc_ap", "eval_det_cls",
    "eval_det", "APCalculator", "parse_quad_predictions",
    "parse_quad_groundtruths", "QuadAPCalculator", "get_verts",
    "heading_from_normal", "parse_predictions", "parse_groundtruths",
    "calc_iou", "single_scene_precision_recall",
    "multi_scene_precision_recall", "precision_recall",
]
