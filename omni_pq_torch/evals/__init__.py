"""Host numpy metrics (the port's own copies of `omni_pq_tpu/evals`): quad
and object decode with NMS, oriented-box AP and the quad corner-F1."""
from .box_ops import box3d_iou, get_iou_obb, flip_axis_to_camera
from .nms import nms_2d_faster, nms_3d_faster, nms_3d_faster_samecls
from .ap import voc_ap, eval_det_cls, eval_det, APCalculator
from .quad import (parse_quad_predictions, parse_quad_groundtruths,
                   QuadAPCalculator, heading_from_normal)
from .objects import parse_predictions, parse_groundtruths

__all__ = [
    "box3d_iou", "get_iou_obb", "flip_axis_to_camera",
    "nms_2d_faster", "nms_3d_faster", "nms_3d_faster_samecls", "voc_ap",
    "eval_det_cls", "eval_det", "APCalculator", "parse_quad_predictions",
    "parse_quad_groundtruths", "QuadAPCalculator",
    "heading_from_normal", "parse_predictions", "parse_groundtruths",
]
