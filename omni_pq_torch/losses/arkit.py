"""ARKitScenes omni-supervised physical-constraint loss (the port of
`omni_pq_tpu/losses/arkit.py`).

Rebuilds models/utils/arkit_loss_util.py:5-52: weak GT object boxes of the
unlabeled ARKit half supervise predicted quads — predicted normals are
flipped to point toward the pseudo scene center (0,0,1), then box corners
falling outside a confident quad's plane are penalized via the same
projection2d geometry as the supervised pc loss. The reference's per-scene /
per-quad Python loops become one masked (B, Q, P) computation.

DATA CONTRACT: the hardcoded pseudo center assumes scenes are roughly
ORIGIN-CENTERED — on an off-origin room, near-side wall normals flip
outward and perfect predictions are penalized (the JAX package's
tests/test_losses.py::test_pseudo_center_assumes_origin_centered_scenes).
The reference satisfies it by re-centering labels on the scene's median xy
at load time (arkitscenes_dataset.py:102-121).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .supervised import get_2d_box_corners

CONF_THRESH = 0.1


def get_arkit_pc_loss(ep: Dict, weak_labels: Dict
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ep: full double-batch end_points; weak_labels: the unlabeled half's
    {center_label (B,K2,3), size_label (B,K2,3), num_gt_boxes (B,)}.

    Only the second half of the batch (the weak scenes) is scored
    (arkit_loss_util.py:15-19). Returns (pc loss, collisions count)."""
    prefix = "last_"
    B = weak_labels["center_label"].shape[0]
    qc = ep[f"{prefix}quad_center"][B:]
    nv = ep[f"{prefix}normal_vector"][B:]
    qs = ep[f"{prefix}quad_size"][B:]
    scores = torch.softmax(ep[f"{prefix}quad_scores"], dim=-1)[..., 1][B:]

    gt_center = weak_labels["center_label"]
    gt_size = weak_labels["size_label"]
    num_box = weak_labels["num_gt_boxes"].to(qc.dtype)  # (B,)
    K2 = gt_center.shape[1]
    box_mask = (torch.arange(K2, device=qc.device)[None, :]
                < num_box[:, None]).to(qc.dtype)

    corners = get_2d_box_corners(gt_size, gt_center)  # (B,K2,4,2)
    pts = corners.reshape(B, K2 * 4, 2)
    pts_mask = box_mask.repeat_interleave(4, dim=1)

    # flip normals inward: toward pseudo scene center (0,0,1), z zeroed
    offset = qc.new_tensor([0.0, 0.0, 1.0]) - qc.detach()
    offset = torch.cat([offset[..., :2], torch.zeros_like(offset[..., 2:])],
                       dim=-1)
    reverse = (offset * nv).sum(-1, keepdim=True) < 0
    nv_in = torch.where(reverse, -nv, nv)

    a, b = nv_in[..., 0], nv_in[..., 1]
    d = -(a * qc[..., 0] + b * qc[..., 1])
    px, py = pts[..., 0], pts[..., 1]
    delta = (a[:, :, None] * px[:, None, :] + b[:, :, None] * py[:, None, :]
             + d[:, :, None])  # (B,Q,P)
    k = -delta
    projx = px[:, None, :] + a[:, :, None] * k
    projy = py[:, None, :] + b[:, :, None] * k
    w = torch.sqrt((projx - qc[..., 0:1]) ** 2 + (projy - qc[..., 1:2]) ** 2)
    point_mask = (w < qs[..., 0:1]).to(qc.dtype)
    per_pt = torch.relu(-delta) * point_mask * pts_mask[:, None, :]
    per_quad = per_pt.sum(dim=2)  # (B,Q)
    quad_mask = (scores > CONF_THRESH).to(qc.dtype)
    scene_scale = torch.where(num_box > 0,
                              1.0 / torch.clamp_min(num_box, 1.0), 0.0)
    pc_loss = (per_quad * quad_mask * scene_scale[:, None]).sum()
    collisions = ((per_pt > 1e-4).to(qc.dtype) * quad_mask[..., None]
                  * (num_box > 0)[:, None, None].to(qc.dtype)).sum()
    return pc_loss, collisions
