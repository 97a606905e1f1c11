"""Plain PyTorch reference of the four loss families of the Omni-PQ train
step: the supervised detection + layout loss, the gamma-mixture
pseudo-label criterion, the mean-teacher consistency loss and the physical
constraint (pc) loss.

A frozen copy of `omni_pq_torch/losses/{supervised,consistency,gamma}.py` at
commit 4c1c1dacbb14fd55b2b315e6b58815882cf32f9c, cut to what the benchmark's
train cells run (the fixed gamma criterion; no fitted EM, no ARKit loss).
They rebuild the published code's models/loss_helper_pq.py,
models/utils/mean_teacher_consistency_util.py and
models/utils/gamma_mixture_loss_util.py; the departures are the JAX
package's, which the program keeps: the physical constraint loss with masks
instead of per-scene loops; the gamma criterion's fixed closed-form test
0.1 Gamma(2,20).pdf(d) >= 0.9 Gamma(3,1).pdf(d) (what the published fit
labels with, as its EM never reaches its keep mask), on the device, with
its quad and its 10 000 points drawn from the caller's generator.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .ops import nn_distance, smoothl1

NEAR, FAR = 0.3, 0.6
GT_VOTE_FACTOR = 3
OBJECTNESS_CLS_WEIGHTS = (0.2, 0.8)
QUAD_CLS_WEIGHTS = (0.4, 0.6)
PC_EXCLUDED_CLASSES = (5, 6, 8, 11)
EMA_CLIP = 0.85
GM_CLIP = 0.85
CONF_THRESH = 0.1
MIN_KEPT = 300
NUM_SAMPLED_POINTS = 10000
PAD = 1e9


def take(x, idx):
    """x (B, N, ...) rows at idx (B, K) -> (B, K, ...)."""
    i = idx.long().reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, i.expand(idx.shape + x.shape[2:]))


def select_last(x, labels):
    return torch.gather(x, -1, labels.long()[..., None])[..., 0]


def weighted_ce(logits, labels, weights=None):
    ll = select_last(torch.log_softmax(logits, dim=-1), labels)
    if weights is None:
        return -ll
    wt = torch.as_tensor(weights, dtype=logits.dtype, device=logits.device)
    return -wt[labels.long()] * ll


def loss_prefixes(num_layer):
    return ["proposal_", "last_"] + [f"{i}head_" for i in range(num_layer - 1)]


def vote_loss(ep):
    B, S, _ = ep["seed_xyz"].shape
    mask = take(ep["vote_label_mask"], ep["seed_inds"]).to(
        ep["vote_xyz"].dtype)
    gt = (take(ep["vote_label"], ep["seed_inds"])
          + ep["seed_xyz"].repeat(1, 1, GT_VOTE_FACTOR))
    _, _, dist2, _ = nn_distance(ep["vote_xyz"].reshape(B * S, -1, 3),
                                 gt.reshape(B * S, GT_VOTE_FACTOR, 3), l1=True)
    return (dist2.amin(dim=1).reshape(B, S) * mask).sum() / (mask.sum() + 1e-6)


def assign(xyz, gt_center, num_gt):
    K2 = gt_center.shape[1]
    dist1, ind1, _, _ = nn_distance(xyz.detach(), gt_center)
    euclid = torch.sqrt(dist1 + 1e-6)
    label = (euclid < NEAR).long()
    label = torch.where(ind1 >= num_gt[:, None], 0, label)
    mask = ((euclid < NEAR) | (euclid > FAR)).float()
    return label, mask, torch.where(label == 0, K2 - 1, ind1)


def object_losses(ep, ms, num_layer):
    gt_center = ep["center_label"][:, :, 0:3]
    label, mask, assignment = assign(ep["aggregated_vote_xyz"], gt_center,
                                     ep["num_gt_boxes"])
    labelf = label.float()
    n_pos = labelf.sum() + 1e-6
    obj_sum = box_sum = sem_sum = 0.0
    for p in loss_prefixes(num_layer):
        ep[f"{p}objectness_label"] = label
        ep[f"{p}object_assignment"] = assignment
        obj = weighted_ce(ep[f"{p}objectness_scores"], label,
                          OBJECTNESS_CLS_WEIGHTS)
        obj_sum = obj_sum + (obj * mask).sum() / (mask.sum() + 1e-6)
        center = (smoothl1(take(gt_center, assignment) - ep[f"{p}center"])
                  * labelf[..., None]).sum() / n_pos
        hcl = take(ep["heading_class_label"], assignment)
        h_cls = (weighted_ce(ep[f"{p}heading_scores"], hcl)
                 * labelf).sum() / n_pos
        nh = ep[f"{p}heading_scores"].shape[-1]
        hrl = take(ep["heading_residual_label"], assignment) / (math.pi / nh)
        h_reg = (smoothl1(select_last(ep[f"{p}heading_residuals_normalized"],
                                      hcl) - hrl) * labelf).sum() / n_pos
        scl = take(ep["size_class_label"], assignment)
        s_cls = (weighted_ce(ep[f"{p}size_scores"], scl)
                 * labelf).sum() / n_pos
        pred_sr = torch.gather(
            ep[f"{p}size_residuals_normalized"], 2,
            scl.long()[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
        srl = take(ep["size_residual_label"], assignment) / ms[scl.long()]
        s_reg = (smoothl1(pred_sr - srl) * labelf[..., None]).sum() / n_pos
        sem = (weighted_ce(ep[f"{p}sem_cls_scores"],
                           take(ep["sem_cls_label"], assignment))
               * labelf).sum() / n_pos
        box_sum = box_sum + (center + 0.1 * h_cls + h_reg + 0.1 * s_cls
                             + s_reg)
        sem_sum = sem_sum + sem
    return obj_sum, box_sum, sem_sum


def quad_losses(ep, num_layer):
    gt_center = ep["gt_quad_centers"][:, :, 0:3]
    label, mask, assignment = assign(ep["aggregated_sample_xyz"], gt_center,
                                     ep["num_gt_quads"])
    labelf = label.float()
    n_pos = labelf.sum() + 1e-6
    score_sum = geo_sum = 0.0
    for p in loss_prefixes(num_layer):
        ep[f"{p}quad_label"] = label
        score = weighted_ce(ep[f"{p}quad_scores"], label, QUAD_CLS_WEIGHTS)
        score_sum = score_sum + (score * mask).sum() / (mask.sum() + 1e-6)
        center = (smoothl1(take(gt_center, assignment) - ep[f"{p}quad_center"])
                  * labelf[..., None]).sum() / n_pos
        gt_vec = take(ep["gt_normal_vectors"], assignment)
        pv = ep[f"{p}normal_vector"]
        cos = (pv * gt_vec).sum(-1) / (torch.linalg.vector_norm(pv, dim=-1)
                                       * torch.linalg.vector_norm(gt_vec,
                                                                  dim=-1)
                                       + 1e-8)
        vector = ((1.0 - cos) * labelf).sum() / n_pos
        size = (smoothl1(ep[f"{p}quad_size"]
                         - take(ep["gt_quad_sizes"], assignment))
                * labelf[..., None]).sum() / n_pos
        geo_sum = geo_sum + center + vector + size
    return score_sum, geo_sum


def pc_loss(ep, ms):
    """Object corners inside the layout quads, on the 'last_' outputs."""
    p = "last_"
    pred_center = ep[f"{p}center"]
    cls = ep[f"{p}size_scores"].argmax(-1)
    res = torch.gather(ep[f"{p}size_residuals"], 2,
                       cls[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
    box_size = ms[cls] + res
    sem = take(ep["sem_cls_label"], ep[f"{p}object_assignment"])
    allowed = torch.ones_like(sem, dtype=torch.bool)
    for c in PC_EXCLUDED_CLASSES:
        allowed = allowed & (sem != c)
    box_mask = ep[f"{p}objectness_label"].float() * allowed.float()
    num_box = box_mask.sum(dim=1)
    l, w = box_size[..., 0] / 2, box_size[..., 1] / 2
    dx = torch.stack([l, l, -l, -l], dim=-1) + pred_center[..., 0:1]
    dy = torch.stack([w, -w, w, -w], dim=-1) + pred_center[..., 1:2]
    B, K = box_mask.shape
    px, py = dx.reshape(B, K * 4), dy.reshape(B, K * 4)
    pts_mask = box_mask.repeat_interleave(4, dim=1)
    qc, nv = ep[f"{p}quad_center"], ep[f"{p}normal_vector"]
    qs = ep[f"{p}quad_size"]
    a, b = nv[..., 0], nv[..., 1]
    d = -(a * qc[..., 0] + b * qc[..., 1])
    delta = (a[:, :, None] * px[:, None, :] + b[:, :, None] * py[:, None, :]
             + d[:, :, None])
    projx = px[:, None, :] - a[:, :, None] * delta
    projy = py[:, None, :] - b[:, :, None] * delta
    wd = torch.sqrt((projx - qc[..., 0:1]) ** 2 + (projy - qc[..., 1:2]) ** 2)
    per_pt = (torch.relu(-delta) * (wd < qs[..., 0:1]).float()
              * pts_mask[:, None, :])
    scale = torch.where(num_box > 0, 1.0 / torch.clamp_min(num_box, 1.0), 0.0)
    return (per_pt.sum(dim=2) * ep[f"{p}quad_label"].float()
            * scale[:, None]).sum()


def supervised_loss(ep: Dict, num_layer: int, use_pc: bool,
                    parts: Optional[Dict] = None) -> torch.Tensor:
    """10 (pc + vote + 1/(L+1) (0.9 object + 0.1 quad)), object = box +
    0.1 sem + 0.5 objectness, quad = geometry + 0.5 score. `parts`, where
    given, gets each term, detached."""
    ms = torch.tensor(_mean_sizes(), dtype=torch.float32,
                      device=ep["center_label"].device)
    obj, box, sem = object_losses(ep, ms, num_layer)
    score, geo = quad_losses(ep, num_layer)
    pcl = pc_loss(ep, ms) if use_pc else torch.zeros((), device=ms.device)
    vote = vote_loss(ep)
    if parts is not None:
        parts.update({k: v.detach() for k, v in (
            ("vote", vote), ("objectness", obj), ("box", box), ("sem", sem),
            ("quad_score", score), ("quad_geometry", geo), ("pc", pcl))})
    return 10.0 * (pcl + vote + 1.0 / (num_layer + 1) * (
        0.9 * (box + 0.1 * sem + 0.5 * obj) + 0.1 * (geo + 0.5 * score)))


def _mean_sizes():
    from .pq_transformer import MEAN_SIZES
    return MEAN_SIZES


# --- the gamma-mixture criterion (fixed test) -----------------------------

def gamma_logpdf(x, a, b):
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    return a * torch.log(b) - torch.lgamma(a) + (a - 1.0) * torch.log(x) - b * x


def keep_mask(dist):
    d = dist.abs() + 1e-12
    w = torch.as_tensor(0.1, dtype=d.dtype, device=d.device)
    return (torch.log(w) + gamma_logpdf(d, 2.0, 20.0)
            >= torch.log1p(-w) + gamma_logpdf(d, 3.0, 1.0))


def quantile_sorted(v_sorted, n, q):
    pos = q * torch.clamp_min(n - 1, 0).float()
    lo, hi = torch.floor(pos).long(), torch.ceil(pos).long()
    frac = pos - lo.float()
    return (torch.gather(v_sorted, -1, lo[..., None])[..., 0] * (1.0 - frac)
            + torch.gather(v_sorted, -1, hi[..., None])[..., 0] * frac)


def _dot(a, b):
    return torch.matmul(a, b[..., :, None])[..., 0]


def quad_metric(score, center, normal, quad_size, pc, pn):
    size = quad_size * quad_size.new_tensor([1.0 / 1.5, 1.0])
    n2 = normal[..., :2] / (torch.linalg.vector_norm(
        normal[..., :2], dim=-1, keepdim=True) + 1e-12).detach()
    n3 = torch.cat([n2, torch.zeros_like(n2[..., :1])], dim=-1)
    pn_hat = pn / torch.clamp_min(torch.linalg.vector_norm(
        pn, dim=-1, keepdim=True), 1e-5)
    cosine = 1.0 - _dot(pn_hat, n3).abs()
    offset = pc - center[..., None, :]
    vertical = _dot(offset, n3.detach()).abs()
    z_dir = n3.new_tensor([0.0, 0.0, 1.0]).expand_as(n3)
    x_dir = torch.linalg.cross(z_dir, n3, dim=-1)
    sa = torch.relu(2.0 * torch.stack([_dot(offset, x_dir).abs(),
                                       _dot(offset, z_dir).abs()], dim=-1)
                    - size[..., None, :])
    size_a = torch.sqrt((sa * sa).sum(-1) + 1e-12)
    keep = keep_mask((2.5 * cosine + 0.2 * size_a ** 2
                      + 0.5 * vertical).detach())
    cnt = keep.sum(-1)
    keepf = keep.to(pc.dtype)
    cntf = torch.clamp_min(cnt.to(pc.dtype), 1.0)
    est = (pn[..., :2] * keepf[..., None]).sum(-2) / cntf[..., None]
    est = torch.cat([est, torch.zeros_like(est[..., :1])], dim=-1)
    est = est / (torch.linalg.vector_norm(est, dim=-1, keepdim=True) + 1e-12)
    m_normal = (1.0 - (est * n3).sum(-1).abs()).detach()
    v_sorted = torch.sort(torch.where(keep, vertical.detach(), PAD),
                          dim=-1).values
    v_eps = quantile_sorted(v_sorted, cnt, GM_CLIP)
    m_vertical = (vertical * keepf * (vertical < v_eps[..., None]).to(
        vertical.dtype)).sum(-1) / cntf
    kept_mean = (pc * keepf[..., None]).sum(-2) / cntf[..., None]
    x2 = _dot(pc - kept_mean[..., None, :], x_dir).abs()
    x_sorted = torch.sort(torch.where(keep, x2, PAD), dim=-1).values
    pseudo_x = sum(quantile_sorted(x_sorted, cnt, t) / t
                   for t in (0.85, 0.925, 1.0)) / 3.0
    m_size = (smoothl1(size[..., 0] - 2.0 * pseudo_x)
              + smoothl1(kept_mean - center).sum(-1))
    promote = (m_vertical < 0.05) & (m_normal < 0.02) & (m_size < 0.10)
    demote = (m_vertical > 0.3) | (m_normal > 0.05) | (m_size > 0.35)
    logp = torch.log_softmax(score, dim=-1)
    m_score = torch.where(promote, -logp[..., 1],
                          torch.where(demote, -logp[..., 0], 0.0))
    return m_normal, m_vertical, m_size, m_score, cnt >= MIN_KEPT


def gamma_criterion(ep, points, normals, generator):
    """The four batch-mean metrics on the weak scenes: one confident quad a
    scene (p > 0.1, uniform; index 0 where none), 10 000 points drawn with
    replacement; two draws from `generator`, in that order."""
    qs = ep["last_quad_scores"]
    B, Q, _ = qs.shape
    dev = qs.device
    conf = torch.softmax(qs.detach(), dim=-1)[..., 1] > CONF_THRESH
    keys = torch.rand((B, Q), generator=generator, device=dev)
    ind = torch.where(conf, keys, -1.0).argmax(-1)
    ds = torch.randint(0, points.shape[1], (B, NUM_SAMPLED_POINTS),
                       generator=generator, device=dev)
    rows = torch.arange(B, device=dev)
    idx = ds[..., None].expand(-1, -1, 3)
    mets = quad_metric(qs[rows, ind], ep["last_quad_center"][rows, ind],
                       ep["last_normal_vector"][rows, ind],
                       ep["last_quad_size"][rows, ind],
                       torch.gather(points, 1, idx),
                       torch.gather(normals, 1, idx))
    valid = (torch.softmax(qs, dim=-1)[..., 1] > CONF_THRESH).any(-1) & mets[4]
    return [torch.where(valid, m, 0.0).mean() for m in mets[:4]]


# --- mean-teacher consistency ---------------------------------------------

def _align(c, flip_x, flip_y, rot_mat, scale):
    one = c.new_ones(())
    x = torch.where(flip_x[:, None, None] > 0,
                    c * torch.stack([-one, one, one]), c)
    x = torch.where(flip_y[:, None, None] > 0,
                    x * torch.stack([one, -one, one]), x)
    return torch.bmm(x, rot_mat.transpose(1, 2)) * scale[:, None, None]


def _clip_mean(dist):
    eps = torch.quantile(dist.detach().reshape(-1), EMA_CLIP)
    return torch.where(dist < eps, dist, 0.0).mean()


def _center_c(center, ema_center, scores):
    dist1, ind1, dist2, ind2 = nn_distance(center, ema_center)
    return (_clip_mean(dist1 * take(scores, ind1) + dist2 * scores), ind2,
            scores)


def _class_c(cls, ema_cls, map_ind, batchmean=False):
    ema_p = torch.softmax(ema_cls, dim=2)
    kl = ema_p * (torch.log(torch.clamp_min(ema_p, 1e-12))
                  - take(torch.log_softmax(cls, dim=2), map_ind))
    return 2.0 * kl.sum() / cls.shape[0] if batchmean else 2.0 * kl.mean()


def _decode_size(scores, residuals, ms):
    cls = scores.argmax(-1)
    oh = cls[..., None] == torch.arange(residuals.shape[2], device=cls.device)
    return ms[cls] + torch.where(oh[..., None], residuals, 0.0).sum(dim=2)


def _size_c(size, ema_size, map_ind, conf):
    return _clip_mean(((take(size, map_ind) - ema_size) ** 2).sum(dim=2)
                      * conf)


def _normal_c(normal, ema_normal, map_ind, conf):
    a = take(normal, map_ind)
    cos = (a[..., :2] * ema_normal[..., :2]).sum(-1) / (
        torch.linalg.vector_norm(a[..., :2], dim=-1)
        * torch.linalg.vector_norm(ema_normal[..., :2], dim=-1) + 1e-8)
    return _clip_mean((1.0 - cos.abs()) * conf)


def consistency_loss(ep, ema_ep, aug, num_layer):
    """Mean over the 7 prefixes of objects 0.5 center + class + 0.05 size
    and quads 0.5 center + normal + 0.05 size (the quad class term has
    weight 0)."""
    ms = torch.tensor(_mean_sizes(), dtype=torch.float32,
                      device=ep["last_center"].device)
    fx, fy, rot, scale = (aug[k] for k in ("flip_x_axis", "flip_y_axis",
                                           "rot_mat", "scale"))
    prefixes = ["last_", "proposal_"] + [f"{i}head_"
                                         for i in range(num_layer - 1)]
    total = 0.0
    for p in prefixes:
        ema_c = _align(ema_ep[f"{p}center"], fx, fy, rot, scale)
        scores = torch.softmax(ep[f"{p}objectness_scores"], dim=2)[..., 1]
        cc, mi, conf = _center_c(ep[f"{p}center"], ema_c, scores)
        kc = _class_c(ep[f"{p}sem_cls_scores"], ema_ep[f"{p}sem_cls_scores"],
                      mi)
        size = _decode_size(ep[f"{p}size_scores"], ep[f"{p}size_residuals"],
                            ms)
        ema_size = _decode_size(ema_ep[f"{p}size_scores"],
                                ema_ep[f"{p}size_residuals"], ms)
        sc = _size_c(size, ema_size * scale[:, None, None], mi, conf)
        total = total + 0.5 * cc + kc + 0.05 * sc
        ema_qc = _align(ema_ep[f"{p}quad_center"], fx, fy, rot, scale)
        qscores = torch.softmax(ep[f"{p}quad_scores"], dim=2)[..., 1]
        qcc, qmi, qconf = _center_c(ep[f"{p}quad_center"], ema_qc, qscores)
        qnc = _normal_c(ep[f"{p}normal_vector"], ema_ep[f"{p}normal_vector"],
                        qmi, qconf)
        qsc = _size_c(ep[f"{p}quad_size"], ema_ep[f"{p}quad_size"], qmi,
                      qconf)
        total = total + 0.5 * qcc + qnc + 0.05 * qsc
    return total / float(len(prefixes))
