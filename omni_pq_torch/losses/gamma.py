"""Gamma-mixture pseudo-label harvesting (the port of
`omni_pq_tpu/losses/gamma.py`), on the device, for the whole batch at once.

Rebuilds models/utils/gamma_mixture_loss_util.py (quad_point_mixture_metric
:27-127, gamma_mixture_guide_criterion :130-192) and fit.py's 2-component
Gamma mixture EM (fit.py:39-46, 86-112) without a host round trip: the
reference calls scipy's root-solver per scene per step on the CPU
(gamma_mixture_loss_util.py:63-69); here the EM is a fixed 25 iterations of
Newton steps on log(a) - digamma(a), every scene of the batch in one set of
tensor ops (the JAX package vmaps over scenes), and nothing is read back to
the host.

As in the JAX package (see its module docstring): the reference's fit never
reaches its keep-mask (fit.py:152-174 labels points with the initial
parameters), so the default criterion is the fixed closed-form test
0.1*Gamma(2,20).pdf(d) >= 0.9*Gamma(3,1).pdf(d) and runs no EM;
`use_fitted=True` labels with the fitted mixture. The quad width shrink
(`quad_size[0] /= 1.5`) is applied to the metric only.

Randomness: one confident quad per scene, uniformly (p > 0.1), and 10 000
point indices drawn with replacement, from the caller's torch.Generator. A
caller may pass that choice instead (`choice=`), so that a test can feed
both packages the same draw.

The quantiles' positions and the engaged fraction are float32, as the JAX
package takes them, on float64 end points too.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops.nn_distance import smoothl1_loss

GM_CLIP = 0.85
CONF_THRESH = 0.1
MIN_KEPT = 300
NUM_SAMPLED_POINTS = 10000
EM_STEPS = 25
NEWTON_STEPS = 12
INIT_A1, INIT_B1 = 2.0, 20.0
INIT_A2, INIT_B2 = 3.0, 1.0
INIT_WEIGHT = 0.1
PAD = 1e9  # large but finite: inf would leak NaN into gradients


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def gamma_logpdf(x, a, b):
    """log Gamma(a, rate b) pdf: a*log b - lgamma(a) - b*x + (a-1)*log x."""
    a, b = _f32(a, x), _f32(b, x)
    return a * torch.log(b) - torch.lgamma(a) + (a - 1.0) * torch.log(x) - b * x


def _em_component_step(x, prob, a_prev):
    """One weighted EM M-step for a Gamma component (fit.py:39-46) over the
    last axis: solve log(a) - digamma(a) = log(wmean(x)) - wmean(log x) by
    12 Newton steps, keep a within [a_prev/2, 2 a_prev], b = a/mean."""
    psum = prob.sum(-1, keepdim=True)
    wx = (prob * x).sum(-1, keepdim=True) / psum
    wlogx = (prob * torch.log(x)).sum(-1, keepdim=True) / psum
    target = torch.log(wx) - wlogx
    coef = psum / torch.clamp_min((prob * x).sum(-1, keepdim=True), 1e-8)
    a = a_prev
    for _ in range(NEWTON_STEPS):
        ae = a + 1e-5
        f = torch.log(ae) - torch.special.digamma(ae) - target
        fp = 1.0 / ae - torch.special.polygamma(1, ae)
        a = torch.clamp(a - f / fp, 1e-3, 1e4)
    # the JAX package's trust region on the shape update (gamma.py:69-75)
    a = torch.minimum(torch.maximum(a, a_prev / 2.0), a_prev * 2.0)
    return a, a * coef


def gamma_mixture_em(x, a1=INIT_A1, b1=INIT_B1, a2=INIT_A2, b2=INIT_B2,
                     weight=0.5, steps: int = EM_STEPS):
    """Fixed-iteration EM for a 2-component Gamma mixture on |x| (fit.py:
    86-112), over the last axis (leading axes are independent problems).

    Returns (a1, b1, a2, b2, weight) after `steps` EM iterations, each of
    shape x.shape[:-1] + (1,)."""
    x = x.abs() + 1e-12
    shape = x.shape[:-1] + (1,)
    a1, b1, a2, b2, w = (torch.full(shape, float(v), dtype=x.dtype,
                                    device=x.device)
                         for v in (a1, b1, a2, b2, weight))
    for _ in range(steps):
        lp_a = gamma_logpdf(x, a1, b1) + torch.log(w)
        lp_b = gamma_logpdf(x, a2, b2) + torch.log(1.0 - w)
        m = torch.maximum(lp_a, lp_b)
        pa = torch.exp(lp_a - m)
        pb = torch.exp(lp_b - m)
        tot = pa + pb
        prob_a = pa / tot
        prob_b = pb / tot
        w_new = prob_a.mean(-1, keepdim=True)
        a1, b1 = _em_component_step(x, prob_a, a1)
        a2, b2 = _em_component_step(x, prob_b, a2)
        w = torch.clamp(w_new, 1e-4, 1.0 - 1e-4)
    return a1, b1, a2, b2, w


def mixture_keep_mask(dist, use_fitted: bool = False):
    """Reference fit_gamma labeling (fit.py:163-174) over the last axis: keep
    points where weight*pdf_a(d) >= (1-weight)*pdf_b(d). With
    use_fitted=False this uses the initial parameters, exactly what the
    reference effectively does."""
    d = dist.abs() + 1e-12
    if use_fitted:
        a1, b1, a2, b2, w = gamma_mixture_em(d, INIT_A1, INIT_B1, INIT_A2,
                                             INIT_B2, INIT_WEIGHT, EM_STEPS)
    else:
        a1, b1, a2, b2 = INIT_A1, INIT_B1, INIT_A2, INIT_B2
        w = _f32(INIT_WEIGHT, d)
    lhs = torch.log(w) + gamma_logpdf(d, a1, b1)
    rhs = torch.log1p(-w) + gamma_logpdf(d, a2, b2)
    return lhs >= rhs


def _quantile_of_sorted(v_sorted, n, q):
    """Linear-interpolation q-quantile of the first n entries of each
    ascending row (n per row, (...,))."""
    pos = q * torch.clamp_min(n - 1, 0).to(torch.float32)
    lo = torch.floor(pos).long()
    hi = torch.ceil(pos).long()
    frac = pos - lo.to(torch.float32)
    v_lo = torch.gather(v_sorted, -1, lo[..., None])[..., 0]
    v_hi = torch.gather(v_sorted, -1, hi[..., None])[..., 0]
    return v_lo * (1.0 - frac) + v_hi * frac


def masked_quantile(values, mask, q):
    """torch.quantile with linear interpolation over values[mask] only, per
    row of the last axis."""
    v = torch.sort(torch.where(mask, values, PAD), dim=-1).values
    return _quantile_of_sorted(v, mask.sum(-1), q)


def _dot(a, b):
    """(..., P, 3) . (..., 3) -> (..., P), as a batched matmul in the
    promoted type (float32 points against float64 quads: float64)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt)[..., :, None])[..., 0]


def quad_point_mixture_metric(score, center, normal, quad_size, pc_ds, pn_ds,
                              use_fitted: bool = False):
    """Metric core for one quad per scene and a fixed point downsample
    (gamma_mixture_loss_util.py:27-127), over leading batch axes: score
    (..., 2), center/normal (..., 3), quad_size (..., 2), pc_ds/pn_ds
    (..., P, 3). Returns (metric_normal, metric_vertical, metric_size,
    metric_score, enough_points), each (...); the caller applies the
    reference's `< 300 kept points -> all zeros` policy via enough_points.
    Gradients stop where the JAX package stops them: the norm of n2, n3 in
    `vertical`, the keep mask, metric_normal and v_eps."""
    size = quad_size * quad_size.new_tensor([1.0 / 1.5, 1.0])
    n2 = normal[..., :2] / (torch.linalg.vector_norm(
        normal[..., :2], dim=-1, keepdim=True) + 1e-12).detach()
    n3 = torch.cat([n2, torch.zeros_like(n2[..., :1])], dim=-1)

    pn_hat = pn_ds / torch.clamp_min(torch.linalg.vector_norm(
        pn_ds, dim=-1, keepdim=True), 1e-5)
    distance_cosine = 1.0 - _dot(pn_hat, n3).abs()

    offset = pc_ds - center[..., None, :]
    vertical = _dot(offset, n3.detach()).abs()

    z_dir = n3.new_tensor([0.0, 0.0, 1.0]).expand_as(n3)
    x_dir = torch.linalg.cross(z_dir, n3, dim=-1)
    x_dis = _dot(offset, x_dir).abs()
    z_dis = _dot(offset, z_dir).abs()
    # eps inside the sqrt: norm of an exactly-zero relu output (point inside
    # the quad, the common case) would otherwise have a NaN gradient
    sa = torch.relu(2.0 * torch.stack([x_dis, z_dis], dim=-1)
                    - size[..., None, :])
    size_a = torch.sqrt((sa * sa).sum(-1) + 1e-12)

    total = 2.5 * distance_cosine + 0.2 * size_a ** 2 + 0.5 * vertical

    keep = mixture_keep_mask(total.detach(), use_fitted)
    cnt = keep.sum(-1)
    enough = cnt >= MIN_KEPT
    keepf = keep.to(pc_ds.dtype)
    cntf = torch.clamp_min(cnt.to(pc_ds.dtype), 1.0)

    est_n2 = (pn_ds[..., :2] * keepf[..., None]).sum(-2) / cntf[..., None]
    est_n3 = torch.cat([est_n2, torch.zeros_like(est_n2[..., :1])], dim=-1)
    est_n3 = est_n3 / (torch.linalg.vector_norm(est_n3, dim=-1,
                                                keepdim=True) + 1e-12)
    # the reference takes .item() here: a constant, no gradient (:91-93)
    metric_normal = (1.0 - (est_n3 * n3).sum(-1).abs()).detach()

    v_eps = masked_quantile(vertical.detach(), keep, GM_CLIP)
    metric_vertical = (vertical * keepf * (vertical < v_eps[..., None]).to(
        vertical.dtype)).sum(-1) / cntf

    kept_mean = (pc_ds * keepf[..., None]).sum(-2) / cntf[..., None]
    offset2 = pc_ds - kept_mean[..., None, :]
    x_dis2 = _dot(offset2, x_dir).abs()
    # one sort shared by the three quantile thresholds
    x_sorted = torch.sort(torch.where(keep, x_dis2, PAD), dim=-1).values
    pseudo_x = 0.0
    for t in (0.85, 0.925, 1.0):
        pseudo_x = pseudo_x + _quantile_of_sorted(x_sorted, cnt, t) / t
    pseudo_x = pseudo_x / 3.0
    metric_size = smoothl1_loss(size[..., 0] - 2.0 * pseudo_x)
    metric_size = metric_size + smoothl1_loss(kept_mean - center).sum(-1)

    promote = ((metric_vertical < 0.05) & (metric_normal < 0.02)
               & (metric_size < 0.10))
    demote = ((metric_vertical > 0.3) | (metric_normal > 0.05)
              | (metric_size > 0.35))
    logp = torch.log_softmax(score, dim=-1)
    ce_pos, ce_neg = -logp[..., 1], -logp[..., 0]
    metric_score = torch.where(promote, ce_pos,
                               torch.where(demote, ce_neg, 0.0))
    return metric_normal, metric_vertical, metric_size, metric_score, enough


def draw_choice(quad_scores: torch.Tensor, num_points: int,
                generator: torch.Generator):
    """The criterion's random draw for B scenes: (quad index (B,) uniform
    among each scene's quads with p > 0.1, index 0 where there is none;
    point indices (B, 10 000) uniform in [0, num_points), with
    replacement). Two draws from `generator`, in that order."""
    B, Q, _ = quad_scores.shape
    dev = quad_scores.device
    conf = torch.softmax(quad_scores.detach(), dim=-1)[..., 1] > CONF_THRESH
    keys = torch.rand((B, Q), generator=generator, device=dev)
    ind = torch.where(conf, keys, -1.0).argmax(-1)
    ds = torch.randint(0, num_points, (B, NUM_SAMPLED_POINTS),
                       generator=generator, device=dev)
    return ind, ds


def gamma_mixture_guide_criterion(
        ep: Dict, generator: Optional[torch.Generator] = None,
        use_fitted: bool = False, choice=None
) -> Tuple[torch.Tensor, ...]:
    """Batch version (:130-192): one random confident quad per scene, 10k
    random points; returns the 4 batch-mean metrics (normal, vertical,
    size, score) plus the engaged fraction: scenes where a confident quad
    existed AND the keep-mask passed the >= 300-point gate (the reference
    silently contributes zeros otherwise).

    `ep` holds last_quad_scores (B,Q,2), last_quad_center (B,Q,3),
    last_normal_vector (B,Q,3), last_quad_size (B,Q,2), point_clouds
    (B,N,3) and vertex_normals (B,N,3). The draw comes from `choice`, a
    (quad index (B,), point indices (B,P)) pair, when it is given, else from
    `generator` (`draw_choice`)."""
    prefix = "last_"
    quad_scores = ep[f"{prefix}quad_scores"]
    pc, pn = ep["point_clouds"][..., :3], ep["vertex_normals"]
    if choice is None:
        if generator is None:
            raise ValueError("gamma_mixture_guide_criterion draws its quad "
                             "and points from a torch.Generator: pass one")
        choice = draw_choice(quad_scores, pc.shape[1], generator)
    ind, ds = (torch.as_tensor(c, device=pc.device).long() for c in choice)
    rows = torch.arange(quad_scores.shape[0], device=pc.device)
    has_quad = (torch.softmax(quad_scores, dim=-1)[..., 1]
                > CONF_THRESH).any(-1)
    idx = ds[..., None].expand(-1, -1, 3)
    mn, mv, ms, msc, enough = quad_point_mixture_metric(
        quad_scores[rows, ind], ep[f"{prefix}quad_center"][rows, ind],
        ep[f"{prefix}normal_vector"][rows, ind],
        ep[f"{prefix}quad_size"][rows, ind],
        torch.gather(pc, 1, idx), torch.gather(pn, 1, idx), use_fitted)
    valid = has_quad & enough
    out = [torch.where(valid, m, 0.0).mean() for m in (mn, mv, ms, msc)]
    return (*out, valid.to(torch.float32).mean())
