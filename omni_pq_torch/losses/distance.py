"""Legacy distance-based layout pseudo-label loss (the port of
`omni_pq_tpu/losses/distance.py`).

Reference: models/utils/distance_util.py — `calc_distance_vertically`
(:111-146), `distance_loss_gamma_mixture` (:310-394) and the
spectral-clustering debug variant `distance_loss_spectral_clustering`
(:192-307), reachable only through `get_loss_distance`
(loss_helper_pq.py:488-500), never from train.py or eval.py.

As in the JAX package: each point's signed distance to every quad plane in
one contraction over fixed-shape masked quads, the nearest by a
first-occurrence argmin over a 10.0 init row (the reference's strict-<
running update); the mixture fit on the port's fixed-iteration EM
(`losses/gamma.py`), every scene of the batch at once; the pdf crossover
by a fixed 40-step bisection of the log-pdf difference, where the
reference calls scipy's `opt.root`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .gamma import gamma_logpdf, gamma_mixture_em

# semantic classes forming the "layout" set (distance_util.py:322-325):
# wall (1), door (8), window (9) in the nyu40-mapped ids the reference
# indexes with
LAYOUT_CLASSES = (1, 8, 9)
_NO_QUAD_DIST = 10.0  # distance init of points no quad updates (:117)


def _distance_vertically(points, quad_corners, quad_mask):
    """Batched `calc_distance_vertically`: points (..., N, 3), quad_corners
    (..., Q, 4, 3), quad_mask (..., Q) -> distance (..., N), idx (..., N)."""
    pc_center = points.mean(-2)
    q_center = quad_corners.mean(-2)  # (..., Q, 3)
    c = quad_corners
    n = torch.linalg.cross(c[..., 1, :] - c[..., 0, :],
                           c[..., 2, :] - c[..., 0, :], dim=-1)
    n = n / torch.clamp_min(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                            1e-12)
    # orient so that the inner side (toward the scene centroid) is negative
    flip = ((pc_center[..., None, :] - q_center) * n).sum(-1) > 0
    n = torch.where(flip[..., None], -n, n)
    # (..., Q, N) signed distances in one contraction
    d = torch.einsum("...qnc,...qc->...qn",
                     points[..., None, :, :] - q_center[..., :, None, :], n)
    d = torch.where(quad_mask[..., None], d, torch.inf)
    # row 0 is the 10.0 init; argmin takes the first occurrence, as the
    # reference's strict-< running update keeps the earliest quad on a tie
    init = torch.full_like(d[..., :1, :], _NO_QUAD_DIST)
    cand = torch.cat([init, d], dim=-2)
    sel = torch.argmin(cand.abs(), dim=-2)
    dist = torch.gather(cand, -2, sel[..., None, :])[..., 0, :]
    idx = torch.where(sel == 0, 1.0, (sel - 1).to(points.dtype))
    return dist, idx


def calc_distance_vertically(points: torch.Tensor, quad_corners: torch.Tensor,
                             quad_mask: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signed vertical distance from each point to its nearest quad plane.

    points (N, 3), quad_corners (Q, 4, 3) predicted corners, quad_mask (Q,)
    bool (False rows are ignored: the fixed-shape stand-in for the
    reference's variable-length post-NMS list) -> (distance (N,), idx (N,)
    float32): the signed distance to the quad of least |distance| (the
    inner side negative, distance_util.py:132-133) and that quad's index;
    points no valid quad reaches keep the reference's init (10.0, 1.0)."""
    if quad_mask is None:
        quad_mask = torch.ones(quad_corners.shape[0], dtype=torch.bool,
                               device=quad_corners.device)
    dist, idx = _distance_vertically(points[None], quad_corners[None],
                                     quad_mask[None])
    return dist[0], idx[0]


def _pdf_crossover(a1, b1, a2, b2, w, iters: int = 40):
    """x where w * pdf_a(x) = (1 - w) * pdf_b(x), elementwise, by bisection
    between the components' modes (fit.py:143-146 solves the same equation
    with opt.root seeded at the modes' midpoint)."""
    def mode(a, b):
        return torch.clamp_min(a - 1.0, 1e-3) / torch.clamp_min(b, 1e-6)

    lo = torch.minimum(mode(a1, b1), mode(a2, b2)) * 1e-3 + 1e-6
    hi = torch.maximum(mode(a1, b1), mode(a2, b2)) * 4.0 + 1e-3

    def f(x):
        return (torch.log(w) + gamma_logpdf(x, a1, b1)
                - torch.log1p(-w) - gamma_logpdf(x, a2, b2))

    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        go_right = f(mid) > 0  # still on the near component's side
        lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid)
    return 0.5 * (lo + hi)


def distance_loss_gamma_mixture(points: torch.Tensor,
                                semantic_labels: torch.Tensor,
                                quad_corners: torch.Tensor,
                                quad_mask: torch.Tensor
                                ) -> Tuple[torch.Tensor, Dict]:
    """The legacy distance loss over a batch (distance_util.py:310-394).

    points (B, N, 3) float32, semantic_labels (B, N) nyu40-mapped labels,
    quad_corners (B, Q, 4, 3) post-parse corners
    (`evals.parse_quad_predictions`), quad_mask (B, Q) bool -> (loss, aux
    with 'distance', 'idx_array', 'keep_mask', 'layout_mask', each (B, N)).
    The loss is the mean |distance| of each scene's kept layout points,
    averaged over the scenes that keep any (lambda_distance = 1, :392-394).
    As in the JAX package, the EM fits each scene's layout points with the
    others replaced by the layout points' mean |distance| (the reference
    fits the exact subset)."""
    layout = torch.zeros(semantic_labels.shape, dtype=torch.bool,
                         device=semantic_labels.device)
    for c in LAYOUT_CLASSES:
        layout = layout | (semantic_labels == c)
    dist, idx = _distance_vertically(points, quad_corners, quad_mask)
    d_abs = torch.where(layout, dist, 1.0).abs() + 1e-12
    n_lay = layout.sum(-1, keepdim=True)
    lay_mean = (torch.where(layout, d_abs, 0.0).sum(-1, keepdim=True)
                / torch.clamp_min(n_lay, 1))
    d_fit = torch.where(layout, d_abs, lay_mean)
    a1, b1, a2, b2, w = gamma_mixture_em(d_fit, 2.0, 40.0, 10.0, 20.0, 0.5,
                                         20)
    root = _pdf_crossover(a1, b1, a2, b2, w)  # (B, 1)
    keep = layout & (d_abs < root)  # below-crossover points (fit.py:146)
    n_keep = keep.sum(-1)
    scene_loss = (torch.where(keep, dist.abs(), 0.0).sum(-1)
                  / torch.clamp_min(n_keep, 1))
    fit = n_keep > 0
    total_fit = fit.to(dist.dtype).sum()
    loss = (torch.where(fit, scene_loss, 0.0).sum()
            / torch.clamp_min(total_fit, 1.0))
    aux = {"distance": dist, "idx_array": idx, "keep_mask": keep,
           "layout_mask": layout}
    return loss, aux


def spectral_layout_clustering(points, semantic_labels, n_select: int = 1000,
                               lambdas=(0.1, 1.0, 0.0),
                               threshold_k: float = 0.1,
                               num_gt_quads=None, dump_path=None, seed=0):
    """Spectral clustering of layout points, the reference's debug variant
    distance_loss_spectral_clustering (distance_util.py:192-307), on the
    host with numpy (and sklearn where it is installed). Not a loss (the
    reference returns 0): it partitions wall/door/window points into planar
    clusters.

    As in the JAX package: normals from the k-NN PCA estimator
    (`data.preprocess.estimate_normals`, the native core) instead of
    open3d's, the sample from a seeded numpy Generator instead of
    `random.sample`; without sklearn the labels are all 0 (the eigengap
    count K is still computed).

    points (N, 3), semantic_labels (N,) (layout: {1, 8, 9}); n_select points
    for the affinity (SELECTION=1000); lambdas the (euclid, cosine, d^2)
    distance weights (:278); threshold_k the eigenvalue threshold that
    counts the clusters (:295); num_gt_quads, when given, prints the
    reference's eigengap diagnostic (:287-291); dump_path writes the
    reference's coloured dump (x y z r g b nx ny nz 1.0 rows, :302-306).
    Returns dict(labels (n_select,), K, selected (n_select, 3), normals
    (n_select, 3), eigenvalues)."""
    from ..data.preprocess import estimate_normals

    points = np.asarray(points)
    semantic_labels = np.asarray(semantic_labels)
    layout = points[np.isin(semantic_labels, LAYOUT_CLASSES)]
    if len(layout) < 4:
        return {"labels": np.zeros(0, np.int64), "K": 0,
                "selected": np.zeros((0, 3)), "normals": np.zeros((0, 3)),
                "eigenvalues": np.zeros(0)}
    n_select = min(n_select, len(layout))
    rng = np.random.default_rng(seed)
    choice = rng.choice(len(layout), n_select, replace=False)
    sel = layout[choice]

    # pairwise euclid (:240)
    euclid = np.sqrt(((sel[:, None] - sel[None]) ** 2).sum(-1))

    # normals, flipped away from the layout centroid (:245-256: the
    # reference flips where (p - center) . n < 0)
    normals = estimate_normals(layout, k=min(5, len(layout) - 1))
    centered = layout - layout.mean(0)
    flip = (centered * normals).sum(1) < 0
    normals[flip] = -normals[flip]
    sel_n = normals[choice]

    cosine = 1.0 - sel_n @ sel_n.T + 1e-5  # (:262-268)
    d = -(sel_n * sel).sum(1)  # plane offsets (:274-276)
    d2 = np.abs(d[:, None] - d[None]) ** 2
    distance = lambdas[0] * euclid + lambdas[1] * cosine + lambdas[2] * d2

    # normalised affinity and its eigen spectrum (:281-286)
    std = distance.std()
    Z = np.exp(-distance ** 2 / (2 * std ** 2))
    Dm = np.diag(np.sum(Z, axis=1) ** (-0.5))
    Zt = Dm @ Z @ Dm
    eigenvalues = np.linalg.eigvalsh(Zt)[::-1]

    if num_gt_quads is not None and num_gt_quads >= 1:
        lo, hi = eigenvalues[num_gt_quads - 1], eigenvalues[num_gt_quads]
        print(f"gt num quad {num_gt_quads}  threshold {lo} {hi} "
              f"avg {(lo + hi) / 2}")
        print(eigenvalues[:6])

    K = int((eigenvalues > threshold_k).sum())
    try:
        from sklearn import cluster
        labels = cluster.spectral_clustering(
            n_clusters=max(K, 1), affinity=np.asarray(Zt), random_state=seed)
    except ImportError:  # no sklearn: the eigengap count only
        labels = np.zeros(n_select, np.int64)

    if dump_path is not None:
        from ..utils.viz import label_palette
        colors = label_palette(labels)
        with open(dump_path, "w") as f:
            for k in range(n_select):
                c = colors[k] / 255.0
                f.write(f"{sel[k][0]} {sel[k][1]} {sel[k][2]} "
                        f"{c[0]} {c[1]} {c[2]} "
                        f"{sel_n[k][0]} {sel_n[k][1]} {sel_n[k][2]} 1.0\n")
    return {"labels": np.asarray(labels), "K": K, "selected": sel,
            "normals": sel_n, "eigenvalues": eigenvalues}
