"""The shapes of the layers of one PQ-Transformer forward at a
configuration (the configuration file's dict) and a batch of B clouds:
what the counts of `pq_transformer.py`, `point_kernels.py` and
`fused_mlp.py` are worked out from. The channel plan is the published
model's (backbone_module.py of VoteNet / PQ-Transformer): sa1 with MLP
widths [64w]*d + [128w], sa2-sa4 [128w]*d + [256w] (w = backbone_width,
d = backbone_depth), fp1 and fp2 [256w, 256w] and [256w, hidden_dim] on
their skip-concatenated inputs; vote aggregation [hidden]*3 over
`vote_aggregation_nsample` samples at radius 0.3."""
from __future__ import annotations

from typing import Dict, List, Tuple


def sa_layers(cfg: Dict) -> List[Tuple[str, int, int, int, float, list]]:
    """(name, N points in, S centres, K samples, radius, MLP channels with
    the input width first) of each set-abstraction layer, the backbone's
    four and the vote aggregation."""
    w, d = cfg["backbone_width"], cfg["backbone_depth"]
    outs = [128 * w, 256 * w, 256 * w, 256 * w]
    mlps = [[64 * w] * d, [128 * w] * d, [128 * w] * d, [128 * w] * d]
    n_in = [cfg["num_points"]] + list(cfg["backbone_npoints"][:3])
    cin = cfg["input_feature_dim"]
    layers = []
    for i in range(4):
        layers.append((f"sa{i + 1}", n_in[i], cfg["backbone_npoints"][i],
                       cfg["backbone_nsamples"][i], cfg["backbone_radii"][i],
                       [cin + 3] + mlps[i] + [outs[i]]))
        cin = outs[i]
    hd = cfg["hidden_dim"]
    layers.append(("vote_aggregation", cfg["backbone_npoints"][1],
                   cfg["num_proposal"], cfg["vote_aggregation_nsample"], 0.3,
                   [hd + 3, hd, hd, hd]))
    return layers


def fps_calls(cfg: Dict) -> List[Tuple[str, int, int]]:
    """(name, N points, npoint) of each FPS of a forward: the four SA
    layers, the quad queries over the seeds, the vote aggregation."""
    seeds = cfg["backbone_npoints"][1]
    return ([(n, N, S) for n, N, S, _, _, _ in sa_layers(cfg)[:4]]
            + [("quad_queries", seeds, cfg["num_quad_proposal"]),
               ("vote_aggregation", seeds, cfg["num_proposal"])])


def fp_layers(cfg: Dict) -> List[Tuple[str, int, list]]:
    """(name, rows, channels) of the two feature-propagation MLPs."""
    w = cfg["backbone_width"]
    outs = [128 * w, 256 * w, 256 * w, 256 * w]
    np_ = cfg["backbone_npoints"]
    return [("fp1", np_[2], [outs[3] + outs[2], 256 * w, 256 * w]),
            ("fp2", np_[1], [256 * w + outs[1], 256 * w, cfg["hidden_dim"]])]


def chain_flops(rows: int, chans) -> int:
    """Operations of one Dense chain over `rows` rows (2 a multiply-add):
    chip_smoke.py's `chain_flops`."""
    return 2 * rows * sum(a * b for a, b in zip(chans[:-1], chans[1:]))
