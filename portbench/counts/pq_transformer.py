"""The PQ-Transformer's counts, from the configuration (the configuration
file's dict) and a batch of B clouds: the model FLOPs of a forward and of a
train step, and the least time of the point kernels and of the fused
SA-MLP kernel in one forward.

The model FLOPs are the work the model needs (2 a multiply-add of every
product of the published architecture), never what an implementation
launches, so a kernel that is faster or fused away leaves the count as it
is. Elementwise work (BatchNorm, ReLU, softmax, LayerNorm), FPS and the
ball query are not counted: they are no products. A train step counts the
student's forward and backward as 3 forwards and adds the teacher's forward
(`step_flops`).

The channel plan is the published model's (backbone_module.py of VoteNet /
PQ-Transformer): sa1 with MLP widths [64w]*d + [128w], sa2-sa4 [128w]*d +
[256w] (w = backbone_width, d = backbone_depth), fp1 and fp2 [256w, 256w]
and [256w, hidden_dim] on their skip-concatenated inputs; vote aggregation
[hidden]*3 over `vote_aggregation_nsample` samples at radius 0.3."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from portbench.counts import fused_mlp, point_kernels
from portbench.counts.layers import chain_flops


# --- the shapes -----------------------------------------------------------

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


# --- model FLOPs ----------------------------------------------------------

def forward_flops(cfg: Dict, B: int) -> int:
    hd, ffn = cfg["hidden_dim"], cfg["dim_feedforward"]
    nobj, nquad = cfg["num_proposal"], cfg["num_quad_proposal"]
    seeds = cfg["backbone_npoints"][1]
    nq = nobj + nquad
    f = 0
    for _, _, S, K, _, chans in sa_layers(cfg):
        f += chain_flops(B * S * K, chans)
    for _, rows, chans in fp_layers(cfg):
        f += chain_flops(B * rows, chans)
    f += chain_flops(B * seeds, [hd, hd, hd, 3 + hd])          # voting
    obj_out = (2 + 3 + 2 * cfg["num_heading_bin"]
               + 4 * cfg["num_size_cluster"] + cfg["num_class"])
    quad_out = 2 + 3 + 3 + 2

    def heads():  # one object and one quad head set
        return (chain_flops(B * nobj, [hd, hd, hd]) + 2 * B * nobj * hd * obj_out
                + chain_flops(B * nquad, [hd, hd, hd])
                + 2 * B * nquad * hd * quad_out)

    f += heads()                                                # proposals
    f += 2 * B * (nq + seeds) * hd * hd                         # q/k projs
    for _ in range(cfg["num_decoder_layers"]):
        f += chain_flops(B * nq, [3, hd, hd])                   # self pos
        f += chain_flops(B * seeds, [3, hd, hd])                # cross pos
        f += 2 * B * nq * hd * 3 * hd                           # self q,k,v
        f += 2 * 2 * B * nq * nq * hd                           # logits, PV
        f += 2 * B * nq * hd * hd                               # out proj
        f += 2 * B * nq * hd * hd + 2 * 2 * B * seeds * hd * hd  # cross q,k,v
        f += 2 * 2 * B * nq * seeds * hd                        # logits, PV
        f += 2 * B * nq * hd * hd                               # out proj
        f += chain_flops(B * nq, [hd, ffn, hd])                 # FFN
        f += heads()
    return f


def step_flops(cfg: Dict, B: int, teacher: bool) -> int:
    """One train step on B clouds: forward + backward (3 forwards), and the
    EMA teacher's forward on the same B where there is one."""
    return (3 + int(teacher)) * forward_flops(cfg, B)


# --- the kernels' least time in one forward -------------------------------

def fps_bound_s(cfg: Dict, B: int) -> float:
    return sum(point_kernels.fps_call_bound_s(B, N, S)
               for _, N, S in fps_calls(cfg))


def ball_query_bound_s(cfg: Dict, B: int) -> float:
    return sum(point_kernels.ball_query_call_bound_s(B, N, S, K)
               for _, N, S, K, _, _ in sa_layers(cfg))


def point_kernels_bound_s(cfg: Dict, B: int) -> float:
    return fps_bound_s(cfg, B) + ball_query_bound_s(cfg, B)


def fused_layers(cfg: Dict):
    """The SA layers the fused kernel takes (vote aggregation's 288 stays
    unfused)."""
    return [layer for layer in sa_layers(cfg)
            if fused_mlp.takes(cfg["compute_dtype"], layer[3], layer[5])]


def fused_mlp_bound_s(cfg: Dict, B: int, train: bool) -> Optional[float]:
    """None where the configuration runs no fused SA (`fused_sa` off)."""
    if not cfg.get("fused_sa"):
        return None
    total = 0.0
    for _, _, S, K, _, chans in fused_layers(cfg):
        total += fused_mlp.call_bound_s(cfg["compute_dtype"], B, S, K, chans,
                                        train)
    return total
