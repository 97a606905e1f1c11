"""The model FLOPs of PQ-Transformer, counted from the configuration and
the batch: the work the model needs (2 a multiply-add of every product of
the published architecture), never what an implementation launches, so a
kernel that is faster or fused away leaves the count as it is. Elementwise
work (BatchNorm, ReLU, softmax, LayerNorm), FPS and the ball query are not
counted: they are no products.

A train step counts the student's forward and backward as 3 forwards and
adds the teacher's forward (`step_flops`)."""
from __future__ import annotations

from typing import Dict

from .layers import chain_flops, fp_layers, sa_layers


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
