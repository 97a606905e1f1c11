"""3DETR-m's counts, from the configuration (the configuration file's
dict) and a batch of B clouds: the model FLOPs of a forward, and the least
time of the point kernels, of the fused SA-MLP kernel and of the
radius-attention kernel in one forward.

The model FLOPs are the work the published model does (2 a multiply-add of
every product), never what an implementation launches: attention counts
every pair of tokens, as the published nn.MultiheadAttention computes the
logits and the product with v over all of them and masks after, so a kernel
that skips masked pairs leaves the count as it is. Elementwise work
(BatchNorm, LayerNorm, ReLU, softmax, the Fourier embedding's sin and cos,
the box processing), FPS and the ball query are not counted: they are no
products.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from portbench.counts import fused_mlp, point_kernels
from portbench.counts.layers import chain_flops
from portbench.peaks import F32_OPS_PER_S, bound_s


def sa_layers(cfg: Dict) -> List[Tuple[str, int, int, int, list]]:
    """(name, N points in, S centres, K samples, MLP channels with the
    input width first) of the two set-abstraction layers."""
    d, S = cfg["enc_dim"], cfg["preenc_npoints"]
    return [("pre_encoder", cfg["num_points"], S, cfg["preenc_nsample"],
             [3 + cfg["input_feature_dim"], *cfg["preenc_mlp"], d]),
            ("interim", S, S // 2, cfg["interim_nsample"],
             [d + 3, *cfg["interim_mlp"], d])]


def fps_calls(cfg: Dict) -> List[Tuple[str, int, int]]:
    """(name, N points, npoint) of each FPS of a forward."""
    S = cfg["preenc_npoints"]
    return [("pre_encoder", cfg["num_points"], S), ("interim", S, S // 2),
            ("queries", S // 2, cfg["num_queries"])]


def encoder_tokens(cfg: Dict) -> List[int]:
    """The tokens each encoder layer attends over: layer 0 the pre-encoder's
    points, the later layers the interim layer's."""
    S = cfg["preenc_npoints"]
    return [S] + [S // 2] * (cfg["enc_nlayers"] - 1)


def attention_flops(B: int, Lq: int, Lk: int, d: int, q_rows: int,
                    kv_rows: int) -> int:
    """One multi-head attention: the q projection of `q_rows` tokens, the k
    and v projections of `kv_rows`, the logits and the product with v over
    all Lq x Lk pairs, the output projection."""
    return (2 * B * q_rows * d * d + 2 * 2 * B * kv_rows * d * d
            + 2 * 2 * B * Lq * Lk * d + 2 * B * Lq * d * d)


def forward_flops(cfg: Dict, B: int) -> int:
    d, Q = cfg["dec_dim"], cfg["num_queries"]
    M = encoder_tokens(cfg)[-1]
    f = sum(chain_flops(B * S * K, chans)
            for _, _, S, K, chans in sa_layers(cfg))
    for N in encoder_tokens(cfg):
        f += attention_flops(B, N, N, d, N, N)
        f += chain_flops(B * N, [d, cfg["enc_ffn_dim"], d])
    f += chain_flops(B * M, [d, d, d])                    # to the decoder
    f += 2 * B * (Q + M) * 3 * (d // 2)                    # Fourier
    f += chain_flops(B * Q, [d, d, d])                    # query embedding
    for _ in range(cfg["dec_nlayers"]):
        f += attention_flops(B, Q, Q, d, Q, Q)
        f += attention_flops(B, Q, M, d, Q, M)
        f += chain_flops(B * Q, [d, cfg["dec_ffn_dim"], d])
    outs = (cfg["num_class"] + 1, 3, 3, cfg["num_angle_bin"],
            cfg["num_angle_bin"])
    f += cfg["dec_nlayers"] * sum(chain_flops(B * Q, [d, d, d, n])
                                  for n in outs)
    return f


def point_kernels_bound_s(cfg: Dict, B: int) -> float:
    """The three FPS and the two ball queries of a forward."""
    return (sum(point_kernels.fps_call_bound_s(B, N, S)
                for _, N, S in fps_calls(cfg))
            + sum(point_kernels.ball_query_call_bound_s(B, N, S, K)
                  for _, N, S, K, _ in sa_layers(cfg)))


def fused_mlp_bound_s(cfg: Dict, B: int, train: bool) -> Optional[float]:
    """The SA layers the fused kernel takes (the interim layer; the
    pre-encoder's 64-wide layer fails its gate); None where the
    configuration runs no fused SA (`fused_sa` off)."""
    if not cfg.get("fused_sa"):
        return None
    return sum(fused_mlp.call_bound_s(cfg["compute_dtype"], B, S, K, chans,
                                      train)
               for _, _, S, K, chans in sa_layers(cfg)
               if fused_mlp.takes(cfg["compute_dtype"], K, chans))


def radius_attention_bound_s(cfg: Dict, B: int) -> float:
    """The least time of the encoder's radius-masked attention: for each
    layer the bytes of reading q, k, v (B x N x d each, float32) and the
    points' xyz once and writing the output (B x N x d) once, at the HBM
    rate. Which pairs a radius keeps depends on the room, and a kernel may
    skip the tiles it masks, so only these bytes are work that every
    implementation must do: the share of this bound can never read over
    100 %. The pairs' operations are not part of the bound."""
    d = cfg["enc_dim"]
    return sum(bound_s(4 * B * N * (3 * d + 3 + d), 0.0, F32_OPS_PER_S)
               for N in encoder_tokens(cfg))
