"""Plain PyTorch reference of the PQ-Transformer forward (eval and train
mode), for the benchmark's comparison.

A frozen copy of `omni_pq_torch/models/{pq_transformer,backbone,pointnet2,
transformer,heads}.py` at commit 4c1c1dacbb14fd55b2b315e6b58815882cf32f9c,
cut to the path that `ModelConfig()` runs: no fused SA-MLP kernel (its plain
chain stands in), no rematerialisation, no data parallelism, no modules off
the model's path; every point op from `reference/ops.py`. Module and
parameter names are the published model's (PQ-Transformer's
`models/pq_transformer.py`, VoteNet's `pointnet2_modules.py`), so a
state_dict moves between the program and this file as it is.

Arithmetic follows the published model, with these departures, all of them
the JAX package's, which the program keeps too:
  - BatchNorm takes the biased batch variance max(0, E[x^2] - E[x]^2) and
    moves its running stats by 0.9 old + 0.1 batch (flax's convention);
  - attention computes q, k and v with separate products, divides the
    logits by sqrt(head dim) after the product, softmaxes in float32;
  - the quad normal is normalised per vector, not by the tensor's norm;
  - under bfloat16 the 1x1 convolutions, the q/k/v projections and the FFN
    compute in bfloat16 (each product summed in float32, its result rounded
    to bfloat16, the bias added after), BatchNorm, LayerNorm, softmax, the
    heads' output layers and every residual stay float32.
`low=True` rounds the operands of every product to float8 e4m3 (the
control). Dropout masks come from the generator passed to `forward`, drawn
in the order the program draws them: each decoder layer's self-attention
weights, its output, the cross-attention weights, its output, the FFN's
hidden layer, its output.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import ops

BN_MOMENTUM = 0.9
BN_EPS = 1e-5
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}
# the ScanNet class mean sizes (scannet_means.npz of the published code)
MEAN_SIZES = (
    (0.76966726, 0.81160211, 0.92573741), (1.876858, 1.84255952, 1.19315654),
    (0.61327999, 0.61486087, 0.71827014), (1.39550063, 1.51215451, 0.83443565),
    (0.97949596, 1.06751485, 0.63296875), (0.53166301, 0.59555772, 1.75001483),
    (0.96247056, 0.72462326, 1.14818682), (0.83221924, 1.04909355, 1.68756634),
    (0.21132214, 0.4206159, 0.53728459), (1.44400728, 1.89708334, 0.26985747),
    (1.02942616, 1.40407966, 0.87554322), (1.37664116, 0.65521793, 1.68131292),
    (0.66508189, 0.71111926, 1.29885307), (0.41999174, 0.37906947, 1.75139715),
    (0.59359559, 0.59124924, 0.73919014), (0.50867595, 0.50656087, 0.30136236),
    (1.15115265, 1.0546296, 0.49706794), (0.47535286, 0.49249493, 0.58021168))


def mean_sizes(device) -> torch.Tensor:
    return torch.tensor(MEAN_SIZES, dtype=torch.float32, device=device)


def acc(dt: torch.dtype) -> torch.dtype:
    return torch.promote_types(dt, torch.float32)


def linear(x, weight, bias, dt, low):
    """A dense layer computed in `dt` (float32 or float64, or bfloat16 with
    the bias added to the rounded product)."""
    x, w = x.to(dt), weight.to(dt)
    if dt != torch.bfloat16 and not low:
        return F.linear(x, w, None if bias is None else bias.to(dt))
    y = ops.matmul(x, w.T, low)
    return y if bias is None else y + bias.to(dt)


def dropout(x, p, training, generator):
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class Conv(nn.Module):
    """A 1x1 convolution on the last axis; the weight keeps the published
    (out, in, 1, ...) shape. `dt` None: the promoted type of input and
    weight."""

    def __init__(self, cin, cout, kernel_dims=1, bias=True, dt=None,
                 low=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((cout, cin) + (1,) * kernel_dims))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.dt, self.low = dt, low

    def forward(self, x):
        dt = self.dt or torch.promote_types(x.dtype, self.weight.dtype)
        return linear(x, self.weight.flatten(1), self.bias, dt, self.low)


class BatchNorm(nn.BatchNorm1d):
    def __init__(self, channels, dt=None):
        super().__init__(channels, eps=BN_EPS)
        self.dt = dt

    def forward(self, x):
        x = x.to(acc(x.dtype))
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dim=dims)
            var = torch.clamp_min((x * x).mean(dim=dims) - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                        + (1 - BN_MOMENTUM) * mean)
                self.running_var.copy_(BN_MOMENTUM * self.running_var
                                       + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean) * mul + self.bias).to(self.dt or x.dtype)


class _BN(nn.Module):
    def __init__(self, channels, dt):
        super().__init__()
        self.bn = BatchNorm(channels, dt)

    def forward(self, x):
        return self.bn(x)


class _MLPLayer(nn.Module):
    def __init__(self, cin, cout, dt, low):
        super().__init__()
        self.conv = Conv(cin, cout, kernel_dims=2, bias=False, dt=dt, low=low)
        self.bn = _BN(cout, dt)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class SharedMLP(nn.Sequential):
    def __init__(self, channels: Sequence[int], dt, low):
        super().__init__()
        for i, (cin, cout) in enumerate(zip(channels[:-1], channels[1:])):
            self.add_module(f"layer{i}", _MLPLayer(cin, cout, dt, low))


class SAModuleVotes(nn.Module):
    """FPS -> ball query + grouping (xyz relative to the centre, over the
    radius) -> SharedMLP -> max over the samples."""

    def __init__(self, npoint, radius, nsample, in_channels, mlp, dt, low):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.mlp_module = SharedMLP([in_channels + 3, *mlp], dt, low)

    def forward(self, xyz, features=None, inds=None):
        if inds is None:
            inds = ops.fps(xyz, self.npoint)
        new_xyz = ops.gather_points(xyz, inds)
        idx = ops.ball_query(self.radius, self.nsample, xyz, new_xyz)
        grouped = (ops.group_points(xyz, idx)
                   - new_xyz[:, :, None, :]) / self.radius
        if features is not None:
            grouped = torch.cat([grouped, ops.group_points(features, idx)],
                                dim=-1)
        return new_xyz, self.mlp_module(grouped).amax(dim=2), inds


class FPModule(nn.Module):
    def __init__(self, channels, dt, low):
        super().__init__()
        self.mlp = SharedMLP(channels, dt, low)

    def forward(self, unknown_xyz, known_xyz, unknown_feats, known_feats):
        interp = ops.interpolate(unknown_xyz, known_xyz, known_feats)
        return self.mlp(torch.cat([interp, unknown_feats], dim=-1))


class Backbone(nn.Module):
    def __init__(self, cfg, dt, low):
        super().__init__()
        w, d = cfg["backbone_width"], cfg["backbone_depth"]
        outs = [128 * w, 256 * w, 256 * w, 256 * w]
        mlps = [[64 * w] * d, [128 * w] * d, [128 * w] * d, [128 * w] * d]
        cin = cfg["input_feature_dim"]
        for i in range(4):
            self.add_module(f"sa{i + 1}", SAModuleVotes(
                cfg["backbone_npoints"][i], cfg["backbone_radii"][i],
                cfg["backbone_nsamples"][i], cin, mlps[i] + [outs[i]], dt,
                low))
            cin = outs[i]
        self.fp1 = FPModule([outs[3] + outs[2], 256 * w, 256 * w], dt, low)
        self.fp2 = FPModule([256 * w + outs[1], 256 * w, cfg["hidden_dim"]],
                            dt, low)

    def forward(self, pc):
        xyz = pc[..., 0:3].contiguous()
        feats = pc[..., 3:] if pc.shape[-1] > 3 else None
        ep = {}
        xyz1, f1, inds1 = self.sa1(xyz, feats)
        ep["sa1_inds"], ep["sa1_xyz"], ep["sa1_features"] = inds1, xyz1, f1
        xyz2, f2, inds2 = self.sa2(xyz1, f1)
        ep["sa2_inds"], ep["sa2_xyz"], ep["sa2_features"] = inds2, xyz2, f2
        xyz3, f3, _ = self.sa3(xyz2, f2)
        ep["sa3_xyz"], ep["sa3_features"] = xyz3, f3
        xyz4, f4, _ = self.sa4(xyz3, f3)
        ep["sa4_xyz"], ep["sa4_features"] = xyz4, f4
        up2 = self.fp2(xyz2, xyz3, f2, self.fp1(xyz3, xyz4, f3, f4))
        ep["fp2_features"] = ep["seed_features"] = up2
        ep["fp2_xyz"] = ep["seed_xyz"] = xyz2
        ep["fp2_inds"] = ep["seed_inds"] = inds1[:, :xyz2.shape[1]]
        return ep


class VotingModule(nn.Module):
    def __init__(self, d, dt, low):
        super().__init__()
        self.conv1 = Conv(d, d, dt=dt, low=low)
        self.bn1 = BatchNorm(d)
        self.conv2 = Conv(d, d, dt=dt, low=low)
        self.bn2 = BatchNorm(d)
        self.conv3 = Conv(d, 3 + d, dt=dt, low=low)
        self.dt = dt

    def forward(self, seed_xyz, seed_features):
        net = torch.relu(self.bn1(self.conv1(seed_features)))
        net = torch.relu(self.bn2(self.conv2(net)))
        net = self.conv3(net).to(acc(self.dt))
        return seed_xyz + net[..., 0:3], seed_features + net[..., 3:]


class PositionEmbeddingLearned(nn.Module):
    def __init__(self, d, low):
        super().__init__()
        self.position_embedding_head = nn.Sequential(
            Conv(3, d, low=low), BatchNorm(d), nn.ReLU(), Conv(d, d, low=low))

    def forward(self, xyz):
        return self.position_embedding_head(xyz)


class MultiHeadAttention(nn.Module):
    def __init__(self, d, nhead, p, dt, low):
        super().__init__()
        self.nhead, self.p, self.dt, self.low = nhead, p, dt, low
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = Conv(d, d, kernel_dims=0, low=low)

    def forward(self, q, k, v, generator=None):
        B, Lq, D = q.shape
        H = self.nhead
        hd = D // H
        dt, a = self.dt, acc(self.dt)
        w, b = self.in_proj_weight, self.in_proj_bias
        qp = linear(q, w[:D], b[:D], dt, self.low).reshape(B, Lq, H, hd)
        kp = linear(k, w[D:2 * D], b[D:2 * D], dt, self.low).reshape(
            B, -1, H, hd)
        vp = linear(v, w[2 * D:], b[2 * D:], dt, self.low).reshape(
            B, -1, H, hd)
        logits = ops.matmul(qp.to(a).transpose(1, 2),
                            kp.to(a).permute(0, 2, 3, 1),
                            self.low) / math.sqrt(hd)
        weights = dropout(torch.softmax(logits, dim=-1), self.p,
                          self.training, generator)
        out = ops.matmul(weights.to(dt), vp.transpose(1, 2), self.low)
        out = out.transpose(1, 2).to(a).reshape(B, Lq, D)
        return self.out_proj(out)


class DecoderLayer(nn.Module):
    def __init__(self, d, nhead, ffn, self_pos, cross_pos, p, dt, low):
        super().__init__()
        self.p = p
        self.self_attn = MultiHeadAttention(d, nhead, p, dt, low)
        self.multihead_attn = MultiHeadAttention(d, nhead, p, dt, low)
        self.linear1 = Conv(d, ffn, kernel_dims=0, dt=dt, low=low)
        self.linear2 = Conv(ffn, d, kernel_dims=0, dt=dt, low=low)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        self.norm3 = nn.LayerNorm(d, eps=1e-5)
        self.self_posembed = self_pos
        self.cross_posembed = cross_pos
        self.dt = dt

    def forward(self, query, key, query_pos, key_pos, generator=None):
        def drop(x):
            return dropout(x, self.p, self.training, generator)

        q_embed = self.self_posembed(query_pos)
        k_embed = self.cross_posembed(key_pos)
        qkv = query + q_embed
        query = self.norm1(query + drop(self.self_attn(qkv, qkv, qkv,
                                                       generator)))
        kv = key + k_embed
        attn = self.multihead_attn(query + q_embed, kv, kv, generator)
        query = self.norm2(query + drop(attn))
        ff = self.linear2(drop(torch.relu(self.linear1(query)))).to(
            acc(self.dt))
        return self.norm3(query + drop(ff))


class _Trunk(nn.Module):
    def __init__(self, d, dt, low):
        super().__init__()
        self.conv1 = Conv(d, d, dt=dt, low=low)
        self.bn1 = BatchNorm(d)
        self.conv2 = Conv(d, d, dt=dt, low=low)
        self.bn2 = BatchNorm(d)

    def trunk(self, net):
        net = torch.relu(self.bn1(self.conv1(net)))
        return torch.relu(self.bn2(self.conv2(net)))


class PredictHead(_Trunk):
    def __init__(self, d, nh, ns, nc, dt, low):
        super().__init__(d, dt, low)
        self.nh, self.ns = nh, ns
        self.objectness_scores_head = Conv(d, 2, low=low)
        self.center_head = Conv(d, 3, low=low)
        self.heading_class_head = Conv(d, nh, low=low)
        self.heading_residual_head = Conv(d, nh, low=low)
        self.size_class_head = Conv(d, ns, low=low)
        self.size_residual_head = Conv(d, ns * 3, low=low)
        self.sem_cls_scores_head = Conv(d, nc, low=low)

    def forward(self, net, base_xyz, prefix):
        net = self.trunk(net)
        B, K = net.shape[:2]
        ms = mean_sizes(net.device)
        center = self.center_head(net) + base_xyz
        hr = self.heading_residual_head(net)
        size_scores = self.size_class_head(net)
        srn = self.size_residual_head(net).reshape(B, K, self.ns, 3)
        size_res = srn * ms
        cls = torch.argmax(size_scores, dim=-1)
        pred_size = torch.gather(size_res + ms, 2, cls[..., None, None].expand(
            -1, -1, 1, 3))[:, :, 0]
        return center, {
            f"{prefix}objectness_scores": self.objectness_scores_head(net),
            f"{prefix}center": center,
            f"{prefix}heading_scores": self.heading_class_head(net),
            f"{prefix}heading_residuals_normalized": hr,
            f"{prefix}heading_residuals": hr * (math.pi / self.nh),
            f"{prefix}size_scores": size_scores,
            f"{prefix}size_residuals_normalized": srn,
            f"{prefix}size_residuals": size_res,
            f"{prefix}pred_size": pred_size,
            f"{prefix}sem_cls_scores": self.sem_cls_scores_head(net)}


class QuadPredictHead(_Trunk):
    def __init__(self, d, dt, low):
        super().__init__(d, dt, low)
        self.quad_scores_head = Conv(d, 2, low=low)
        self.center_head = Conv(d, 3, low=low)
        self.normal_vector_head = Conv(d, 3, low=low)
        self.size_head = Conv(d, 2, low=low)

    def forward(self, net, base_xyz, prefix):
        net = self.trunk(net)
        center = self.center_head(net) + base_xyz
        normal = self.normal_vector_head(net)
        normal = normal / (torch.linalg.vector_norm(
            normal, dim=-1, keepdim=True) + 1e-8)
        return center, {
            f"{prefix}quad_scores": self.quad_scores_head(net),
            f"{prefix}quad_center": center,
            f"{prefix}normal_vector": normal,
            f"{prefix}quad_size": self.size_head(net)}


def decoder_prefixes(num_layers: int):
    return (["proposal_"] + [f"{i}head_" for i in range(num_layers - 1)]
            + ["last_"])


# the end points of the backbone and the voting: what `forward_heads` takes
STAGE_A_INPUTS = ("seed_xyz", "seed_features", "vote_xyz", "vote_features")


class PQTransformer(nn.Module):
    """`cfg` is the configuration file's dict (the ModelConfig fields)."""

    def __init__(self, cfg: Dict, low: bool = False):
        super().__init__()
        self.cfg = cfg
        hd = cfg["hidden_dim"]
        dt = DTYPES[cfg["compute_dtype"]]
        self.backbone = Backbone(cfg, dt, low)
        self.vote = VotingModule(hd, dt, low)
        self.vote_aggregation = SAModuleVotes(
            cfg["num_proposal"], 0.3, cfg["vote_aggregation_nsample"], hd,
            [hd, hd, hd], dt, low)
        obj = (hd, cfg["num_heading_bin"], cfg["num_size_cluster"],
               cfg["num_class"], dt, low)
        self.proposal = PredictHead(*obj)
        self.quad_proposal = QuadPredictHead(hd, dt, low)
        self.decoder_query_proj = Conv(hd, hd, low=low)
        self.quad_decoder_query_proj = Conv(hd, hd, low=low)
        self.decoder_key_proj = Conv(hd, hd, low=low)
        L = cfg["num_decoder_layers"]
        self.decoder_self_posembeds = nn.ModuleList(
            PositionEmbeddingLearned(hd, low) for _ in range(L))
        self.decoder_cross_posembeds = nn.ModuleList(
            PositionEmbeddingLearned(hd, low) for _ in range(L))
        self.decoder = nn.ModuleList(
            DecoderLayer(hd, cfg["nhead"], cfg["dim_feedforward"],
                         self.decoder_self_posembeds[i],
                         self.decoder_cross_posembeds[i], cfg["dropout"], dt,
                         low)
            for i in range(L))
        self.prediction_heads = nn.ModuleList(PredictHead(*obj)
                                              for _ in range(L))
        self.prediction_quad_heads = nn.ModuleList(
            QuadPredictHead(hd, dt, low) for _ in range(L))

    def forward_stage_a(self, pc):
        """Backbone and voting: the end points up to the votes."""
        ep = self.backbone(pc)
        vote_xyz, vote_feat = self.vote(ep["seed_xyz"], ep["seed_features"])
        ep["vote_xyz"] = vote_xyz
        ep["vote_features"] = vote_feat / (torch.linalg.vector_norm(
            vote_feat, dim=-1, keepdim=True) + 1e-8)
        return ep

    def forward_heads(self, ep, generator: Optional[torch.Generator] = None):
        """Vote aggregation, the quad queries, the proposals and the
        decoder, from the STAGE_A_INPUTS of `ep`; returns their end
        points."""
        cfg = self.cfg
        seed_xyz, seed_feat = ep["seed_xyz"], ep["seed_features"]
        out = {}
        quad_inds = ops.fps(seed_xyz, cfg["num_quad_proposal"])
        quad_xyz = ops.gather_points(seed_xyz, quad_inds)
        quad_feat = ops.gather_points(seed_feat, quad_inds)
        out["aggregated_sample_xyz"] = quad_xyz
        cluster_xyz, cluster_feat, _ = self.vote_aggregation(
            ep["vote_xyz"], ep["vote_features"])
        out["aggregated_vote_xyz"] = cluster_xyz
        out["cluster_feature"] = cluster_feat
        center, p = self.proposal(cluster_feat, cluster_xyz, "proposal_")
        out.update(p)
        center_q, p = self.quad_proposal(quad_feat, quad_xyz, "proposal_")
        out.update(p)
        query = torch.cat([self.decoder_query_proj(cluster_feat),
                           self.quad_decoder_query_proj(quad_feat)], dim=1)
        key = self.decoder_key_proj(seed_feat)
        nobj = cfg["num_proposal"]
        for i, prefix in enumerate(
                decoder_prefixes(cfg["num_decoder_layers"])[1:]):
            query_pos = torch.cat([center, center_q], dim=1).detach()
            query = self.decoder[i](query, key, query_pos, seed_xyz,
                                    generator)
            center, p = self.prediction_heads[i](query[:, :nobj],
                                                 cluster_xyz, prefix)
            out.update(p)
            center_q, p = self.prediction_quad_heads[i](query[:, nobj:],
                                                        quad_xyz, prefix)
            out.update(p)
        return out

    def forward(self, pc, generator: Optional[torch.Generator] = None):
        ep = self.forward_stage_a(pc)
        ep.update(self.forward_heads(ep, generator))
        return ep
