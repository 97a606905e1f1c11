"""3DETR-m (Misra, Girdhar and Joulin, ICCV 2021), eval mode: a PointNet++
pre-encoder, a transformer encoder whose attention is masked by radius,
FPS queries with Fourier embeddings, a pre-norm transformer decoder and
per-layer box heads (the published github.com/facebookresearch/3detr:
models/model_3detr.py, transformer.py, helpers.py, position_embedding.py).

Channel-last throughout. The forward, at `ThreeDETRConfig`:
  - pre-encoder (`SAModuleVotes`): FPS to `preenc_npoints`, the ball query,
    relative xyz over the radius, the shared MLP, the max over the samples;
  - encoder: `enc_nlayers` pre-norm layers,
    x = x + MHA(LN1(x)) under the layer's radius mask, then
    x = x + W2 relu(W1 LN2(x)); no position embedding, no final norm. Layer
    0 runs on the pre-encoder's points, then the interim SA layer
    (`interim_downsampling`) takes half of them and layers 1.. run on
    those. The attention is `ops.radius_attention` (the CUDA kernel on the
    card, which writes neither logits nor a mask), q scaled before the
    product as nn.MultiheadAttention does;
  - the encoder-to-decoder projection (conv, BN, ReLU, twice);
  - queries: FPS of `num_queries` encoder points; the Fourier embedding of
    xyz normalised by the cloud's per-axis min and max, times 2 pi, as
    [sin(xyz B), cos(xyz B)]; the query embedding relu(conv(relu(conv(.))));
  - decoder: `dec_nlayers` pre-norm layers from t = 0,
    t = t + SA(LN1(t) + qpos, LN1(t) + qpos, LN1(t)),
    t = t + CA(LN2(t) + qpos, mem + pos, mem), t = t + W2 relu(W1 LN3(t)),
    each layer's output through the one final LayerNorm
    (return_intermediate);
  - heads (`GenericMLP`: conv, BN, ReLU, conv, BN, ReLU, conv) on every
    layer's features, then the box processing: center = query_xyz +
    sigmoid - 0.5, size = sigmoid * max(dims extent, 0.1), angle 0 (one
    bin), objectness = 1 - softmax[-1], the 8 corners.

Departures from the published code: the cloud's min and max
(`point_cloud_dims`) are computed on the device inside the forward, where
the published dataset computes them on the host (the same values); the
radius mask compares the squared distance, rounded in a fixed order, with
the float32 square of the radius, where the published code compares
`torch.cdist` with the radius (`ops.radius_attention`); the corners skip the
rotation by the angle, which is 0 with one bin, so the rotation is the
identity and changes no bit. Parameter names are the published model's
(its state_dict loads as it is), with these renamings: the SA layers'
`SharedMLP` keys are the port's (`mlp_module.layer{i}.conv.weight`,
`.bn.bn.*`, as pointnet2's pytorch_utils), each `nn.Conv1d` / `nn.Linear` is
the port's channel-last `Conv` (the same keys and shapes), and the
published `nn.MultiheadAttention` of the encoder is `RadiusSelfAttention`
and of the decoder `MultiHeadAttention` (the same `in_proj_weight`,
`in_proj_bias` and `out_proj.*`). Dropout modules stay in the heads'
Sequential so that the published layer indices hold.

Outputs: the pre-encoder's and the interim layer's FPS indices
(`pre_enc_inds`, `interim_inds`), the interim ball query's indices
(`interim_ball_inds`), the encoder's points, indices and features
(`enc_xyz`, `enc_inds`, `enc_features`), `query_inds`, `query_xyz`, the
cloud's `point_cloud_dims_min` / `_max`, and per decoder layer the published
box prediction keys under the PQ-Transformer's layer prefixes
(`decoder_prefixes`: '0head_' ... and 'last_' for the last layer).
While a profiler runs, the forward records the `utils.trace` spans
`model.pre_encoder`; `model.encoder`, and in it each layer's
`encoder.radius_attention` (LN1, the q/k/v projections, the kernel, the
output projection, the residual) and `encoder.ffn`, and the interim layer's
`encoder.downsample`; `model.queries` (the cloud's dims, the projection of
the encoder's features, the query FPS, both Fourier embeddings, the query
projection); `model.decoder`, and in it each layer's
`decoder.self_attention`, `decoder.cross_attention` and `decoder.ffn`;
`model.heads`.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from .. import ops
from ..config import ThreeDETRConfig
from ..utils.trace import span
from .pointnet2 import BatchNorm, Conv, SAModuleVotes, linear
from .pq_transformer import decoder_prefixes
from .transformer import LayerNorm, MultiHeadAttention

HEADS = ("sem_cls_head", "center_head", "size_head", "angle_cls_head",
         "angle_residual_head")


class SAModule(SAModuleVotes):
    """`SAModuleVotes` that also returns the ball query's indices (the
    benchmark holds them to the reference's)."""

    def forward(self, xyz, features=None):
        """xyz (B,N,3), features (B,N,C) or None -> new_xyz, new_features,
        FPS inds (B,npoint), ball-query idx (B,npoint,nsample)."""
        new_xyz, inds, idx, grouped = self.group(xyz, features)
        return new_xyz, self.pool(grouped), inds, idx


class RadiusSelfAttention(MultiHeadAttention):
    """Self-attention of point tokens masked to the pairs closer than a
    radius (`ops.radius_attention`), with nn.MultiheadAttention's packed
    parameters; q is scaled by 1/sqrt(head size) before the product."""

    def forward(self, x, xyz, radius):
        """x (B,N,D), xyz (B,N,3) -> (B,N,D)."""
        B, N, D = x.shape
        H = self.nhead
        hd = D // H
        qkv = linear(x, self.in_proj_weight, self.in_proj_bias,
                     self.compute_dtype).view(B, N, 3, H, hd)
        q = (qkv[:, :, 0] * hd ** -0.5).transpose(1, 2).contiguous()
        k = qkv[:, :, 1].transpose(1, 2).contiguous()
        v = qkv[:, :, 2].transpose(1, 2).contiguous()
        out = ops.radius_attention(q, k, v, xyz, radius)
        return self.out_proj(out.reshape(B, N, D))


class EncoderLayer(nn.Module):
    """The published TransformerEncoderLayer, normalize_before=True."""

    def __init__(self, d: int, nhead: int, ffn: int):
        super().__init__()
        self.nhead = nhead
        self.self_attn = RadiusSelfAttention(d, nhead)
        self.linear1 = Conv(d, ffn, kernel_dims=0)
        self.linear2 = Conv(ffn, d, kernel_dims=0)
        self.norm1 = LayerNorm(d, eps=1e-5)
        self.norm2 = LayerNorm(d, eps=1e-5)

    def forward(self, x, xyz, radius):
        with span("encoder.radius_attention"):
            x = x + self.self_attn(self.norm1(x), xyz, radius)
        with span("encoder.ffn"):
            return x + self.linear2(torch.relu(self.linear1(self.norm2(x))))


class MaskedEncoder(nn.Module):
    """The published MaskedTransformerEncoder with its interim SA layer."""

    def __init__(self, cfg: ThreeDETRConfig):
        super().__init__()
        self.masking_radius = tuple(cfg.masking_radius)
        if len(self.masking_radius) != cfg.enc_nlayers:
            raise ValueError(f"ThreeDETR: {len(self.masking_radius)} masking "
                             f"radii for {cfg.enc_nlayers} encoder layers")
        self.layers = nn.ModuleList(
            EncoderLayer(cfg.enc_dim, cfg.enc_nhead, cfg.enc_ffn_dim)
            for _ in range(cfg.enc_nlayers))
        self.interim_downsampling = SAModule(
            cfg.preenc_npoints // 2, cfg.interim_radius, cfg.interim_nsample,
            cfg.enc_dim, [*cfg.interim_mlp, cfg.enc_dim], normalize_xyz=True,
            fused=cfg.fused_sa)

    def forward(self, x, xyz):
        """x (B,N,D) at xyz (B,N,3) -> (xyz, features, interim FPS inds,
        interim ball-query idx) after the last layer."""
        inds = idx = None
        for i, layer in enumerate(self.layers):
            x = layer(x, xyz, self.masking_radius[i])
            if i == 0:
                with span("encoder.downsample"):
                    xyz, x, inds, idx = self.interim_downsampling(xyz, x)
        return xyz, x, inds, idx


class GenericMLP(nn.Module):
    """The published GenericMLP as the model builds it: conv (no bias),
    then BN and ReLU where `norm`, ReLU alone where not, and Dropout where
    `dropout`, for each hidden width; then the output conv (bias where
    `output_bias`), then BN and / or ReLU where asked. `layers` keeps the
    published Sequential's indices."""

    def __init__(self, cin, hidden, cout, norm=True, dropout=False,
                 hidden_bias=False, output_bias=True, output_norm=False,
                 output_relu=False):
        super().__init__()
        layers = []
        for width in hidden:
            layers.append(Conv(cin, width, bias=hidden_bias))
            if norm:
                layers.append(BatchNorm(width))
            layers.append(nn.ReLU())
            if dropout:
                layers.append(nn.Dropout())
            cin = width
        layers.append(Conv(cin, cout, bias=output_bias))
        if output_norm:
            layers.append(BatchNorm(cout))
        if output_relu:
            layers.append(nn.ReLU())
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x)


class FourierEmbedding(nn.Module):
    """The published PositionEmbeddingCoordsSine(pos_type="fourier",
    normalize=True): xyz shifted and scaled to [0, 1] by the cloud's
    min and max, times 2 pi, through the Gaussian matrix `gauss_B`
    (d_in, d_pos / 2), as [sin, cos]."""

    def __init__(self, d_pos: int, gauss_scale: float, d_in: int = 3):
        super().__init__()
        self.gauss_scale = gauss_scale
        self.register_buffer("gauss_B", torch.empty(d_in, d_pos // 2))

    @torch.no_grad()
    def reset(self, generator: torch.Generator) -> None:
        """Draw `gauss_B` as the published model does: N(0, 1) times
        `gauss_scale`."""
        self.gauss_B.normal_(generator=generator).mul_(self.gauss_scale)

    def forward(self, xyz, dims_min, dims_max):
        x = (xyz - dims_min[:, None]) / (dims_max - dims_min)[:, None]
        proj = torch.matmul(x * (2 * math.pi), self.gauss_B)
        return torch.cat([proj.sin(), proj.cos()], dim=-1)


class PreNormDecoderLayer(nn.Module):
    """The published TransformerDecoderLayer, normalize_before=True."""

    def __init__(self, d: int, nhead: int, ffn: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(d, nhead)
        self.multihead_attn = MultiHeadAttention(d, nhead)
        self.norm1 = LayerNorm(d, eps=1e-5)
        self.norm2 = LayerNorm(d, eps=1e-5)
        self.norm3 = LayerNorm(d, eps=1e-5)
        self.linear1 = Conv(d, ffn, kernel_dims=0)
        self.linear2 = Conv(ffn, d, kernel_dims=0)

    def forward(self, t, memory, query_pos, pos):
        with span("decoder.self_attention"):
            h = self.norm1(t)
            qk = h + query_pos
            t = t + self.self_attn(qk, qk, h)
        with span("decoder.cross_attention"):
            t = t + self.multihead_attn(self.norm2(t) + query_pos,
                                        memory + pos, memory)
        with span("decoder.ffn"):
            return t + self.linear2(torch.relu(self.linear1(self.norm3(t))))


class Decoder(nn.Module):
    def __init__(self, cfg: ThreeDETRConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            PreNormDecoderLayer(cfg.enc_dim, cfg.dec_nhead, cfg.dec_ffn_dim)
            for _ in range(cfg.dec_nlayers))
        self.norm = LayerNorm(cfg.enc_dim, eps=1e-5)

    def forward(self, memory, query_pos, pos):
        """-> (layers, B, queries, D): every layer's output, normed."""
        t = torch.zeros_like(query_pos)
        out = []
        for layer in self.layers:
            t = layer(t, memory, query_pos, pos)
            out.append(self.norm(t))
        return torch.stack(out)


def box_corners(center, size):
    """The published box_parametrization_to_corners at angle 0: the centre
    in camera axes (x, z, -y) plus (+-l, +-h, +-w) / 2 in its order."""
    c = torch.stack([center[..., 0], center[..., 2], -center[..., 1]], -1)
    half = size / 2
    l, w, h = half[..., 0:1], half[..., 1:2], half[..., 2:3]
    x = torch.cat([l, l, -l, -l, l, l, -l, -l], -1)
    y = torch.cat([h, h, h, h, -h, -h, -h, -h], -1)
    z = torch.cat([w, -w, -w, w, w, -w, -w, w], -1)
    return torch.stack([x, y, z], -1) + c[..., None, :]


class ThreeDETR(nn.Module):
    NUM_ANGLE_BIN = 1  # the published ScanNet setting; angle 0, no rotation

    def __init__(self, cfg: ThreeDETRConfig = ThreeDETRConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.enc_dim
        self.pre_encoder = SAModule(
            cfg.preenc_npoints, cfg.preenc_radius, cfg.preenc_nsample,
            cfg.input_feature_dim, [*cfg.preenc_mlp, cfg.enc_dim],
            normalize_xyz=True, fused=cfg.fused_sa)
        self.encoder = MaskedEncoder(cfg)
        self.encoder_to_decoder_projection = GenericMLP(
            cfg.enc_dim, [cfg.enc_dim], d, output_bias=False,
            output_norm=True, output_relu=True)
        self.pos_embedding = FourierEmbedding(d, cfg.gauss_scale)
        self.query_projection = GenericMLP(
            d, [d], d, norm=False, hidden_bias=True, output_relu=True)
        self.decoder = Decoder(cfg)
        bins = self.NUM_ANGLE_BIN
        outs = (cfg.num_class + 1, 3, 3, bins, bins)
        self.mlp_heads = nn.ModuleDict(
            (name, GenericMLP(d, [d, d], n, dropout=True))
            for name, n in zip(HEADS, outs))

    def forward(self, point_clouds: torch.Tensor) -> Dict[str, torch.Tensor]:
        """point_clouds (B, N, 3+C) float32 -> end points (module
        docstring)."""
        cfg = self.cfg
        xyz = point_clouds[..., 0:3].contiguous()
        feats = point_clouds[..., 3:] if point_clouds.shape[-1] > 3 else None
        ep = {}
        with span("model.pre_encoder"):
            pre_xyz, pre_feats, pre_inds, _ = self.pre_encoder(xyz, feats)
        ep["pre_enc_inds"] = pre_inds
        with span("model.encoder"):
            enc_xyz, enc_feats, inds, idx = self.encoder(pre_feats, pre_xyz)
        ep.update(interim_inds=inds, interim_ball_inds=idx, enc_xyz=enc_xyz,
                  enc_features=enc_feats,
                  enc_inds=torch.gather(pre_inds, 1, inds.long()))
        with span("model.queries"):
            dims_min, dims_max = xyz.amin(dim=1), xyz.amax(dim=1)
            ep["point_cloud_dims_min"] = dims_min
            ep["point_cloud_dims_max"] = dims_max
            memory = self.encoder_to_decoder_projection(enc_feats)
            query_inds = ops.fps(enc_xyz, cfg.num_queries)
            query_xyz = ops.gather_points(enc_xyz, query_inds)
            ep["query_inds"], ep["query_xyz"] = query_inds, query_xyz
            query_pos = self.query_projection(
                self.pos_embedding(query_xyz, dims_min, dims_max))
            pos = self.pos_embedding(enc_xyz, dims_min, dims_max)
        with span("model.decoder"):
            features = self.decoder(memory, query_pos, pos)
        with span("model.heads"):
            ep.update(self.boxes(features, query_xyz, dims_min, dims_max))
        return ep

    def boxes(self, features, query_xyz, dims_min, dims_max):
        """Every layer's heads on its (B, Q, D) features, and the box
        processing (the published get_box_predictions)."""
        L, B, Q, D = features.shape
        flat = features.reshape(L * B, Q, D)
        out = {name: self.mlp_heads[name](flat).reshape(L, B, Q, -1)
               for name in HEADS}
        logits = out["sem_cls_head"]
        center = query_xyz + (torch.sigmoid(out["center_head"]) - 0.5)
        extent = dims_max - dims_min
        center_norm = (center - dims_min[:, None]) / extent[:, None]
        size_norm = torch.sigmoid(out["size_head"])
        size = size_norm * torch.clamp(extent, min=0.1)[:, None]
        angle_res_norm = out["angle_residual_head"]
        angle_res = angle_res_norm * (math.pi / angle_res_norm.shape[-1])
        # one bin: the published angle_logits * 0 + angle_residual * 0,
        # clamped at 0
        angle = (out["angle_cls_head"] * 0 + angle_res * 0).squeeze(-1)
        angle = angle.clamp(min=0)
        prob = torch.softmax(logits, dim=-1)
        corners = box_corners(center, size)
        ep = {}
        for i, prefix in enumerate(decoder_prefixes(L)[1:]):
            ep.update({
                f"{prefix}sem_cls_logits": logits[i],
                f"{prefix}center_normalized": center_norm[i],
                f"{prefix}center_unnormalized": center[i],
                f"{prefix}size_normalized": size_norm[i],
                f"{prefix}size_unnormalized": size[i],
                f"{prefix}angle_logits": out["angle_cls_head"][i],
                f"{prefix}angle_residual": angle_res[i],
                f"{prefix}angle_residual_normalized": angle_res_norm[i],
                f"{prefix}angle_continuous": angle[i],
                f"{prefix}objectness_prob": 1 - prob[i, ..., -1],
                f"{prefix}sem_cls_prob": prob[i, ..., :-1],
                f"{prefix}box_corners": corners[i]})
        return ep
