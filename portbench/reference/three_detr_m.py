"""Plain PyTorch reference of the 3DETR-m eval forward, for the benchmark's
comparison.

The masked-encoder 3DETR of Misra, Girdhar and Joulin, "An End-to-End
Transformer Model for 3D Object Detection" (ICCV 2021), as the published
code builds it for ScanNet (github.com/facebookresearch/3detr:
models/model_3detr.py, transformer.py, helpers.py, position_embedding.py,
scripts/scannet_masked_ep1080.sh), written from its equations in float32
with ordinary tensor ops: no kernel, no cache, nothing of the program.
Every point op comes from `reference/ops.py`. Module and parameter names
are the published model's (the SA layers' `mlp_module.layer{i}.conv` and
`.bn.bn` as pointnet2's pytorch_utils name them), so one state_dict loads
into the program and into this file.

The forward, channel-last (the published code is channel-first; the
numbers do not depend on it):
  - pre-encoder: FPS to 2048 of the 40 000 points, the ball query (r 0.2,
    64 samples), the relative xyz over the radius, 1x1 convolutions 3 -> 64
    -> 128 -> 256 with eval-mode BatchNorm and ReLU, the max over the
    samples;
  - encoder: 3 pre-norm layers at d 256, 4 heads, FFN 128,
    x = x + MHA(LN1(x)) under the layer's radius mask, then
    x = x + W2 relu(W1 LN2(x)), no position embedding and no final norm;
    after layer 0 the interim SA layer (FPS to 1024, r 0.4, 32 samples,
    259 -> 256 -> 256 -> 256);
  - the encoder-to-decoder projection (conv, BN, ReLU, twice, no biases);
  - 256 FPS queries; the Fourier embedding (xyz shifted and scaled to
    [0, 1] by the cloud's min and max, times 2 pi, through gauss_B, as
    [sin, cos]); the query embedding relu(conv(relu(conv(.))));
  - decoder: 8 pre-norm layers at d 256, 4 heads, FFN 256, from t = 0,
    each layer's output through the final LayerNorm;
  - five heads (conv, BN, ReLU, conv, BN, ReLU, conv) on all 8 layers,
    then the box processing.
Attention is nn.MultiheadAttention's: q, k and v projected, q scaled by
1/sqrt(64) before the product, the softmax over the keys, the product with
v, the output projection. Each forward sets
`torch.backends.cuda.matmul.allow_tf32` and `torch.backends.cudnn.allow_tf32`
to False for its length (restored after), so every float32 product is a
float32 product; `ThreeDETR(cfg, tf32=True)` sets them to True instead:
the control, the reference one precision down.

Departures from the published code:
  - the radius mask keeps a pair where ((dx*dx + dy*dy) + dz*dz) < r2,
    each operation rounded once in float32 and r2 the float32 square of
    the layer's radius; the published code masks where `torch.cdist(p=2)`
    is >= the radius (`masking_radius = [0.4**2, 0.8**2, 1.2**2]`, so the
    radii are 0.16, 0.64 and 1.44 m, kept as the code has them). cdist
    takes a matrix-product route at these sizes, whose roundings would move
    pairs at the boundary; the program keeps pairs with this arithmetic;
  - `point_cloud_dims` (the cloud's per-axis min and max) are computed from
    the cloud given, where the published dataset computes them on the host:
    the same values;
  - the box corners skip the rotation by the angle, which is 0 with one
    angle bin (the identity: no bit changes);
  - attention over the 2048 and 1024 tokens runs one batch row at a time
    (the same arithmetic, a fraction of the memory).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import ops

HEADS = ("sem_cls_head", "center_head", "size_head", "angle_cls_head",
         "angle_residual_head")


def conv(x, layer):
    """A 1x1 convolution (or a Linear) on the last axis."""
    return F.linear(x, layer.weight.flatten(1), layer.bias)


def batch_norm(x, bn):
    """nn.BatchNorm1d in eval mode, on the last axis."""
    return ((x - bn.running_mean) / torch.sqrt(bn.running_var + bn.eps)
            * bn.weight + bn.bias)


def layer_norm(x, ln):
    return F.layer_norm(x, ln.normalized_shape, ln.weight, ln.bias, ln.eps)


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 products on or off (cuBLAS and cuDNN) for the block."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = m.allow_tf32, c.allow_tf32
    m.allow_tf32 = c.allow_tf32 = on
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = saved


def radius_sq(radius: float) -> float:
    return float(np.float32(radius * radius))


class _MLPLayer(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn = nn.Module()
        self.bn.bn = nn.BatchNorm1d(cout)


class SAModule(nn.Module):
    """PointnetSAModuleVotes (use_xyz, normalize_xyz, max pooling)."""

    def __init__(self, npoint, radius, nsample, mlp: Sequence[int]):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.mlp_module = nn.Module()
        for i, (cin, cout) in enumerate(zip(mlp[:-1], mlp[1:])):
            self.mlp_module.add_module(f"layer{i}", _MLPLayer(cin, cout))

    def forward(self, xyz, features=None):
        inds = ops.fps(xyz, self.npoint)
        new_xyz = ops.gather_points(xyz, inds)
        idx = ops.ball_query(self.radius, self.nsample, xyz, new_xyz)
        x = (ops.group_points(xyz, idx) - new_xyz[:, :, None, :]) / self.radius
        if features is not None:
            x = torch.cat([x, ops.group_points(features, idx)], dim=-1)
        for layer in self.mlp_module.children():
            x = torch.relu(batch_norm(conv(x, layer.conv), layer.bn.bn))
        return new_xyz, x.amax(dim=2), inds, idx


def project(attn: nn.MultiheadAttention, q, k, v):
    """The in-projections of nn.MultiheadAttention, q scaled."""
    D = q.shape[-1]
    w, b = attn.in_proj_weight, attn.in_proj_bias
    hd = D // attn.num_heads
    return (F.linear(q, w[:D], b[:D]) * hd ** -0.5,
            F.linear(k, w[D:2 * D], b[D:2 * D]), F.linear(v, w[2 * D:],
                                                            b[2 * D:]))


def heads_of(x, H):
    """(B, L, D) -> (B, H, L, D / H)."""
    B, L, D = x.shape
    return x.reshape(B, L, H, D // H).transpose(1, 2)


def merge(x):
    """(B, H, L, hd) -> (B, L, H * hd)."""
    B, H, L, hd = x.shape
    return x.transpose(1, 2).reshape(B, L, H * hd)


def attention(attn: nn.MultiheadAttention, q, k, v, keep=None):
    """nn.MultiheadAttention's forward on (B, L, D) inputs; `keep` (B, Lq,
    Lk): the pairs that attend."""
    H = attn.num_heads
    q, k, v = (heads_of(t, H) for t in project(attn, q, k, v))
    logits = torch.matmul(q, k.transpose(-1, -2))
    if keep is not None:
        logits = logits.masked_fill(~keep[:, None], float("-inf"))
    out = torch.matmul(torch.softmax(logits, dim=-1), v)
    return F.linear(merge(out), attn.out_proj.weight, attn.out_proj.bias)


class EncoderLayer(nn.Module):
    def __init__(self, d, nhead, ffn):
        super().__init__()
        self.self_attn = nn.MultiheadAttention(d, nhead)
        self.linear1 = nn.Linear(d, ffn)
        self.linear2 = nn.Linear(ffn, d)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)

    def forward(self, x, xyz, radius):
        h = layer_norm(x, self.norm1)
        r2 = radius_sq(radius)
        rows = []
        for b in range(x.shape[0]):  # one batch row at a time
            keep = ops.sq_dist(xyz[b][:, None], xyz[b][None]) < r2
            rows.append(attention(self.self_attn, h[b:b + 1], h[b:b + 1],
                                  h[b:b + 1], keep[None]))
        x = x + torch.cat(rows)
        h = layer_norm(x, self.norm2)
        return x + conv(torch.relu(conv(h, self.linear1)), self.linear2)


class Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg["enc_dim"]
        self.radii = list(cfg["masking_radius"])
        self.layers = nn.ModuleList(
            EncoderLayer(d, cfg["enc_nhead"], cfg["enc_ffn_dim"])
            for _ in range(cfg["enc_nlayers"]))
        self.interim_downsampling = SAModule(
            cfg["preenc_npoints"] // 2, cfg["interim_radius"],
            cfg["interim_nsample"], [d + 3, *cfg["interim_mlp"], d])

    def forward(self, x, xyz):
        out = {}
        for i, layer in enumerate(self.layers):
            x = layer(x, xyz, self.radii[i])
            if i == 0:
                xyz, x, inds, idx = self.interim_downsampling(xyz, x)
                out["interim_inds"], out["interim_ball_inds"] = inds, idx
        out["enc_xyz"], out["enc_features"] = xyz, x
        return out


def generic_mlp(cin, hidden, cout, norm=True, dropout=False,
                hidden_bias=False, output_bias=True, output_norm=False,
                output_relu=False) -> nn.Module:
    """The published GenericMLP (use_conv): its `layers` Sequential."""
    layers = []
    for width in hidden:
        layers.append(nn.Conv1d(cin, width, 1, bias=hidden_bias))
        if norm:
            layers.append(nn.BatchNorm1d(width))
        layers.append(nn.ReLU())
        if dropout:
            layers.append(nn.Dropout())
        cin = width
    layers.append(nn.Conv1d(cin, cout, 1, bias=output_bias))
    if output_norm:
        layers.append(nn.BatchNorm1d(cout))
    if output_relu:
        layers.append(nn.ReLU())
    mlp = nn.Module()
    mlp.layers = nn.Sequential(*layers)
    return mlp


def run_mlp(mlp, x):
    """A GenericMLP on (..., C) in eval mode (dropout does nothing)."""
    for layer in mlp.layers:
        if isinstance(layer, nn.Conv1d):
            x = conv(x, layer)
        elif isinstance(layer, nn.BatchNorm1d):
            x = batch_norm(x, layer)
        elif isinstance(layer, nn.ReLU):
            x = torch.relu(x)
    return x


class DecoderLayer(nn.Module):
    def __init__(self, d, nhead, ffn):
        super().__init__()
        self.self_attn = nn.MultiheadAttention(d, nhead)
        self.multihead_attn = nn.MultiheadAttention(d, nhead)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)
        self.norm3 = nn.LayerNorm(d)
        self.linear1 = nn.Linear(d, ffn)
        self.linear2 = nn.Linear(ffn, d)

    def forward(self, t, memory, query_pos, pos):
        h = layer_norm(t, self.norm1)
        t = t + attention(self.self_attn, h + query_pos, h + query_pos, h)
        h = layer_norm(t, self.norm2)
        t = t + attention(self.multihead_attn, h + query_pos, memory + pos,
                          memory)
        h = layer_norm(t, self.norm3)
        return t + conv(torch.relu(conv(h, self.linear1)), self.linear2)


class FourierEmbedding(nn.Module):
    def __init__(self, d_pos, d_in=3):
        super().__init__()
        self.register_buffer("gauss_B", torch.empty(d_in, d_pos // 2))

    def forward(self, xyz, dims_min, dims_max):
        B, N, _ = xyz.shape
        x = (xyz - dims_min[:, None]) / (dims_max - dims_min)[:, None]
        x = x * (2 * np.pi)
        proj = torch.mm(x.reshape(-1, 3), self.gauss_B).reshape(B, N, -1)
        return torch.cat([proj.sin(), proj.cos()], dim=-1)


def prefixes(num_layers: int):
    """The program's per-layer prefixes: '0head_' ... and 'last_'."""
    return [f"{i}head_" for i in range(num_layers - 1)] + ["last_"]


class ThreeDETR(nn.Module):
    def __init__(self, cfg: Dict, tf32: bool = False):
        super().__init__()
        self.cfg, self.tf32 = cfg, tf32
        d = cfg["dec_dim"]
        self.pre_encoder = SAModule(
            cfg["preenc_npoints"], cfg["preenc_radius"],
            cfg["preenc_nsample"],
            [3 + cfg["input_feature_dim"], *cfg["preenc_mlp"],
             cfg["enc_dim"]])
        self.encoder = Encoder(cfg)
        self.encoder_to_decoder_projection = generic_mlp(
            cfg["enc_dim"], [cfg["enc_dim"]], d, output_bias=False,
            output_norm=True, output_relu=True)
        self.pos_embedding = FourierEmbedding(d)
        self.query_projection = generic_mlp(d, [d], d, norm=False,
                                            hidden_bias=True,
                                            output_relu=True)
        self.decoder = nn.Module()
        self.decoder.layers = nn.ModuleList(
            DecoderLayer(d, cfg["dec_nhead"], cfg["dec_ffn_dim"])
            for _ in range(cfg["dec_nlayers"]))
        self.decoder.norm = nn.LayerNorm(d)
        outs = (cfg["num_class"] + 1, 3, 3, cfg["num_angle_bin"],
                cfg["num_angle_bin"])
        self.mlp_heads = nn.ModuleDict(
            (name, generic_mlp(d, [d, d], n, dropout=True))
            for name, n in zip(HEADS, outs))

    @torch.no_grad()
    def forward_encoder(self, clouds) -> Dict[str, torch.Tensor]:
        """The pre-encoder and the encoder, from the rooms."""
        xyz = clouds[..., 0:3].contiguous()
        with tf32(self.tf32):
            pre_xyz, feats, pre_inds, _ = self.pre_encoder(xyz)
            out = self.encoder(feats, pre_xyz)
        out["pre_enc_inds"] = pre_inds
        return out

    @torch.no_grad()
    def forward_decoder(self, clouds, enc_xyz, enc_features
                        ) -> Dict[str, torch.Tensor]:
        """The projection, the queries, the decoder and the heads, from an
        encoder's points and features."""
        with tf32(self.tf32):
            return self._decoder(clouds, enc_xyz, enc_features)

    def _decoder(self, clouds, enc_xyz, enc_features):
        cfg = self.cfg
        xyz = clouds[..., 0:3]
        dims_min, dims_max = xyz.amin(dim=1), xyz.amax(dim=1)
        memory = run_mlp(self.encoder_to_decoder_projection, enc_features)
        query_inds = ops.fps(enc_xyz, cfg["num_queries"])
        query_xyz = ops.gather_points(enc_xyz, query_inds)
        query_pos = run_mlp(self.query_projection,
                            self.pos_embedding(query_xyz, dims_min, dims_max))
        pos = self.pos_embedding(enc_xyz, dims_min, dims_max)
        t = torch.zeros_like(query_pos)
        out = {"query_inds": query_inds, "query_xyz": query_xyz}
        extent = dims_max - dims_min
        for layer, prefix in zip(self.decoder.layers,
                                 prefixes(cfg["dec_nlayers"])):
            t = layer(t, memory, query_pos, pos)
            f = layer_norm(t, self.decoder.norm)
            h = {name: run_mlp(self.mlp_heads[name], f) for name in HEADS}
            logits = h["sem_cls_head"]
            center = query_xyz + (torch.sigmoid(h["center_head"]) - 0.5)
            size_norm = torch.sigmoid(h["size_head"])
            size = size_norm * torch.clamp(extent, min=0.1)[:, None]
            res_norm = h["angle_residual_head"]
            res = res_norm * (np.pi / res_norm.shape[-1])
            angle = (h["angle_cls_head"] * 0 + res * 0).squeeze(-1)
            prob = torch.softmax(logits, dim=-1)
            out.update({
                f"{prefix}sem_cls_logits": logits,
                f"{prefix}center_normalized":
                    (center - dims_min[:, None]) / extent[:, None],
                f"{prefix}center_unnormalized": center,
                f"{prefix}size_normalized": size_norm,
                f"{prefix}size_unnormalized": size,
                f"{prefix}angle_logits": h["angle_cls_head"],
                f"{prefix}angle_residual": res,
                f"{prefix}angle_residual_normalized": res_norm,
                f"{prefix}angle_continuous": angle.clamp(min=0),
                f"{prefix}objectness_prob": 1 - prob[..., -1],
                f"{prefix}sem_cls_prob": prob[..., :-1],
                f"{prefix}box_corners": corners(center, size)})
        return out

    def forward(self, clouds) -> Dict[str, torch.Tensor]:
        out = self.forward_encoder(clouds)
        out.update(self.forward_decoder(clouds, out["enc_xyz"],
                                        out["enc_features"]))
        return out


def corners(center, size):
    """get_3d_box_batch_tensor at angle 0 on the centre in camera axes
    (flip_axis_to_camera_tensor: x, z, -y): l along x, h along y, w along
    z, in the published corner order."""
    c = torch.stack([center[..., 0], center[..., 2], -center[..., 1]], -1)
    l, w, h = (size[..., i:i + 1] / 2 for i in range(3))
    x = torch.cat([l, l, -l, -l, l, l, -l, -l], -1)
    y = torch.cat([h, h, h, h, -h, -h, -h, -h], -1)
    z = torch.cat([w, -w, -w, w, w, -w, -w, w], -1)
    return torch.stack([x, y, z], -1) + c[..., None, :]

