"""Voting module, points objectness module, general sampling, learned
position embedding, multi-head attention and the DETR-style decoder layer
(the port of `omni_pq_tpu/models/transformer.py`).

Channel-last throughout. Attention is written out as matmul -> softmax ->
matmul with separate q/k/v projections, logits divided by sqrt(head dim)
after the product and softmax in float32, as the JAX package does; the
parameters keep torch MultiheadAttention's names (`in_proj_weight`,
`in_proj_bias`, `out_proj.*`). In train mode the decoder applies dropout
where the JAX package does (attention weights, the two attention outputs,
the FFN hidden layer and output), with masks drawn from the
`torch.Generator` the caller passes in, never from the global RNG.

Under a bfloat16 compute dtype the modules follow the JAX package: the
voting and head convolutions in bfloat16 with float32 BatchNorm; the q/k/v
projections in bfloat16, the logits accumulated and the softmax taken in
float32, the weights cast to bfloat16 for the product with v, the result
back in float32 and `out_proj` in float32; the FFN in bfloat16, its output
back in float32; LayerNorms and position embeddings in float32. Each
"float32" there is `acc_dtype` of the compute dtype (the JAX package's
`acc_dtype`): under float64 every one of them is float64, and the
position embeddings and LayerNorms compute in the promoted type of their
input and parameters (float64 on float64 inputs, float32 parameters cast up
exactly, as flax's modules with no dtype do).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops, parallel
from ..ops import matmul as mm
from ..utils.trace import span
from .pointnet2 import BatchNorm, Conv, acc_dtype, linear


def dropout(x: torch.Tensor, p: float, training: bool,
            generator) -> torch.Tensor:
    """flax's nn.Dropout: keep each element with probability 1 - p and scale
    the kept ones by 1 / (1 - p). The mask comes from `generator` (on x's
    device); train mode with p > 0 and no generator raises. Inside
    `parallel.data_parallel` the mask is drawn for the global batch's shape
    and this rank's rows are kept (`DataParallel.row_ranges`, under the
    step's `batch_segments`): every rank's generator stays in step, and the
    masks are a single process's on the global batch."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator: the "
                         "masks never come from the global RNG")
    keep = 1.0 - p
    dp = parallel.current()
    if dp is None:
        mask = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        full = torch.rand((dp.world * x.shape[0],) + tuple(x.shape[1:]),
                          generator=generator, device=x.device)
        mask = torch.cat([full[g:g + rows] for g, _, rows in
                          dp.row_ranges(x.shape[0])])
    mask = mask < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class VotingModule(nn.Module):
    """VoteNet vote generation (voting_module.py), vote_factor=1, residual
    feature offsets."""

    def __init__(self, seed_feature_dim: int = 288,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = seed_feature_dim
        self.conv1 = Conv(d, d, dtype=dtype)
        self.bn1 = BatchNorm(d)
        self.conv2 = Conv(d, d, dtype=dtype)
        self.bn2 = BatchNorm(d)
        self.conv3 = Conv(d, 3 + d, dtype=dtype)

    def forward(self, seed_xyz, seed_features):
        """seed_xyz (B,S,3), seed_features (B,S,C) -> vote_xyz, vote_features
        (the offsets are taken to the accumulation dtype before they are
        added: float32, float64 under float64)."""
        net = torch.relu(self.bn1(self.conv1(seed_features)))
        net = torch.relu(self.bn2(self.conv2(net)))
        net = self.conv3(net).to(acc_dtype(self.conv3.compute_dtype))
        return seed_xyz + net[..., 0:3], seed_features + net[..., 3:]


class PointsObjClsModule(nn.Module):
    """Per-seed objectness logits (pointnet_util.py:330-356, the reference's
    kps sampling variant): conv1 -> BN -> ReLU -> conv2 -> BN -> ReLU ->
    conv3, the first two at the compute dtype with float32 BatchNorm,
    conv3 in float32, as the JAX module."""

    def __init__(self, seed_feature_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = seed_feature_dim
        self.conv1 = Conv(d, d, dtype=dtype)
        self.bn1 = BatchNorm(d)
        self.conv2 = Conv(d, d, dtype=dtype)
        self.bn2 = BatchNorm(d)
        self.conv3 = Conv(d, 1)

    def forward(self, seed_features: torch.Tensor) -> torch.Tensor:
        """(B, S, C) -> (B, S, 1) float32 logits."""
        net = torch.relu(self.bn1(self.conv1(seed_features)))
        net = torch.relu(self.bn2(self.conv2(net)))
        return self.conv3(net)


def general_sampling(xyz: torch.Tensor, features: torch.Tensor,
                     sample_inds: torch.Tensor):
    """GeneralSamplingModule (pointnet_util.py:361-375): xyz (B,N,3) and
    features (B,N,C) at sample_inds (B,S) -> (xyz (B,S,3), features
    (B,S,C), sample_inds)."""
    return (ops.gather_points(xyz, sample_inds),
            ops.gather_points(features, sample_inds), sample_inds)


class PositionEmbeddingLearned(nn.Module):
    """Learned absolute position embedding over xyz (pq_transformer.py:17-33):
    Conv1d -> BN -> ReLU -> Conv1d, as `position_embedding_head.{0,1,3}`."""

    def __init__(self, num_pos_feats: int = 288):
        super().__init__()
        self.position_embedding_head = nn.Sequential(
            Conv(3, num_pos_feats), BatchNorm(num_pos_feats), nn.ReLU(),
            Conv(num_pos_feats, num_pos_feats))

    def forward(self, xyz):
        return self.position_embedding_head(xyz)


class MultiHeadAttention(nn.Module):
    """Standard multi-head attention with packed q/k/v parameters.

    attention_type="self" is the reference fork's one deviation
    (multi_head_attention.py:393-396), as the JAX module has it: the output
    projection takes query - attention output (in the accumulation dtype)
    instead of the
    attention output. No reference script reaches it."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 attention_type: str = ""):
        super().__init__()
        self.nhead = nhead
        self.dropout = dropout
        self.attention_type = attention_type
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = Conv(d_model, d_model, kernel_dims=0)
        self.compute_dtype = dtype

    def forward(self, q, k, v, generator=None):
        """q (B,Lq,D), k/v (B,Lk,D) -> (B,Lq,D) in the accumulation dtype
        (float32, float64 under float64)."""
        B, Lq, D = q.shape
        H = self.nhead
        hd = D // H
        dt = self.compute_dtype
        acc = acc_dtype(dt)
        w, b = self.in_proj_weight, self.in_proj_bias
        qp = linear(q, w[:D], b[:D], dt).reshape(B, Lq, H, hd)
        kp = linear(k, w[D:2 * D], b[D:2 * D], dt)
        vp = linear(v, w[2 * D:], b[2 * D:], dt)
        kp = kp.reshape(B, -1, H, hd)
        vp = vp.reshape(B, -1, H, hd)
        # logits accumulated in acc (a product of two bfloat16 values is
        # exact in float32), softmax in acc
        logits = torch.einsum("bqhd,bkhd->bhqk", qp.to(acc),
                              kp.to(acc)) / math.sqrt(hd)
        weights = dropout(torch.softmax(logits, dim=-1), self.dropout,
                          self.training, generator)
        out = mm.matmul(weights.to(dt), vp.transpose(1, 2)).transpose(1, 2)
        out = out.to(acc).reshape(B, Lq, D)
        if self.attention_type == "self":
            out = q.to(acc) - out
        return self.out_proj(out)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm in the promoted type of its input and its parameters
    (flax's LayerNorm with no dtype): float32 parameters meet a float64
    input cast up exactly; in float32 it is nn.LayerNorm unchanged."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return F.layer_norm(x.to(dt), self.normalized_shape,
                            self.weight.to(dt), self.bias.to(dt), self.eps)


class TransformerDecoderLayer(nn.Module):
    """Self-attn + cross-attn + FFN with learned xyz position embeddings added
    to q/k/v every layer (transformer.py:162-228). Post-norm residuals,
    LayerNorm eps 1e-5. The position embeddings are passed in because the
    reference registers the same modules a second time in
    `decoder_{self,cross}_posembeds` (their state_dict keys alias). While
    a profiler runs, the three blocks record the `utils.trace` spans
    `decoder.self_attention` (with both position embeddings, which the
    layer computes first), `decoder.cross_attention` and `decoder.ffn`."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 self_posembed: PositionEmbeddingLearned,
                 cross_posembed: PositionEmbeddingLearned,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout, dtype)
        self.multihead_attn = MultiHeadAttention(d_model, nhead, dropout,
                                                 dtype)
        self.linear1 = Conv(d_model, dim_feedforward, kernel_dims=0,
                            dtype=dtype)
        self.linear2 = Conv(dim_feedforward, d_model, kernel_dims=0,
                            dtype=dtype)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.norm3 = LayerNorm(d_model, eps=1e-5)
        self.self_posembed = self_posembed
        self.cross_posembed = cross_posembed

    def forward(self, query, key, query_pos, key_pos, generator=None):
        """query (B,Pq,D), key (B,Pk,D), query_pos (B,Pq,3), key_pos (B,Pk,3);
        `generator` draws the dropout masks in train mode."""
        def drop(x):
            return dropout(x, self.dropout, self.training, generator)

        with span("decoder.self_attention"):
            q_embed = self.self_posembed(query_pos)
            k_embed = self.cross_posembed(key_pos)
            qkv = query + q_embed
            attn = self.self_attn(qkv, qkv, qkv, generator)
            query = self.norm1(query + drop(attn))
        with span("decoder.cross_attention"):
            kv = key + k_embed
            attn = self.multihead_attn(query + q_embed, kv, kv, generator)
            query = self.norm2(query + drop(attn))
        with span("decoder.ffn"):
            ff = self.linear2(drop(torch.relu(self.linear1(query)))).to(
                acc_dtype(self.linear2.compute_dtype))
            return self.norm3(query + drop(ff))
