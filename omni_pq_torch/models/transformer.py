"""Voting module, learned position embedding, multi-head attention and the
DETR-style decoder layer (the port of `omni_pq_tpu/models/transformer.py`).

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
back in float32; LayerNorms and position embeddings in float32.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import matmul as mm
from .pointnet2 import BatchNorm, Conv, linear


def dropout(x: torch.Tensor, p: float, training: bool,
            generator) -> torch.Tensor:
    """flax's nn.Dropout: keep each element with probability 1 - p and scale
    the kept ones by 1 / (1 - p). The mask comes from `generator` (on x's
    device); train mode with p > 0 and no generator raises."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator: the "
                         "masks never come from the global RNG")
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
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
        (float32: the offsets are taken back to float32 before they are
        added)."""
        net = torch.relu(self.bn1(self.conv1(seed_features)))
        net = torch.relu(self.bn2(self.conv2(net)))
        net = self.conv3(net).float()
        return seed_xyz + net[..., 0:3], seed_features + net[..., 3:]


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
    """Standard multi-head attention with packed q/k/v parameters."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nhead = nhead
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = Conv(d_model, d_model, kernel_dims=0)
        self.compute_dtype = dtype

    def forward(self, q, k, v, generator=None):
        """q (B,Lq,D), k/v (B,Lk,D) -> (B,Lq,D) float32."""
        B, Lq, D = q.shape
        H = self.nhead
        hd = D // H
        dt = self.compute_dtype
        w, b = self.in_proj_weight, self.in_proj_bias
        qp = linear(q, w[:D], b[:D], dt).reshape(B, Lq, H, hd)
        kp = linear(k, w[D:2 * D], b[D:2 * D], dt)
        vp = linear(v, w[2 * D:], b[2 * D:], dt)
        kp = kp.reshape(B, -1, H, hd)
        vp = vp.reshape(B, -1, H, hd)
        # logits accumulated in float32 (a product of two bfloat16 values is
        # exact in float32), softmax in float32
        logits = torch.einsum("bqhd,bkhd->bhqk", qp.float(),
                              kp.float()) / math.sqrt(hd)
        weights = dropout(torch.softmax(logits, dim=-1), self.dropout,
                          self.training, generator)
        out = mm.matmul(weights.to(dt), vp.transpose(1, 2)).transpose(1, 2)
        return self.out_proj(out.float().reshape(B, Lq, D))


class TransformerDecoderLayer(nn.Module):
    """Self-attn + cross-attn + FFN with learned xyz position embeddings added
    to q/k/v every layer (transformer.py:162-228). Post-norm residuals,
    LayerNorm eps 1e-5. The position embeddings are passed in because the
    reference registers the same modules a second time in
    `decoder_{self,cross}_posembeds` (their state_dict keys alias)."""

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
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self.self_posembed = self_posembed
        self.cross_posembed = cross_posembed

    def forward(self, query, key, query_pos, key_pos, generator=None):
        """query (B,Pq,D), key (B,Pk,D), query_pos (B,Pq,3), key_pos (B,Pk,3);
        `generator` draws the dropout masks in train mode."""
        def drop(x):
            return dropout(x, self.dropout, self.training, generator)

        q_embed = self.self_posembed(query_pos)
        k_embed = self.cross_posembed(key_pos)
        qkv = query + q_embed
        attn = self.self_attn(qkv, qkv, qkv, generator)
        query = self.norm1(query + drop(attn))
        kv = key + k_embed
        attn = self.multihead_attn(query + q_embed, kv, kv, generator)
        query = self.norm2(query + drop(attn))
        ff = self.linear2(drop(torch.relu(self.linear1(query)))).float()
        return self.norm3(query + drop(ff))
