"""PQ-Transformer, the flagship model (the port of
`omni_pq_tpu/models/pq_transformer.py`), in eval and train mode.

Backbone seeds -> FPS quad queries + voted object queries -> initial proposal
heads -> decoder layers over the joint queries with per-layer object/quad
heads. The `end_points` dict has the JAX package's keys (119 at the default
config) and prefixes 'proposal_', '0head_'..'4head_', 'last_'. Submodule
names are the reference PQ_Transformer's, so its state_dict keys are too.
As in the JAX package, the per-layer predicted centres that become the next
layer's query positions carry no gradient (pq_transformer.py:263-264 of the
reference). `model.train()` switches BatchNorm to batch statistics and the
decoder's dropout on; the masks come from the generator passed to forward.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .. import ops
from ..config import ModelConfig
from .backbone import Pointnet2Backbone
from .heads import PredictHead, QuadPredictHead
from .pointnet2 import Conv, SAModuleVotes
from .transformer import (PositionEmbeddingLearned, TransformerDecoderLayer,
                          VotingModule)


def decoder_prefixes(num_layers: int):
    return (["proposal_"] + [f"{i}head_" for i in range(num_layers - 1)]
            + ["last_"])


class PQTransformer(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        hd = cfg.hidden_dim
        self.backbone = Pointnet2Backbone(
            input_feature_dim=cfg.input_feature_dim, width=cfg.backbone_width,
            depth=cfg.backbone_depth, out_dim=hd,
            npoints=cfg.backbone_npoints, nsamples=cfg.backbone_nsamples,
            radii=cfg.backbone_radii, fused=cfg.fused_sa)
        self.vote = VotingModule(hd)
        self.vote_aggregation = SAModuleVotes(
            cfg.num_proposal, 0.3, cfg.vote_aggregation_nsample, hd,
            [hd, hd, hd], normalize_xyz=True, fused=cfg.fused_sa)
        obj_head = dict(hidden_dim=hd, num_heading_bin=cfg.num_heading_bin,
                        num_size_cluster=cfg.num_size_cluster,
                        num_class=cfg.num_class)
        quad_head = dict(hidden_dim=hd,
                         per_vector_norm=cfg.quad_normal_per_vector_norm)
        self.proposal = PredictHead(**obj_head)
        self.quad_proposal = QuadPredictHead(**quad_head)
        self.decoder_query_proj = Conv(hd, hd)
        self.quad_decoder_query_proj = Conv(hd, hd)
        self.decoder_key_proj = Conv(hd, hd)
        L = cfg.num_decoder_layers
        self.decoder_self_posembeds = nn.ModuleList(
            PositionEmbeddingLearned(hd) for _ in range(L))
        self.decoder_cross_posembeds = nn.ModuleList(
            PositionEmbeddingLearned(hd) for _ in range(L))
        self.decoder = nn.ModuleList(
            TransformerDecoderLayer(hd, cfg.nhead, cfg.dim_feedforward,
                                    self.decoder_self_posembeds[i],
                                    self.decoder_cross_posembeds[i],
                                    cfg.dropout)
            for i in range(L))
        self.prediction_heads = nn.ModuleList(
            PredictHead(**obj_head) for _ in range(L))
        self.prediction_quad_heads = nn.ModuleList(
            QuadPredictHead(**quad_head) for _ in range(L))

    def forward(self, point_clouds: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """point_clouds (B, N, 3+C) -> end_points. `generator` (on the
        model's device) draws the decoder's dropout masks in train mode."""
        cfg = self.cfg
        end_points = self.backbone(point_clouds)
        seed_xyz = end_points["fp2_xyz"]
        seed_features = end_points["fp2_features"]

        # quad branch query init: plain FPS over seeds
        quad_inds = ops.fps(seed_xyz, cfg.num_quad_proposal)
        quad_xyz = ops.gather_points(seed_xyz, quad_inds)
        quad_feat = ops.gather_points(seed_features, quad_inds)
        end_points["aggregated_sample_xyz"] = quad_xyz

        # object branch query init: voting + L2-normalised features + SA
        vote_xyz, vote_feat = self.vote(seed_xyz, seed_features)
        vote_feat = vote_feat / (torch.linalg.vector_norm(
            vote_feat, dim=-1, keepdim=True) + 1e-8)
        end_points["vote_xyz"] = vote_xyz
        end_points["vote_features"] = vote_feat
        cluster_xyz, cluster_feat, _ = self.vote_aggregation(vote_xyz,
                                                             vote_feat)
        end_points["aggregated_vote_xyz"] = cluster_xyz
        end_points["cluster_feature"] = cluster_feat

        center, _, ep = self.proposal(cluster_feat, cluster_xyz, "proposal_")
        end_points.update(ep)
        center_q, _, ep = self.quad_proposal(quad_feat, quad_xyz, "proposal_")
        end_points.update(ep)

        # joint decoder queries: [object | quad]
        query = torch.cat([self.decoder_query_proj(cluster_feat),
                           self.quad_decoder_query_proj(quad_feat)], dim=1)
        key = self.decoder_key_proj(seed_features)
        prefixes = decoder_prefixes(cfg.num_decoder_layers)[1:]
        for i, prefix in enumerate(prefixes):
            query_pos = torch.cat([center, center_q], dim=1).detach()
            query = self.decoder[i](query, key, query_pos, seed_xyz,
                                    generator)
            center, _, ep = self.prediction_heads[i](
                query[:, :cfg.num_proposal], cluster_xyz, prefix)
            end_points.update(ep)
            center_q, _, ep = self.prediction_quad_heads[i](
                query[:, cfg.num_proposal:], quad_xyz, prefix)
            end_points.update(ep)
        return end_points
