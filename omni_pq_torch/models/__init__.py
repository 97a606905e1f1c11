from .pointnet2 import (SharedMLP, SAModuleVotes, SAModuleMSG,
                        GroupAllModule, LFPModuleMSG, FPModule)
from .backbone import Pointnet2Backbone
from .transformer import (VotingModule, PointsObjClsModule, general_sampling,
                          PositionEmbeddingLearned, MultiHeadAttention,
                          TransformerDecoderLayer)
from .heads import PredictHead, QuadPredictHead
from .pq_transformer import PQTransformer, decoder_prefixes
from .three_detr import ThreeDETR

__all__ = [
    "SharedMLP", "SAModuleVotes", "SAModuleMSG", "GroupAllModule",
    "LFPModuleMSG", "FPModule", "Pointnet2Backbone", "VotingModule",
    "PointsObjClsModule", "general_sampling", "PositionEmbeddingLearned",
    "MultiHeadAttention", "TransformerDecoderLayer", "PredictHead",
    "QuadPredictHead", "PQTransformer", "decoder_prefixes", "ThreeDETR",
]
