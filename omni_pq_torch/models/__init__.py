from .pointnet2 import SharedMLP, SAModuleVotes, FPModule
from .backbone import Pointnet2Backbone
from .transformer import (VotingModule, PositionEmbeddingLearned,
                          MultiHeadAttention, TransformerDecoderLayer)
from .heads import PredictHead, QuadPredictHead
from .pq_transformer import PQTransformer, decoder_prefixes

__all__ = [
    "SharedMLP", "SAModuleVotes", "FPModule", "Pointnet2Backbone",
    "VotingModule", "PositionEmbeddingLearned", "MultiHeadAttention",
    "TransformerDecoderLayer", "PredictHead", "QuadPredictHead",
    "PQTransformer", "decoder_prefixes",
]
