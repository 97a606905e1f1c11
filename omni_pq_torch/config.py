"""Model / dataset configuration of the PyTorch port.

The port's own copy of `omni_pq_tpu/config.py`: the ScanNet dataset
statistics (18 classes, 1 heading bin, 18 size clusters, mean box sizes) and
the PQ-Transformer architecture. Field names and defaults are the JAX
package's, so a config converts field by field. `compute_dtype` is the JAX
package's precision switch: "bfloat16" runs the Dense chains, the
attention projections and the fused SA-MLP kernel in bfloat16 while the
parameters, BatchNorm statistics, softmax, LayerNorms and losses stay
float32 (the library default stays "float32"; the CLIs default to
bfloat16 as the JAX CLIs do); "float64" is the JAX package's
numerics-validation design point: every product, BatchNorm, softmax,
residual and loss in float64 (FPS and the ball query still decide on
float32 copies of the coordinates), so a backward-parity check is not
capped at single precision. No CLI offers it, as none of the JAX CLIs does.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np

# per-class mean box sizes (l, w, h); dataset statistic from the reference's
# scannet_means.npz (scannet/model_util_scannet.py:30)
SCANNET_MEAN_SIZES = np.array([
    [0.76966726, 0.81160211, 0.92573741],
    [1.876858, 1.84255952, 1.19315654],
    [0.61327999, 0.61486087, 0.71827014],
    [1.39550063, 1.51215451, 0.83443565],
    [0.97949596, 1.06751485, 0.63296875],
    [0.53166301, 0.59555772, 1.75001483],
    [0.96247056, 0.72462326, 1.14818682],
    [0.83221924, 1.04909355, 1.68756634],
    [0.21132214, 0.4206159, 0.53728459],
    [1.44400728, 1.89708334, 0.26985747],
    [1.02942616, 1.40407966, 0.87554322],
    [1.37664116, 0.65521793, 1.68131292],
    [0.66508189, 0.71111926, 1.29885307],
    [0.41999174, 0.37906947, 1.75139715],
    [0.59359559, 0.59124924, 0.73919014],
    [0.50867595, 0.50656087, 0.30136236],
    [1.15115265, 1.0546296, 0.49706794],
    [0.47535286, 0.49249493, 0.58021168],
], dtype=np.float32)

SCANNET_TYPES = ['cabinet', 'bed', 'chair', 'sofa', 'table', 'door', 'window',
                 'bookshelf', 'picture', 'counter', 'desk', 'curtain',
                 'refrigerator', 'showercurtrain', 'toilet', 'sink', 'bathtub',
                 'garbagebin']
# the 18 detection classes' nyu40 ids (scannet/model_util_scannet.py:22)
SCANNET_NYU40_IDS = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28,
                              33, 34, 36, 39])


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """ScanNet detection config (scannet/model_util_scannet.py:14-71)."""
    num_class: int = 18
    num_heading_bin: int = 1
    num_size_cluster: int = 18
    max_num_obj: int = 64
    max_num_quad: int = 32

    @property
    def mean_size_arr(self) -> np.ndarray:
        return SCANNET_MEAN_SIZES

    def class2angle(self, pred_cls, residual):
        """Heading angle of one prediction: ScanNet boxes are
        axis-aligned, so always 0."""
        return 0.0

    def class2size(self, pred_cls: int, residual: np.ndarray) -> np.ndarray:
        """Box size of one prediction: class mean size + residual."""
        return SCANNET_MEAN_SIZES[pred_cls] + residual

    def class2angle_batch(self, pred_cls, residual) -> np.ndarray:
        """Heading angles of (...) predictions: ScanNet boxes are
        axis-aligned, so always 0."""
        return np.zeros(np.shape(pred_cls), dtype=np.float64)

    def class2size_batch(self, pred_cls, residual) -> np.ndarray:
        """Box sizes: class mean size + residual, (...) int, (..., 3) ->
        (..., 3)."""
        return SCANNET_MEAN_SIZES[np.asarray(pred_cls)] + residual

    def param2obb(self, center, heading_class, heading_residual, size_class,
                  size_residual):
        """(cx, cy, cz, l, w, h, -heading) of one prediction."""
        obb = np.zeros((7,))
        obb[0:3] = center
        obb[3:6] = self.class2size(int(size_class), size_residual)
        obb[6] = -1 * self.class2angle(heading_class, heading_residual)
        return obb


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """PQ-Transformer architecture (models/pq_transformer.py:123-194)."""
    input_feature_dim: int = 0
    num_class: int = 18
    num_heading_bin: int = 1
    num_size_cluster: int = 18
    num_proposal: int = 256        # object queries
    num_quad_proposal: int = 256   # layout-quad queries
    num_decoder_layers: int = 6
    hidden_dim: int = 288
    nhead: int = 8
    dim_feedforward: int = 2048
    dropout: float = 0.1           # decoder dropout, train mode only
    backbone_width: int = 2
    backbone_depth: int = 2
    backbone_npoints: tuple = (2048, 1024, 512, 256)
    backbone_nsamples: tuple = (64, 32, 16, 16)
    backbone_radii: tuple = (0.2, 0.4, 0.8, 1.2)
    vote_aggregation_nsample: int = 16
    num_points: int = 40000
    # "float32", "bfloat16" (mixed precision: the Dense path in bfloat16;
    # parameters, BatchNorm statistics, softmax, LayerNorm and the losses
    # stay float32) or "float64" (numerics validation: everything in
    # float64, `models.pointnet2.acc_dtype`). Same meaning and default as
    # the JAX package's field.
    compute_dtype: str = "float32"
    # recompute each SA layer's unfused SharedMLP + max-pool in the backward
    # instead of keeping its (B, npoint, nsample, C) activations, the step's
    # largest (torch.utils.checkpoint); the same values and gradients. No
    # effect on the fused route, whose kernel keeps none. Same meaning and
    # default as the JAX package's field.
    remat_sa: bool = False
    # per-vector normal normalisation in QuadPredictHead; the reference
    # divides by the global tensor norm (pq_transformer.py:112-113). Same
    # default and meaning as the JAX package's flag.
    quad_normal_per_vector_norm: bool = True
    # route each SA layer's Dense -> BN -> ReLU chain + nsample max-pool
    # through the fused kernel (ops/fused_mlp.py) wherever its widths pass
    # `ops.fused_mlp.supports`; the other layers keep the unfused chain.
    # Same meaning and default as the JAX package's flag.
    fused_sa: bool = False


@dataclasses.dataclass(frozen=True)
class ThreeDETRConfig:
    """3DETR-m, the masked-encoder 3DETR of Misra, Girdhar and Joulin, "An
    End-to-End Transformer Model for 3D Object Detection" (ICCV 2021), at
    the published ScanNet defaults (github.com/facebookresearch/3detr:
    main.py's arguments, scripts/scannet_masked_ep1080.sh, build_preencoder
    and build_encoder of models/model_3detr.py): no colour channels, 18
    classes. Eval only (`models.three_detr.ThreeDETR`); the published
    dropouts (0.1 encoder and decoder, 0.3 heads) do nothing in eval and
    are not held. What the port holds at one value is not a field: one
    angle bin (`ThreeDETR.NUM_ANGLE_BIN`), the decoder at the encoder's
    width (`enc_dim`), and float32 (`compute_dtype`, which the
    radius-attention kernel asks for)."""
    compute_dtype: ClassVar[str] = "float32"
    num_class: int = 18            # semantic classes; the head adds background
    input_feature_dim: int = 0     # no colour
    num_points: int = 40000
    # pre-encoder: PointnetSAModuleVotes, MLP 3 -> 64 -> 128 -> enc_dim
    preenc_npoints: int = 2048
    preenc_radius: float = 0.2
    preenc_nsample: int = 64
    preenc_mlp: tuple = (64, 128)
    # masked encoder: pre-norm layers, ReLU FFN, no position embedding
    enc_dim: int = 256
    enc_nhead: int = 4
    enc_ffn_dim: int = 128
    enc_nlayers: int = 3
    # a pair of tokens attends where its distance is below its layer's
    # radius: the published [0.4**2, 0.8**2, 1.2**2], compared with
    # torch.cdist's (unsquared) distance, so 0.16, 0.64 and 1.44 m
    masking_radius: tuple = (0.16, 0.64, 1.44)
    # the SA layer after encoder layer 0: preenc_npoints // 2 centres,
    # MLP enc_dim + 3 -> 256 -> 256 -> enc_dim
    interim_radius: float = 0.4
    interim_nsample: int = 32
    interim_mlp: tuple = (256, 256)
    # decoder: pre-norm layers over FPS queries with Fourier embeddings, at
    # enc_dim
    dec_nhead: int = 4
    dec_ffn_dim: int = 256
    dec_nlayers: int = 8
    num_queries: int = 256
    gauss_scale: float = 1.0
    # route the SA layers whose widths pass `ops.fused_mlp.supports` (the
    # interim layer; the pre-encoder's 64 does not) through the fused kernel
    fused_sa: bool = False


# the CLIs' --smoke model (the JAX package's cli/train.py make_model_config)
SMOKE_MODEL = dict(num_proposal=16, num_quad_proposal=16, num_decoder_layers=2,
                   hidden_dim=32, nhead=4, dim_feedforward=64,
                   backbone_width=1, backbone_npoints=(128, 64, 32, 16),
                   backbone_nsamples=(8, 8, 8, 8), vote_aggregation_nsample=8)


DEFAULT_MODEL = ModelConfig()
DEFAULT_DATASET = DatasetConfig()
