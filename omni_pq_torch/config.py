"""Model / dataset configuration of the PyTorch port.

The port's own copy of `omni_pq_tpu/config.py`: the ScanNet dataset
statistics (18 classes, 1 heading bin, 18 size clusters, mean box sizes) and
the PQ-Transformer architecture. Field names and defaults are the JAX
package's, so a config converts field by field. `compute_dtype` is the JAX
package's mixed-precision switch: "bfloat16" runs the Dense chains, the
attention projections and the fused SA-MLP kernel in bfloat16 while the
parameters, BatchNorm statistics, softmax, LayerNorms and losses stay
float32 (the library default stays "float32"; the CLIs default to
bfloat16 as the JAX CLIs do). The JAX package's `remat_sa` knob is left
out.
"""
from __future__ import annotations

import dataclasses

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

# the 18 detection classes' nyu40 ids (scannet/model_util_scannet.py:22)
SCANNET_NYU40_IDS = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28,
                              33, 34, 36, 39])


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """ScanNet detection config (scannet/model_util_scannet.py:14-71)."""
    num_class: int = 18
    num_heading_bin: int = 1
    num_size_cluster: int = 18

    def class2angle_batch(self, pred_cls, residual) -> np.ndarray:
        """Heading angles of (...) predictions: ScanNet boxes are
        axis-aligned, so always 0."""
        return np.zeros(np.shape(pred_cls), dtype=np.float64)

    def class2size_batch(self, pred_cls, residual) -> np.ndarray:
        """Box sizes: class mean size + residual, (...) int, (..., 3) ->
        (..., 3)."""
        return SCANNET_MEAN_SIZES[np.asarray(pred_cls)] + residual


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
    # mixed precision: "float32" or "bfloat16" compute for the Dense path
    # (parameters stay float32; BatchNorm statistics, softmax, LayerNorm and
    # the losses stay float32). Same meaning and default as the JAX
    # package's field.
    compute_dtype: str = "float32"
    # per-vector normal normalisation in QuadPredictHead; the reference
    # divides by the global tensor norm (pq_transformer.py:112-113). Same
    # default and meaning as the JAX package's flag.
    quad_normal_per_vector_norm: bool = True
    # route each SA layer's Dense -> BN -> ReLU chain + nsample max-pool
    # through the fused kernel (ops/fused_mlp.py) wherever its widths pass
    # `ops.fused_mlp.supports`; the other layers keep the unfused chain.
    # Same meaning and default as the JAX package's flag.
    fused_sa: bool = False


# the CLIs' --smoke model (the JAX package's cli/train.py make_model_config)
SMOKE_MODEL = dict(num_proposal=16, num_quad_proposal=16, num_decoder_layers=2,
                   hidden_dim=32, nhead=4, dim_feedforward=64,
                   backbone_width=1, backbone_npoints=(128, 64, 32, 16),
                   backbone_nsamples=(8, 8, 8, 8), vote_aggregation_nsample=8)
