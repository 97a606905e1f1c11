"""Carry the JAX package's PQTransformer weights into the port.

`flax_to_state_dict` is the inverse of the JAX package's
`interop/import_weights.py::torch_state_dict_to_flax`: it takes the flax
`{"params", "batch_stats"}` tree (as numpy arrays) and returns the port's
state_dict, which is laid out like the reference PQ_Transformer's:

  Dense kernel (in, out)      -> weight (out, in), (out, in, 1) for a Conv1d,
                                 (out, in, 1, 1) for a SharedMLP Conv2d
  q/k/v Dense kernels + biases -> packed in_proj_weight (3D, D), in_proj_bias
  BatchNorm {scale, bias} + {mean, var} -> weight, bias, running_mean,
                                 running_var, num_batches_tracked (0)
  LayerNorm {scale, bias}     -> weight, bias

The decoder's position embeddings appear twice, under `decoder.{i}.*` and
under the reference's `decoder_{self,cross}_posembeds.{i}` aliases.

The modules off the PQTransformer's path have writers of their own, from the
flax tree of one module to the port module's state_dict:
`sa_module_msg_state_dict` (flax `mlp{i}` -> `mlps.{i}`),
`group_all_state_dict` (`mlp` -> `mlp_module`), `lfp_module_msg_state_dict`
(`mlp{i}` -> `mlps.{i}`, `post_mlp`), `points_obj_cls_state_dict`
(`conv1-3`, `bn1-2`) and `mha_state_dict` (a MultiHeadAttention).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _join(dst: str, name: str) -> str:
    return f"{dst}.{name}" if dst else name


class _Writer:
    def __init__(self, variables: Dict):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.sd: Dict[str, torch.Tensor] = {}

    @staticmethod
    def _node(tree, path):
        for p in filter(None, path.split("/")):
            tree = tree[p]
        return tree

    def _put(self, key, value):
        """float64 arrays (a float64 tree) stay float64, every other type
        becomes float32."""
        value = np.asarray(value)
        dtype = np.float64 if value.dtype == np.float64 else np.float32
        self.sd[key] = torch.from_numpy(np.array(value, dtype=dtype))

    def dense(self, src, dst, kernel_dims):
        node = self._node(self.params, src)
        k = np.asarray(node["kernel"])  # (in, out)
        self._put(_join(dst, "weight"),
                  k.T.reshape(k.shape[::-1] + (1,) * kernel_dims))
        if "bias" in node:
            self._put(_join(dst, "bias"), node["bias"])

    def bn(self, src, dst):
        p, s = self._node(self.params, src), self._node(self.stats, src)
        self._put(f"{dst}.weight", p["scale"])
        self._put(f"{dst}.bias", p["bias"])
        self._put(f"{dst}.running_mean", s["mean"])
        self._put(f"{dst}.running_var", s["var"])
        self.sd[f"{dst}.num_batches_tracked"] = torch.tensor(0)

    def ln(self, src, dst):
        p = self._node(self.params, src)
        self._put(f"{dst}.weight", p["scale"])
        self._put(f"{dst}.bias", p["bias"])

    def mha(self, src, dst):
        node = self._node(self.params, src)
        names = ("q_proj", "k_proj", "v_proj")
        self._put(_join(dst, "in_proj_weight"), np.concatenate(
            [np.asarray(node[n]["kernel"]).T for n in names]))
        self._put(_join(dst, "in_proj_bias"), np.concatenate(
            [np.asarray(node[n]["bias"]) for n in names]))
        self.dense(f"{src}/out_proj", _join(dst, "out_proj"), 0)

    def shared_mlp(self, src, dst):
        node = self._node(self.params, src)
        i = 0
        while f"layer{i}" in node:
            self.dense(f"{src}/layer{i}", f"{dst}.layer{i}.conv", 2)
            self.bn(f"{src}/bn{i}", f"{dst}.layer{i}.bn.bn")
            i += 1

    def posembed(self, src, dst):
        self.dense(f"{src}/conv1", f"{dst}.position_embedding_head.0", 1)
        self.bn(f"{src}/bn", f"{dst}.position_embedding_head.1")
        self.dense(f"{src}/conv2", f"{dst}.position_embedding_head.3", 1)

    def predict_head(self, src, dst, quad: bool):
        for c in ("conv1", "conv2"):
            self.dense(f"{src}/{c}", f"{dst}.{c}", 1)
        for b in ("bn1", "bn2"):
            self.bn(f"{src}/{b}", f"{dst}.{b}")
        heads = (("quad_scores_head", "center_head", "normal_vector_head",
                  "size_head") if quad else
                 ("objectness_scores_head", "center_head",
                  "heading_class_head", "heading_residual_head",
                  "size_class_head", "size_residual_head",
                  "sem_cls_scores_head"))
        for h in heads:
            self.dense(f"{src}/{h}", f"{dst}.{h}", 1)


def flax_to_state_dict(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax {"params", "batch_stats"} of the JAX PQTransformer -> the port's
    (and the reference's) state_dict."""
    w = _Writer(variables)
    for sa in ("sa1", "sa2", "sa3", "sa4"):
        w.shared_mlp(f"backbone/{sa}/mlp", f"backbone.{sa}.mlp_module")
    for fp in ("fp1", "fp2"):
        w.shared_mlp(f"backbone/{fp}/mlp", f"backbone.{fp}.mlp")
    for c in ("conv1", "conv2", "conv3"):
        w.dense(f"vote/{c}", f"vote.{c}", 1)
    for b in ("bn1", "bn2"):
        w.bn(f"vote/{b}", f"vote.{b}")
    w.shared_mlp("vote_aggregation/mlp", "vote_aggregation.mlp_module")
    w.predict_head("proposal_head", "proposal", quad=False)
    w.predict_head("quad_proposal_head", "quad_proposal", quad=True)
    for proj in ("decoder_query_proj", "quad_decoder_query_proj",
                 "decoder_key_proj"):
        w.dense(proj, proj, 1)
    i = 0
    while f"decoder_layer{i}" in w.params:
        src, dst = f"decoder_layer{i}", f"decoder.{i}"
        w.posembed(f"{src}/self_posembed", f"{dst}.self_posembed")
        w.posembed(f"{src}/cross_posembed", f"{dst}.cross_posembed")
        w.mha(f"{src}/self_attn", f"{dst}.self_attn")
        w.mha(f"{src}/multihead_attn", f"{dst}.multihead_attn")
        w.dense(f"{src}/linear1", f"{dst}.linear1", 0)
        w.dense(f"{src}/linear2", f"{dst}.linear2", 0)
        for n in ("norm1", "norm2", "norm3"):
            w.ln(f"{src}/{n}", f"{dst}.{n}")
        w.predict_head(f"prediction_head{i}", f"prediction_heads.{i}",
                       quad=False)
        w.predict_head(f"quad_prediction_head{i}",
                       f"prediction_quad_heads.{i}", quad=True)
        for kind in ("self", "cross"):
            prefix = f"{dst}.{kind}_posembed."
            for k in [k for k in w.sd if k.startswith(prefix)]:
                w.sd[f"decoder_{kind}_posembeds.{i}.{k[len(prefix):]}"] = \
                    w.sd[k]
        i += 1
    return w.sd


def sa_module_msg_state_dict(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax variables of the JAX SAModuleMSG -> the port's SAModuleMSG
    state_dict (flax `mlp{i}` -> `mlps.{i}`)."""
    w = _Writer(variables)
    i = 0
    while f"mlp{i}" in w.params:
        w.shared_mlp(f"mlp{i}", f"mlps.{i}")
        i += 1
    return w.sd


def group_all_state_dict(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax variables of the JAX GroupAllModule -> the port's
    GroupAllModule state_dict (flax `mlp` -> `mlp_module`)."""
    w = _Writer(variables)
    w.shared_mlp("mlp", "mlp_module")
    return w.sd


def lfp_module_msg_state_dict(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax variables of the JAX LFPModuleMSG -> the port's LFPModuleMSG
    state_dict (flax `mlp{i}` -> `mlps.{i}`, the shared `post_mlp`)."""
    sd = sa_module_msg_state_dict(variables)
    w = _Writer(variables)
    w.shared_mlp("post_mlp", "post_mlp")
    return {**sd, **w.sd}


def points_obj_cls_state_dict(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax variables of the JAX PointsObjClsModule -> the port's
    PointsObjClsModule state_dict (the reference's conv1-3, bn1-2)."""
    w = _Writer(variables)
    for c in ("conv1", "conv2", "conv3"):
        w.dense(c, c, 1)
    for b in ("bn1", "bn2"):
        w.bn(b, b)
    return w.sd


def mha_state_dict(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax variables of the JAX MultiHeadAttention -> the port's
    MultiHeadAttention state_dict (packed in_proj, out_proj)."""
    w = _Writer(variables)
    w.mha("", "")
    return w.sd
