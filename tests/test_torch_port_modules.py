"""The port's modules (omni_pq_torch.models) against the JAX package's, in
eval mode, with the JAX weights carried across by omni_pq_torch.interop.

One JAX PQTransformer at the TINY config is initialised, its BatchNorm
statistics and affine parameters replaced by numpy noise (not 0/1), and its
variables converted with `flax_to_state_dict` into the port. Each submodule
then runs on the same numpy inputs on both sides. Tolerance: 1e-5 abs + rel
for floats (XLA:CPU and ATen sum matmuls and reductions in different
orders), indices bitwise.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from omni_pq_tpu import models as jm
from omni_pq_tpu.config import SCANNET_MEAN_SIZES
from omni_pq_tpu.interop.import_weights import torch_state_dict_to_flax
from omni_pq_torch.config import ModelConfig
from omni_pq_torch.infer import build_model, load_model
from omni_pq_torch.interop import flax_to_state_dict
from tests.util import TINY, tiny_cloud

TOL = dict(rtol=1e-5, atol=1e-5)


def port_config(cfg) -> ModelConfig:
    """The port's ModelConfig with the JAX config's values."""
    return ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def randomised_variables(model, pc, seed=0):
    """JAX variables of `model` with BN stats / affine params from noise."""
    rng = np.random.default_rng(seed)
    v = jax.tree.map(np.asarray,
                     jax.jit(model.init)(jax.random.PRNGKey(seed),
                                         jnp.asarray(pc)))

    def noise(path, x):
        name, coll = path[-1].key, path[0].key
        if coll == "batch_stats":
            return (rng.normal(0, 0.2, x.shape) if name == "mean"
                    else rng.uniform(0.5, 1.5, x.shape)).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(noise, v)


def assert_close(key, got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        key, got.shape, want.shape, got.dtype, want.dtype)
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want, err_msg=key)
    else:
        np.testing.assert_allclose(got, want, err_msg=key, **tol)


@pytest.fixture(scope="module")
def tiny():
    pc = tiny_cloud(np.random.default_rng(0))
    variables = randomised_variables(jm.PQTransformer(TINY), pc)
    port = load_model(flax_to_state_dict(variables), port_config(TINY), "cpu")
    return variables, port


def _sub(variables, *path):
    out = {}
    for coll in ("params", "batch_stats"):
        node = variables[coll]
        for p in path:
            node = node.get(p, {})
        if node:
            out[coll] = node
    return out


def _x(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_weight_bridge_round_trips_bitwise(tiny):
    variables, port = tiny
    sd = flax_to_state_dict(variables)
    assert set(sd) == set(port.state_dict())
    back = torch_state_dict_to_flax(port.state_dict(),
                                    num_decoder_layers=TINY.num_decoder_layers,
                                    like=variables)
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(variables)[0]
    assert [p for p, _ in flat_back] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_back, flat_want):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_full_size_state_dict_has_the_reference_layout():
    """At the default config the port's state_dict is the reference
    PQ_Transformer's: the JAX importer maps every key (it raises on unmapped
    ones, the decoder_*_posembeds aliases included) onto exactly the JAX
    model's variable tree, leaf shapes and all."""
    from omni_pq_tpu.config import ModelConfig as JaxModelConfig
    sd = build_model(ModelConfig(), "cpu").state_dict()
    like = jax.eval_shape(jm.PQTransformer(JaxModelConfig()).init,
                          jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, 4096, 3), jnp.float32))
    torch_state_dict_to_flax(sd, like=like)
    assert sd["backbone.sa1.mlp_module.layer0.conv.weight"].shape == (
        128, 3, 1, 1)
    assert sd["decoder.0.self_attn.in_proj_weight"].shape == (864, 288)
    assert sd["prediction_quad_heads.5.size_head.weight"].shape == (2, 288, 1)
    assert sd["decoder.5.linear1.weight"].shape == (2048, 288)


def test_shared_mlp(tiny):
    variables, port = tiny
    x = _x(np.random.default_rng(1), 2, 16, 8, 3)
    want = jm.SharedMLP([64, 64, 128]).apply(
        _sub(variables, "backbone", "sa1", "mlp"), jnp.asarray(x))
    assert_close("sa1 mlp", port.backbone.sa1.mlp_module(torch.from_numpy(x)),
                 want)


@pytest.mark.parametrize("layer", ["sa1", "sa2"])
def test_sa_module_votes(tiny, layer):
    variables, port = tiny
    rng = np.random.default_rng(2)
    i = int(layer[-1]) - 1
    n = TINY.num_points if i == 0 else TINY.backbone_npoints[i - 1]
    xyz = tiny_cloud(rng, n=n)
    feats = None if i == 0 else _x(rng, 2, n, 128)
    jmod = jm.SAModuleVotes(
        npoint=TINY.backbone_npoints[i], radius=TINY.backbone_radii[i],
        nsample=TINY.backbone_nsamples[i],
        mlp_channels=[[64, 64, 128], [128, 128, 256]][i], normalize_xyz=True)
    want = jmod.apply(_sub(variables, "backbone", layer), jnp.asarray(xyz),
                      None if feats is None else jnp.asarray(feats))
    got = getattr(port.backbone, layer)(
        torch.from_numpy(xyz), None if feats is None else torch.from_numpy(feats))
    for key, g, w in zip(("new_xyz", "new_features", "inds"), got, want):
        assert_close(key, g, w)


def test_fp_module(tiny):
    variables, port = tiny
    rng = np.random.default_rng(3)
    unk, kno = tiny_cloud(rng, n=32), tiny_cloud(rng, n=16)
    f_unk, f_kno = _x(rng, 2, 32, 256), _x(rng, 2, 16, 256)
    want = jm.FPModule([256, 256]).apply(
        _sub(variables, "backbone", "fp1"),
        *map(jnp.asarray, (unk, kno, f_unk, f_kno)))
    got = port.backbone.fp1(*map(torch.from_numpy, (unk, kno, f_unk, f_kno)))
    assert_close("fp1", got, want)


def test_backbone(tiny):
    variables, port = tiny
    pc = tiny_cloud(np.random.default_rng(4))
    jmod = jm.Pointnet2Backbone(width=TINY.backbone_width,
                                depth=TINY.backbone_depth,
                                out_dim=TINY.hidden_dim,
                                npoints=TINY.backbone_npoints,
                                nsamples=TINY.backbone_nsamples,
                                radii=TINY.backbone_radii)
    want = jmod.apply(_sub(variables, "backbone"), jnp.asarray(pc))
    got = port.backbone(torch.from_numpy(pc))
    assert set(got) == set(want)
    for key in want:
        assert_close(key, got[key], want[key])


def test_voting_module(tiny):
    variables, port = tiny
    rng = np.random.default_rng(5)
    xyz, feats = tiny_cloud(rng, n=64), _x(rng, 2, 64, 32)
    want = jm.VotingModule(32).apply(_sub(variables, "vote"),
                                     jnp.asarray(xyz), jnp.asarray(feats))
    got = port.vote(torch.from_numpy(xyz), torch.from_numpy(feats))
    for key, g, w in zip(("vote_xyz", "vote_features"), got, want):
        assert_close(key, g, w)


def test_decoder_layer(tiny):
    variables, port = tiny
    rng = np.random.default_rng(6)
    args = (_x(rng, 2, 32, 32), _x(rng, 2, 64, 32), tiny_cloud(rng, n=32),
            tiny_cloud(rng, n=64))
    jmod = jm.TransformerDecoderLayer(d_model=32, nhead=4, dim_feedforward=64)
    want = jmod.apply(_sub(variables, "decoder_layer1"),
                      *map(jnp.asarray, args))
    got = port.decoder[1](*map(torch.from_numpy, args))
    assert_close("decoder_layer1", got, want)


def test_predict_head(tiny):
    variables, port = tiny
    rng = np.random.default_rng(7)
    net, base = _x(rng, 2, 16, 32), tiny_cloud(rng, n=16)
    jmod = jm.PredictHead(hidden_dim=32, num_heading_bin=1,
                          num_size_cluster=18, num_class=18,
                          mean_size_arr=SCANNET_MEAN_SIZES)
    want = jmod.apply(_sub(variables, "prediction_head0"), jnp.asarray(net),
                      jnp.asarray(base), "0head_")
    got = port.prediction_heads[0](torch.from_numpy(net),
                                   torch.from_numpy(base), "0head_")
    assert_close("center", got[0], want[0])
    assert_close("pred_size", got[1], want[1])
    assert set(got[2]) == set(want[2])
    for key in want[2]:
        assert_close(key, got[2][key], want[2][key])


@pytest.mark.parametrize("per_vector_norm", [True, False])
def test_quad_predict_head(tiny, per_vector_norm):
    variables, port = tiny
    rng = np.random.default_rng(8)
    net, base = _x(rng, 2, 16, 32), tiny_cloud(rng, n=16)
    jmod = jm.QuadPredictHead(hidden_dim=32, per_vector_norm=per_vector_norm)
    want = jmod.apply(_sub(variables, "quad_prediction_head1"),
                      jnp.asarray(net), jnp.asarray(base), "last_")
    head = port.prediction_quad_heads[1]
    head.per_vector_norm = per_vector_norm
    try:
        got = head(torch.from_numpy(net), torch.from_numpy(base), "last_")
    finally:
        head.per_vector_norm = True
    for key in want[2]:
        assert_close(key, got[2][key], want[2][key])
