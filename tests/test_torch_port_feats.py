"""`ops.ball_query_group_feats` of the port against the JAX package's, on the
CPU.

The same numpy inputs go through the JAX entry point (below its N*S <=
256*1024 switch its jnp composition, above it the Pallas kernel in
interpret mode, as the JAX package's own tests run it) and through the port,
whose CPU path is the plain version (`ball_query_group_feats_plain`: the
plain ball query, then the feature gather). The cases mirror
tests/test_ops.py::test_fused_group_feats_matches_composition: float32 and
bfloat16 features, channel counts 128-aligned and not, off-cloud (no-hit)
centres. Tolerances: idx and grouped features bitwise (a row copy on both
sides); grouped xyz within 1e-6 (the JAX Pallas side may differ from the
oracle's rounding by an ulp); the VJP for xyz, centres and features within
1e-5 (scatter-adds summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_pq_tpu import ops as jops
from omni_pq_torch import ops

# (N, S, K, C, feature dtype): N*S on both sides of 256*1024
CASES = {
    "oracle_side_c7_f32": (800, 64, 16, 7, "float32"),
    "pallas_side_c128_f32": (2000, 256, 16, 128, "float32"),
    "pallas_side_c130_k32_f32": (2048, 256, 32, 130, "float32"),
    "pallas_side_c64_bf16": (2000, 256, 8, 64, "bfloat16"),
    "oracle_side_c5_bf16": (600, 40, 8, 5, "bfloat16"),
}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(n, s, c, seed, batch=2, off_every=5):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(size=(batch, n, 3)).astype(np.float32) * 3
    ctr = xyz[:, ::n // s][:, :s].copy()
    ctr[:, ::off_every] += 50.0  # off-cloud centres: no hit
    feats = rng.standard_normal((batch, n, c)).astype(np.float32)
    return xyz, ctr, feats


def _bits(t):
    """A tensor's values as integers of its width (bf16 has no numpy type)."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16
            else t.view(torch.int32)).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_group_feats_matches_jax(case):
    n, s, k, c, dt = CASES[case]
    xyz, ctr, feats = _inputs(n, s, c, seed=0)
    jf = jnp.asarray(feats).astype(dt)
    idx_j, grouped_j, gf_j = jops.ball_query_group_feats(
        0.4, k, jnp.asarray(xyz), jnp.asarray(ctr), jf)
    tf = torch.from_numpy(feats).to(TORCH_DTYPES[dt])
    before = ops.ball_query_group_feats.launches
    idx, grouped, gf = ops.ball_query_group_feats(
        0.4, k, torch.from_numpy(xyz), torch.from_numpy(ctr), tf)
    assert ops.ball_query_group_feats.launches == before  # CPU: plain version
    assert idx.dtype == torch.int32 and gf.dtype == tf.dtype
    assert gf.shape == (2, s, k, c)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    assert (idx.numpy()[:, ::5] == 0).all()  # the no-hit centres read row 0
    want_bits = np.asarray(jax.lax.bitcast_convert_type(
        gf_j, jnp.int16 if dt == "bfloat16" else jnp.int32))
    np.testing.assert_array_equal(_bits(gf), want_bits)
    np.testing.assert_allclose(grouped.numpy(), np.asarray(grouped_j),
                               rtol=1e-6, atol=1e-6)
    # the plain version is the entry point's CPU path, and the composition
    for a, b in zip(ops.ball_query_group_feats_plain(
            0.4, k, torch.from_numpy(xyz), torch.from_numpy(ctr), tf),
            (idx, grouped, gf)):
        assert torch.equal(a, b)
    assert torch.equal(gf, ops.group_points(tf, idx))


@pytest.mark.parametrize("n,s", [(300, 30), (2000, 256)])
def test_group_feats_vjp_matches_jax(n, s):
    """The custom VJP for all three inputs, off-cloud rows included (their
    feature cotangent goes to features[0]), against jax.vjp of the JAX
    entry point on both sides of its switch."""
    xyz, ctr, feats = _inputs(n, s, 32, seed=1, batch=1, off_every=4)
    rng = np.random.default_rng(2)
    g = rng.normal(size=(1, s, 8, 3)).astype(np.float32)
    gf = rng.normal(size=(1, s, 8, 32)).astype(np.float32)
    (idx_j, _, _), vjp = jax.vjp(
        lambda a, b, f: jops.ball_query_group_feats(0.4, 8, a, b, f),
        jnp.asarray(xyz), jnp.asarray(ctr), jnp.asarray(feats))
    want = vjp((np.zeros(idx_j.shape, jax.dtypes.float0), g, gf))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (xyz, ctr, feats)]
    _, grouped, gfeat = ops.ball_query_group_feats(0.4, 8, *leaves)
    torch.autograd.backward([grouped, gfeat],
                            [torch.from_numpy(g), torch.from_numpy(gf)])
    for leaf, w, name in zip(leaves, want, ("xyz", "centres", "features")):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert np.abs(leaves[2].grad.numpy()[:, 0]).sum() > 0


def test_group_feats_bf16_gradient_keeps_the_feature_type():
    xyz, ctr, feats = _inputs(200, 20, 6, seed=3, batch=1)
    f = torch.from_numpy(feats).bfloat16().requires_grad_()
    _, _, gfeat = ops.ball_query_group_feats(
        0.4, 8, torch.from_numpy(xyz), torch.from_numpy(ctr), f)
    gfeat.float().sum().backward()
    assert f.grad.dtype == torch.bfloat16 and f.grad.shape == f.shape
    # each point's gradient is the number of slots that name it
    idx = ops.ball_query(0.4, 8, torch.from_numpy(xyz), torch.from_numpy(ctr))
    counts = torch.bincount(idx.reshape(-1).long(), minlength=200).float()
    torch.testing.assert_close(f.grad[0].float(),
                               counts[:, None].expand(-1, 6))


def test_group_feats_takes_the_kernel_off_the_cpu():
    """Only a CPU tensor takes the plain version; on any other device the
    wrapper goes to the kernel, whose checks raise for a non-CUDA tensor."""
    meta = torch.empty(1, 64, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.ball_query_group_feats(0.5, 4, meta, meta[:, :8],
                                   torch.empty(1, 64, 4, device="meta"))
