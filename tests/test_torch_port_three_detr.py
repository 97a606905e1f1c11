"""3DETR-m in the port (`models/three_detr.py`, `ops/radius_attention.py`)
against the benchmark's plain reference (`portbench/reference/
three_detr_m.py`, which imports nothing of the port), on seeded weights.

CPU (the plain versions of the kernels): the whole eval forward at the
published widths on 2 rooms of 4096 points cut to 256 -> 128 points and 32
queries, fused SA off and on; the radius mask on built points within one
float32 ulp of each published radius; the check's numbers under a perturbed
output. Card (marked `cuda`, skipped without one): the kernel against its
plain version at the benchmark cell's shapes and at a ragged length, the
wrapper's checks and counter, and the encoder on the card, which launches
the kernel once a layer and allocates no (B, H, N, N) tensor.

Tolerances, each max|port - reference| over the key's max|reference|:
  - indices: none. The FPS and ball-query picks are decided on copies of the
    rooms' coordinates with the same float32 distance arithmetic.
  - the encoder's output (`enc_features`): 2e-5. The port and the reference
    sum their float32 products in other orders (packed against split
    projections, BatchNorm as rsqrt-times-scale against a division, einsum
    against matmul), each ~1e-7 relative, through 3 residual layers and an
    SA layer.
  - the decoder's and the heads' outputs: 1e-4. The same roundings, through
    8 residual layers with 16 attention products and 5 heads.
  - the kernel against its plain version: 2e-5. The kernel sums each
    logit's 64 products one FMA at a time and takes the softmax online
    (exp of a running maximum, the row sum rescaled per key tile), the plain
    version sums in the GEMM's order and normalises once.
"""
import functools

import numpy as np
import pytest
import torch

from omni_pq_torch import infer, ops
from omni_pq_torch.config import ThreeDETRConfig
from omni_pq_torch.ops.radius_attention import keep_mask
from omni_pq_torch.ops.reference import radius_sq
from portbench import harness, rooms
from portbench.models import three_detr_m
from portbench.reference import three_detr_m_check as check3d

SMALL = dict(num_points=4096, preenc_npoints=256, num_queries=32)
SEED = 2 ** 31 + 21
INDEX_KEYS = ("pre_enc_inds", "interim_inds", "interim_ball_inds",
              "query_inds")
CELL = "eval_b16.3detr_m_f32fused"


def cell_cfg():
    return harness.find_cell(harness.load_spec(), CELL).cfg


def port_cfg(cfg):
    return ThreeDETRConfig(**three_detr_m.model_fields(cfg))


@functools.lru_cache(maxsize=None)
def clouds(B, N):
    return torch.from_numpy(rooms.make_batch(
        np.random.default_rng(5), B, N)["point_clouds"]).float()


@functools.lru_cache(maxsize=None)
def small_run(fused_sa):
    """The port's and the reference's forward on 2 small rooms."""
    cfg = {**cell_cfg(), **SMALL, "fused_sa": fused_sa}
    torch.manual_seed(0)
    ref = check3d.reference_model(cfg, SEED, "cpu")
    model = infer.load_model(ref.state_dict(), port_cfg(cfg), "cpu")
    pc = clouds(2, SMALL["num_points"])
    return cfg, ref, pc, infer.eval_forward(model, pc), ref(pc)


def rel(got, want):
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / (scale if scale else 1.0)


@pytest.mark.parametrize("fused_sa", [False, True])
def test_forward_matches_reference(fused_sa):
    cfg, _, _, out, want = small_run(fused_sa)
    assert out["enc_xyz"].shape == (2, 128, 3)
    assert out["last_box_corners"].shape == (2, 32, 8, 3)
    for k in INDEX_KEYS:
        assert torch.equal(out[k].long(), want[k].long()), k
    assert rel(out["enc_xyz"], want["enc_xyz"]) == 0
    assert rel(out["enc_features"], want["enc_features"]) < 2e-5
    decoded = [k for k in want if k not in INDEX_KEYS + (
        "enc_xyz", "enc_features", "interim_ball_inds")]
    assert len(decoded) == 1 + 12 * cfg["dec_nlayers"]
    for k in decoded:
        assert out[k].shape == want[k].shape, k
        assert rel(out[k], want[k]) < 1e-4, k
    # the box processing's own invariants
    assert (out["last_angle_continuous"] == 0).all()
    obj = out["last_objectness_prob"]
    assert ((obj >= 0) & (obj <= 1)).all()
    assert torch.equal(out["enc_inds"], torch.gather(
        out["pre_enc_inds"], 1, out["interim_inds"].long()))


@pytest.mark.parametrize("case", ["enc_features", "last_center_unnormalized",
                                  "interim_ball_inds"])
def test_a_perturbed_output_fails_the_check(case):
    cfg, ref, pc, out, _ = small_run(False)
    limits = harness.find_cell(harness.load_spec(), CELL).limits
    sound = check3d.judge_eval(ref, pc, out)
    assert all(sound[k] <= v for k, v in limits.items()), sound
    bad = dict(out)
    if case == "interim_ball_inds":
        bad[case] = out[case] + 1
        name = "index_mismatch"
    else:
        bad[case] = out[case] + 1e-3 * out[case].abs().max()
        name = "stage_a_gap" if case == "enc_features" else "stage_b_gap"
    got = check3d.judge_eval(ref, pc, bad)
    assert got[name] > limits[name], got


def boundary_points(radius):
    """Token 0 at the origin and, along x, tokens at float32 steps t around
    the float32 sqrt of r2: dx is t exactly, so the decision is
    round(t * t) < r2."""
    r2 = np.float32(radius_sq(radius))
    t0 = np.sqrt(r2, dtype=np.float32)
    ts = [t0]
    for _ in range(3):
        ts = [np.nextafter(ts[0], np.float32(0))] + ts + [
            np.nextafter(ts[-1], np.float32(9))]
    xyz = [[0.0, 0.0, 0.0]] + [[t, 0.0, 0.0] for t in ts]
    keep = [True] + [bool(np.float32(t) * np.float32(t) < r2) for t in ts]
    return np.array(xyz, np.float32), np.array(keep), r2


@pytest.mark.parametrize("radius", [0.16, 0.64, 1.44])
def test_radius_mask_within_one_ulp(radius):
    xyz, keep, r2 = boundary_points(radius)
    assert keep.any() and not keep.all()  # the steps straddle the radius
    pts = torch.from_numpy(xyz)[None]
    mask = keep_mask(pts, float(r2))
    assert torch.equal(mask[0, 0], torch.from_numpy(keep))
    # token 0 attends exactly to the kept tokens: one-hot values
    n = len(xyz)
    q = torch.zeros(1, 1, n, n)
    v = torch.eye(n)[None, None]
    out = ops.radius_attention_plain(q, q, v, pts, radius)[0, 0, 0]
    assert torch.equal(out > 0, torch.from_numpy(keep))
    assert torch.allclose(out[out > 0], torch.tensor(1.0 / keep.sum(),
                                                     dtype=out.dtype))


# --- on the card ------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def card_inputs(dev, B, N, seed=0):
    """q (scaled), k, v (B, 4, N, 64) and N FPS points of B rooms."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pc = clouds(B, 40000).to(dev)
    xyz = ops.gather_points(pc, ops.fps(pc, N)).contiguous()
    q, k, v = (torch.randn(B, 4, N, 64, generator=g, device=dev)
               for _ in range(3))
    return q * 0.125, k, v, xyz


@pytest.mark.cuda
@pytest.mark.parametrize("N,radius", [(2048, 0.16), (1024, 0.64),
                                      (1024, 1.44), (1000, 1.44)])
def test_kernel_matches_plain_at_the_cell_shapes(dev, N, radius):
    q, k, v, xyz = card_inputs(dev, 16, N)
    before = ops.radius_attention.launches
    got = ops.radius_attention(q, k, v, xyz, radius)
    torch.cuda.synchronize()
    assert ops.radius_attention.launches == before + 1
    want = ops.radius_attention_plain(q, k, v, xyz, radius)
    assert got.shape == (16, N, 4, 64)
    assert rel(got, want) < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [0.16, 0.64, 1.44])
def test_kernel_mask_within_one_ulp(dev, radius):
    xyz, keep, _ = boundary_points(radius)
    n = len(xyz)
    pts = torch.from_numpy(xyz)[None].to(dev)
    q = torch.zeros(1, 1, n, 64, device=dev)
    v = torch.zeros(1, 1, n, 64, device=dev)
    v[0, 0, :, :n] = torch.eye(n, device=dev)
    out = ops.radius_attention(q, q, v, pts, radius)[0, 0, 0, :n].cpu()
    assert torch.equal(out > 0, torch.from_numpy(keep))


@pytest.mark.cuda
def test_kernel_wrapper_checks(dev):
    q, k, v, xyz = card_inputs(dev, 1, 128)
    with pytest.raises(ValueError):
        ops.radius_attention(q[..., :32].contiguous(), k[..., :32], v, xyz,
                             0.2)
    with pytest.raises(ValueError):
        ops.radius_attention(q, k, v, xyz[:, :64].contiguous(), 0.2)
    with pytest.raises(ValueError):
        ops.radius_attention(q.double(), k, v, xyz, 0.2)


@pytest.mark.cuda
def test_encoder_on_the_card(dev):
    """The cell's encoder at B=16: one kernel launch a layer, no op output
    as large as the (B, H, N, N) logits, and the plain path's numbers."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else [out]):
                if isinstance(t, torch.Tensor):
                    Largest.numel = max(Largest.numel, t.numel())
            return out

    cfg = cell_cfg()
    ref = check3d.reference_model(cfg, SEED, dev)
    model = infer.load_model(ref.state_dict(), port_cfg(cfg), dev)
    pc = clouds(16, 40000).to(dev)
    with torch.inference_mode():
        xyz, feats, _, _ = model.pre_encoder(pc)
        before = ops.radius_attention.launches
        with Largest():
            got = model.encoder(feats, xyz)
        torch.cuda.synchronize()
        assert ops.radius_attention.launches == before + cfg["enc_nlayers"]
        assert Largest.numel < 16 * 4 * 2048 * 2048
        with ops.plain_versions():
            want = model.encoder(feats, xyz)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert rel(got[1], want[1]) < 1e-4
