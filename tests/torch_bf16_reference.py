"""The JAX package's bfloat16 references for tests/test_torch_port_bf16.py.

Run from the repo root as `JAX_PLATFORMS=cpu python -m
tests.torch_bf16_reference OUT.npz`, in its own process, with XLA_FLAGS
holding `--xla_allow_excess_precision=false`: by
default XLA:CPU may skip a bfloat16 rounding the program asks for (it drops
a convert-to-bfloat16 / convert-to-float32 pair, e.g. between a Dense with a
bias and a float32 BatchNorm), which is a liberty of the compiler, not the
bfloat16 route as the JAX package writes it; the flag must be set before
JAX starts, hence the process of its own. Writes every array the tests
compare with, each under a flat key, and each float32 counterpart that
measures the bfloat16 noise floor (the float32 route on the same inputs).

The vote-aggregation FPS reads vote_xyz, whose bits depend on the compute
dtype: each forward and step here first computes the bfloat16 route's picks
and then replays them into the runs it is compared with (the float32 floor
runs here, the port in the tests), so that both sides aggregate the same
votes; the picks are written too.
"""
from __future__ import annotations

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np

from omni_pq_tpu import losses
from omni_pq_tpu.config import SCANNET_MEAN_SIZES, ModelConfig
from omni_pq_tpu.data.synthetic import make_batch
from omni_pq_tpu.models import PQTransformer
from omni_pq_tpu.models import pointnet2 as jp2
from omni_pq_tpu.models.heads import PredictHead, QuadPredictHead
from omni_pq_tpu.models.transformer import (MultiHeadAttention,
                                            TransformerDecoderLayer,
                                            VotingModule)
from omni_pq_tpu.ops import fps, fused_mlp
from omni_pq_tpu.train import (OptimizerConfig, TrainFlags,
                               create_train_state, make_train_step)

# a TINY model whose SA layers pass the bfloat16 gate (widths 128..512,
# every nsample a multiple of 16); vote aggregation (hidden 32) stays
# unfused, as the 288-wide one does at full width
CFG = ModelConfig(
    num_proposal=16, num_quad_proposal=16, num_decoder_layers=2,
    hidden_dim=32, nhead=4, dim_feedforward=64, backbone_width=2,
    backbone_depth=2, backbone_npoints=(128, 64, 32, 16),
    backbone_nsamples=(16, 16, 16, 16), backbone_radii=(0.2, 0.4, 0.8, 1.2),
    vote_aggregation_nsample=16, num_points=512, dropout=0.0)
BF16 = "bfloat16"
EPS = 1e-5
# (B, S, K, C0, widths) of the fused chain cases: even tiles, rows the
# Pallas kernel pads, three layers
CHAIN_SHAPES = {"even": (2, 24, 16, 4, (128, 256)),
                "padded": (1, 9, 16, 3, (128, 256)),
                "three_layers": (2, 8, 32, 19, (128, 128, 256))}


def cloud(seed, batch=2, n=512):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(batch, n, 3)).astype(np.float32)
            * np.array([4.0, 4.0, 2.5], np.float32) + 0.5)


def chain_inputs(name, seed=0):
    """The fused chain's inputs: numpy, BN scales of both signs."""
    B, S, K, C0, widths = CHAIN_SHAPES[name]
    r = np.random.default_rng(seed)
    f = lambda *s: r.normal(size=s).astype(np.float32)  # noqa: E731
    grouped = f(B, S, K, C0)
    ks, ss, bs, rm, rv = [], [], [], [], []
    cin = C0
    for c in widths:
        ks.append(f(cin, c) / np.float32(np.sqrt(cin)))
        scale = r.uniform(0.5, 1.5, c).astype(np.float32)
        scale[1::3] *= -1
        ss.append(scale)
        bs.append((0.1 * f(c)).astype(np.float32))
        rm.append((0.2 * f(c)).astype(np.float32))
        rv.append(r.uniform(0.5, 1.5, c).astype(np.float32))
        cin = c
    return grouped, ks, ss, bs, rm, rv, f(B, S, widths[-1])


def randomised(model, pc, seed):
    """Variables with BN statistics and affine parameters from noise."""
    rng = np.random.default_rng(seed)
    v = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(seed), jnp.asarray(pc)))

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


class Picks:
    """Replays fixed vote-aggregation picks: the n-th call of the models'
    SA-layer fps (pointnet2.fps; n counted over one trace) returns picks[n]
    where given."""

    def __init__(self, picks):
        self.picks, self.n, self.real = picks, 0, jp2.fps

    def __enter__(self):
        def fake(xyz, npoint):
            self.n += 1
            got = self.picks.get(self.n)
            return jnp.asarray(got) if got is not None else self.real(
                xyz, npoint)
        jp2.fps = fake
        return self

    def __exit__(self, *exc):
        jp2.fps = self.real


def put(out, prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        a = np.asarray(leaf)
        if a.dtype == jnp.bfloat16:
            out[f"{prefix}/{key}@bf16"] = a.astype(np.float32)
        else:
            out[f"{prefix}/{key}"] = a


def chains(out):
    for name in CHAIN_SHAPES:
        g, ks, ss, bs, rm, rv, cot = chain_inputs(name)
        for train in (False, True):
            for tag, fn in (
                    ("plain", lambda dt, tr: lambda g, k, s, b:
                     fused_mlp.plain_mlp_pool(g, k, s, b, rm, rv, tr, EPS,
                                              dt)),
                    ("pallas", lambda dt, tr: lambda g, k, s, b:
                     fused_mlp.fused_mlp_pool(g, k, s, b, rm, rv, train=tr,
                                              eps=EPS, dtype=dt))):
                for dt in ((jnp.bfloat16, jnp.float32) if tag == "plain"
                           else (jnp.bfloat16,)):
                    f = fn(dt, train)

                    def loss(g, k, s, b, f=f):
                        pooled, means, variances = f(g, k, s, b)
                        return (jnp.sum(pooled.astype(jnp.float32) * cot),
                                (pooled, means, variances))
                    mode = "train" if train else "eval"
                    key = f"chain/{name}/{mode}/{tag}/{jnp.dtype(dt).name}"
                    if tag == "pallas":  # its VJP is the plain chain's
                        put(out, key, {"out": jax.jit(f)(g, ks, ss, bs)})
                        continue
                    (_, res), grads = jax.jit(jax.value_and_grad(
                        loss, argnums=(0, 1, 2, 3), has_aux=True))(
                            g, ks, ss, bs)
                    put(out, key, {"out": res, "grads": grads})


def forwards(out, variables, pc):
    """The eval forward: bfloat16 unfused and fused with their own picks,
    the float32 floor of each with the bfloat16 picks replayed."""
    for fused in (False, True):
        cfg = dataclasses.replace(CFG, fused_sa=fused)
        key = f"forward/{'fused' if fused else 'unfused'}"
        m16 = PQTransformer(dataclasses.replace(cfg, compute_dtype=BF16))
        ep16 = jax.jit(lambda v, x: m16.apply(v, x, train=False))(
            variables, jnp.asarray(pc))
        picks = np.asarray(fps(ep16["vote_xyz"], CFG.num_proposal))
        m32 = PQTransformer(cfg)
        with Picks({5: picks}):
            ep32 = jax.jit(lambda v, x: m32.apply(v, x, train=False))(
                variables, jnp.asarray(pc))
        own = np.asarray(fps(ep32["vote_xyz"], CFG.num_proposal))
        out[f"{key}/picks"] = picks
        out[f"{key}/float32_own_picks_moved"] = np.int64((own != picks).sum())
        put(out, f"{key}/bf16", ep16)
        put(out, f"{key}/f32", ep32)
        out[f"{key}/dtypes"] = np.array(
            [f"{k}={jnp.dtype(v.dtype).name}" for k, v in ep16.items()])


def modules(out, variables, pc):
    """Single modules of the model on their own parameters and float32
    inputs from numpy: voting, a head of each kind, attention and a decoder
    layer, each in bfloat16 and float32."""
    p, s = variables["params"], variables["batch_stats"]
    r = np.random.default_rng(21)
    hd = CFG.hidden_dim
    f = lambda *shape: r.normal(size=shape).astype(np.float32)  # noqa: E731
    seed_xyz, seed_feat = f(2, 64, 3), np.maximum(f(2, 64, hd), 0)
    q, kv = f(2, 32, hd), f(2, 64, hd)
    qpos, kpos = f(2, 32, 3), f(2, 64, 3)
    head_in, base = f(2, 16, hd), f(2, 16, 3)
    inputs = dict(seed_xyz=seed_xyz, seed_feat=seed_feat, q=q, kv=kv,
                  qpos=qpos, kpos=kpos, head_in=head_in, base=base)
    for k, a in inputs.items():
        out[f"module/in/{k}"] = a
    for dt in (BF16, "float32"):
        vote = VotingModule(hd, dtype=dt)
        res = {"vote": jax.jit(lambda: vote.apply(
            {"params": p["vote"], "batch_stats": s["vote"]}, seed_xyz,
            seed_feat.astype(jnp.bfloat16) if dt == BF16 else seed_feat))()}
        mha = MultiHeadAttention(hd, CFG.nhead, 0.0, dtype=dt)
        res["mha"] = {"out": jax.jit(lambda: mha.apply(
            {"params": p["decoder_layer0"]["multihead_attn"]}, q, kv, kv))()}
        layer = TransformerDecoderLayer(hd, CFG.nhead, CFG.dim_feedforward,
                                        0.0, dtype=dt)
        res["decoder_layer"] = {"out": jax.jit(lambda: layer.apply(
            {"params": p["decoder_layer0"],
             "batch_stats": s["decoder_layer0"]}, q, kv, qpos, kpos))()}
        head = PredictHead(hd, CFG.num_heading_bin, CFG.num_size_cluster,
                           CFG.num_class, SCANNET_MEAN_SIZES, dtype=dt)
        res["head"] = jax.jit(lambda: head.apply(
            {"params": p["proposal_head"], "batch_stats":
             s["proposal_head"]}, head_in, base, "p_"))()[2]
        qhead = QuadPredictHead(hd, dtype=dt)
        res["quad_head"] = jax.jit(lambda: qhead.apply(
            {"params": p["quad_proposal_head"], "batch_stats":
             s["quad_proposal_head"]}, head_in, base, "p_"))()[2]
        put(out, f"module/{'bf16' if dt == BF16 else 'f32'}", res)


def train_forward(model, variables, pc, picks=None):
    """A train-mode forward (batch statistics): its end points, its
    vote-aggregation picks and the running statistics it writes, the given
    picks replayed."""
    with Picks({5: picks} if picks is not None else {}):
        ep, mut = jax.jit(lambda v, x: model.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables,
                                                       jnp.asarray(pc))
    return ep, np.asarray(fps(ep["vote_xyz"], CFG.num_proposal)), mut


def steps(out, variables):
    """One supervised step with a bfloat16 student and its float32 floor
    (the same step at float32 compute, the bfloat16 picks replayed); the
    bfloat16 teacher of an EMA-teacher step: its forward, running stats and
    consistency loss, with the float32 teacher's as the floor (the
    teacher's picks replayed)."""
    lab = make_batch(np.random.default_rng(7), 2, CFG.num_points)
    weak = make_batch(np.random.default_rng(8), 2, CFG.num_points)
    for k in lab:
        out[f"batch/labeled/{k}"] = lab[k]
        out[f"batch/weak/{k}"] = weak[k]
    labeled = {k: jnp.asarray(v) for k, v in lab.items()}
    weak_j = {k: jnp.asarray(v) for k, v in weak.items()}
    rng = jax.random.PRNGKey(0)
    m16 = PQTransformer(dataclasses.replace(CFG, compute_dtype=BF16))
    m32 = PQTransformer(CFG)
    # supervised, bfloat16 student
    _, picks, _ = train_forward(m16, variables, lab["point_clouds"])
    out["sup/picks"] = picks
    sup = TrainFlags(ema=False, gamma_mixture=False, arkit=False)
    for tag, model in (("bf16", m16), ("f32", m32)):
        state = create_train_state(variables, OptimizerConfig(), ema=False)
        step = make_train_step(model, model.cfg, SCANNET_MEAN_SIZES, sup)
        with Picks({5: picks}):
            new, stats = step(state, labeled, labeled, rng, jnp.float32(0.0))
        put(out, f"sup/{tag}/stats", stats)
        put(out, f"sup/{tag}/batch_stats", new.batch_stats)
    # the EMA teacher in bfloat16 (float32 student): its train-mode forward
    # on the double batch's ema clouds, the running stats it writes, and
    # the consistency loss of the float32 student against it (what JAX's
    # step computes with teacher_bf16); the floor: the same with the float32
    # teacher
    both = np.concatenate([lab["point_clouds"], weak["point_clouds"]])
    both_ema = np.concatenate([lab["ema_point_clouds"],
                               weak["ema_point_clouds"]])
    student, s_picks, _ = train_forward(m32, variables, both)
    teacher16, t_picks, bn16 = train_forward(m16, variables, both_ema)
    teacher32, _, bn32 = train_forward(m32, variables, both_ema, t_picks)
    out["semi/student_picks"], out["semi/teacher_picks"] = s_picks, t_picks
    put(out, "semi/teacher_bf16_batch_stats", bn16["batch_stats"])
    put(out, "semi/teacher_f32_batch_stats", bn32["batch_stats"])
    cons_ep = dict(student)
    for key in ("flip_x_axis", "flip_y_axis", "rot_mat", "scale"):
        cons_ep[key] = jnp.concatenate([labeled[key], weak_j[key]])

    @jax.jit
    def consistency(teacher):
        teacher = jax.tree.map(lambda a: a.astype(jnp.float32)
                               if jnp.issubdtype(a.dtype, jnp.inexact)
                               else a, teacher)
        return losses.get_consistency_loss(
            cons_ep, teacher, SCANNET_MEAN_SIZES,
            num_layer=CFG.num_decoder_layers)[1]
    put(out, "semi/cons_bf16_teacher", consistency(teacher16))
    put(out, "semi/cons_f32_teacher", consistency(teacher32))


def main(path):
    out = {}
    pc = cloud(5)
    variables = randomised(PQTransformer(CFG), pc, seed=6)
    out["pc"] = pc
    put(out, "variables", variables)
    chains(out)
    forwards(out, variables, pc)
    modules(out, variables, pc)
    steps(out, variables)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
