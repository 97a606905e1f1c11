"""The port's data parallelism (`omni_pq_torch.parallel`) on the CPU: two
gloo ranks against one process on the global batch, as
tests/test_multihost.py holds the JAX package's mesh to a single process.

Two ranks and a one-process reference run tests/torch_parallel_worker.py
(one intra-op thread each) on the same numpy-seeded global inputs, each
rank on its half of every batch inside `parallel.data_parallel`; the JAX
package's supervised step on the global batch runs here meanwhile. Then
the train CLI with --multihost on two ranks, and a resume in one process.

Tolerances, with their reasons (two ranks sum their halves' statistics,
one process sums all rows at once: float32 roundoff only):
- train-mode BatchNorm and fused_mlp_pool(train=True) (the CPU path, its
  recomputing backward included): outputs, batch / running statistics and
  the input, weight, scale and bias gradients within 1e-6 of one process
  on the concatenated rows, relative to each tensor's largest magnitude
  (at least 1): a weight gradient sums rows in another order, ~1e-5 of an
  element near 0 but ~2e-7 of the tensor's scale;
- the whole semi-supervised step (EMA teacher, gamma mixture, pc loss,
  dropout 0.1; unfused, then fused_sa=True): total_loss rtol 1e-4 and
  grad_norm rtol 1e-3 at step 0 (tests/test_multihost.py:151-160's
  bounds), every stat rtol 1e-4 + atol 1e-6 (the gamma criterion's
  engaged share exactly), each parameter's gradient within 1e-5 of the
  global gradient norm; step 1's total_loss rtol 2e-2 (tests/
  test_multihost.py's bound: Adam's first update turns roundoff in
  near-zero gradients into lr-sized moves); after 2 steps every parameter,
  AdamW moment and BN buffer (student and teacher) bitwise equal on both
  ranks, and both ranks' generators in the reference's state;
- the supervised step at dropout 0 against JAX's make_train_step on the
  global batch: tests/test_torch_port_semi.py's whole-step bounds (stats
  1e-3 rel + 1e-4 abs, gradients within 1e-3 of the gradient norm, running
  stats 1e-3), where a gradient the port's one-process step on the same
  global batch already holds further from JAX than 1e-3 (sa1's layer-1
  weight, 1.22e-3 on this batch of 4) may be no further than that plus
  1e-5; and every gradient within 1e-5 of the norm of the one-process
  port's;
- evaluate over a sharded val set (6 scenes, local batch 2: batches of 2
  then 1): the quad F1 of one process on the global batches, exactly, and
  the eval loss means within 1e-5 (rel + abs);
- the semi step inside data_parallel on a group of one rank: bitwise the
  step without the context (stats, gradients, BN buffers).
"""
import contextlib
import dataclasses
import json
import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_pq_tpu import losses as jlosses
from omni_pq_tpu.models import PQTransformer as JaxPQTransformer
from omni_pq_tpu.train import (OptimizerConfig as JaxOptimizerConfig,
                               TrainFlags as JaxTrainFlags,
                               create_train_state as jax_create_train_state,
                               make_train_step as jax_make_train_step)
from omni_pq_torch.cli import train as train_cli
from omni_pq_torch.config import SCANNET_MEAN_SIZES, SMOKE_MODEL
from omni_pq_torch.data import make_batch
from omni_pq_torch.interop import flax_to_state_dict
from omni_pq_torch.train import batch_to_tensors
from tests.test_torch_port_modules import port_config, randomised_variables
from tests.test_torch_port_semi import augment
from tests.util import TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
WORLD = 2
SUP_CFG = dataclasses.replace(TINY, dropout=0.0)
SEMI_CFG = dict(SMOKE_MODEL, num_points=TINY.num_points, dropout=0.1)
# backbone_width 2: every SA layer passes the fused gate
SEMI_FUSED_CFG = dict(SEMI_CFG, backbone_width=2,
                      backbone_nsamples=(16, 16, 8, 8), fused_sa=True)
TOL = 1e-6


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _finish(procs, timeout=600):
    outs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _jax_supervised_step(batch, variables):
    """JAX's own make_train_step on the global batch, and the gradients of
    its loss (tests/test_torch_port_train.py's reference)."""
    jmodel = JaxPQTransformer(SUP_CFG)
    labeled = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jax_create_train_state(variables, JaxOptimizerConfig(), ema=False)
    step = jax_make_train_step(jmodel, SUP_CFG, SCANNET_MEAN_SIZES,
                               JaxTrainFlags(ema=False, gamma_mixture=False,
                                             arkit=False))
    new_state, stats = step(state, labeled, labeled, jax.random.PRNGKey(0),
                            jnp.float32(0.0))

    def loss_fn(params):
        ep, _ = jmodel.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             labeled["point_clouds"], train=True,
                             rngs={"dropout": jax.random.PRNGKey(0)},
                             mutable=["batch_stats"])
        return jlosses.get_loss({**ep, **labeled}, SCANNET_MEAN_SIZES,
                                num_layer=SUP_CFG.num_decoder_layers)[0]
    grads = jax.jit(jax.grad(loss_fn))(variables["params"])
    return (jax.tree.map(np.asarray, stats), jax.tree.map(np.asarray, grads),
            jax.tree.map(np.asarray, new_state.batch_stats))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on 2 ranks and in one process; JAX's supervised step."""
    out = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    layers = [6, 16, 16, 8]
    inputs = dict(
        x=t(rng.normal(1.0, 2.0, (4, 6, 8))),
        scale=t(rng.uniform(0.5, 1.5, 8)), shift=t(rng.normal(0, 0.1, 8)),
        grouped=t(rng.normal(0.0, 1.0, (4, 5, 8, layers[0]))),
        weights=[t(rng.normal(0, 1 / np.sqrt(a), (a, b)))
                 for a, b in zip(layers[:-1], layers[1:])],
        scales=[t(rng.uniform(0.5, 1.5, b)) for b in layers[1:]],
        biases=[t(rng.normal(0, 0.1, b)) for b in layers[1:]],
        semi_cfg=SEMI_CFG, semi_fused_cfg=SEMI_FUSED_CFG,
        eval_cfg=dict(SMOKE_MODEL, num_points=TINY.num_points))
    inputs["cot"] = t(rng.normal(size=(4, 6, 8)))
    inputs["fused_cot"] = t(rng.normal(size=(4, 5, layers[-1])))
    n = TINY.num_points
    for key in ("labeled", "weak"):
        inputs[key] = batch_to_tensors(augment(make_batch(rng, 2 * WORLD, n),
                                               rng), "cpu")
    sup_batch = make_batch(np.random.default_rng(7), 2 * WORLD, n)
    variables = randomised_variables(JaxPQTransformer(SUP_CFG),
                                     sup_batch["point_clouds"], seed=8)
    inputs.update(sup_cfg=dataclasses.asdict(port_config(SUP_CFG)),
                  sup_batch=batch_to_tensors(sup_batch, "cpu"),
                  sup_weights=flax_to_state_dict(variables))
    torch.save(inputs, out / "inputs.pt")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(w),
                               str(port), str(out)], env=_env(), cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r, w in ((0, WORLD), (1, WORLD), (0, 0))]
    try:
        jax_sup = _jax_supervised_step(sup_batch, variables)
    finally:
        _finish(procs)
    load = lambda f: torch.load(out / f, weights_only=False)  # noqa: E731
    return dict(ranks=[load(f"rank{r}.pt") for r in range(WORLD)],
                ref=load("ref.pt"), jax_sup=jax_sup, variables=variables)


def _close(got, want, what):
    """|got - want| within TOL of want's largest magnitude (at least 1)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    gap = float(np.abs(got - want).max())
    assert gap <= TOL * scale, f"{what}: {gap:.3e} > {TOL} * {scale:.3e}"


def _cat(ranks, case, key):
    return torch.cat([r[case][key] for r in ranks])


def test_batchnorm_over_two_ranks_is_the_global_batchnorm(runs):
    ranks, ref = runs["ranks"], runs["ref"]["bn"]
    for key in ("y", "x_grad"):  # each rank holds its rows
        _close(_cat(ranks, "bn", key), ref[key], key)
    for r in ranks:
        for key in ("running_mean", "running_var"):
            _close(r["bn"][key], ref[key], key)
    # each rank's loss is its rows' share: the parameter gradients add up
    for key in ("weight_grad", "bias_grad"):
        _close(sum(r["bn"][key] for r in ranks), ref[key], key)


def test_fused_mlp_pool_train_over_two_ranks_is_the_global_chain(runs):
    ranks, ref = runs["ranks"], runs["ref"]["fused"]
    for key in ("pooled", "grouped_grad"):
        _close(_cat(ranks, "fused", key), ref[key], key)
    for r in ranks:
        for key in ("means", "variances"):
            for i, (got, want) in enumerate(zip(r["fused"][key], ref[key])):
                _close(got, want, f"{key} {i}")
    for key in ("weights_grad", "scales_grad", "biases_grad"):
        for i, want in enumerate(ref[key]):
            _close(sum(r["fused"][key][i] for r in ranks), want,
                   f"{key} {i}")


@pytest.mark.parametrize("case", ["semi", "semi_fused"])
def test_semi_step_over_two_ranks_is_the_global_step(runs, case):
    ranks, ref = [r[case] for r in runs["ranks"]], runs["ref"][case]
    assert ref["stats"][0]["gamma_engaged_frac"] > 0  # the criterion fired
    for r in ranks:
        got, want = r["stats"][0], ref["stats"][0]
        assert set(got) == set(want)
        assert got["total_loss"] == pytest.approx(want["total_loss"],
                                                  rel=1e-4)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-3)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        assert got["gamma_engaged_frac"] == want["gamma_engaged_frac"]
        norm = want["grad_norm"]
        for name, g in ref["grads"].items():
            np.testing.assert_allclose(_np(r["grads"][name]) / norm,
                                       _np(g) / norm, rtol=0, atol=1e-5,
                                       err_msg=name)
        assert r["stats"][1]["total_loss"] == pytest.approx(
            ref["stats"][1]["total_loss"], rel=2e-2)
        assert r["generator"] == ref["generator"]  # draws in step
    # every parameter, AdamW moment and BN buffer bitwise equal
    assert ranks[0]["digests"] == ranks[1]["digests"]
    assert ranks[0]["stats"] == ranks[1]["stats"]


def test_supervised_step_over_two_ranks_matches_jax(runs):
    stats_j, grads_j, bn_j = runs["jax_sup"]
    variables = runs["variables"]
    want = flax_to_state_dict({"params": grads_j,
                               "batch_stats": variables["batch_stats"]})
    want_bn = flax_to_state_dict({"params": variables["params"],
                                  "batch_stats": bn_j})
    norm = float(stats_j["grad_norm"])
    one = runs["ref"]["sup"]  # the port's one-process step, same batch
    for r in runs["ranks"]:
        got = r["sup"]
        assert set(got["stats"]) == set(stats_j)
        for k in stats_j:
            np.testing.assert_allclose(got["stats"][k], stats_j[k],
                                       rtol=1e-3, atol=1e-4, err_msg=k)
        for name, g in got["grads"].items():
            # the one-process port's own float32 drift from JAX can pass
            # 1e-3 of the norm at a weight of sa1 (train-mode BN over a
            # batch amplifies it): the ranks may add 1e-5 to it, no more
            drift = np.abs(_np(one["grads"][name])
                           - want[name].numpy()).max() / norm
            gap = np.abs(_np(g) - want[name].numpy()).max() / norm
            assert gap <= max(1e-3, drift + 1e-5), (name, gap, drift)
            np.testing.assert_allclose(_np(g) / norm,
                                       _np(one["grads"][name]) / norm,
                                       rtol=0, atol=1e-5, err_msg=name)
        for name, buf in got["buffers"].items():
            np.testing.assert_allclose(_np(buf), want_bn[name].numpy(),
                                       rtol=1e-3, atol=1e-3, err_msg=name)


def test_sharded_evaluate_is_the_full_set_evaluate(runs):
    ref = runs["ref"]["eval"]
    for r in runs["ranks"]:
        for tag in ("student", "ema"):
            got, want = r["eval"][tag], ref[tag]
            assert got["f1"] == want["f1"]
            (gp, gm), = got["means"]
            (wp, wm), = want["means"]
            assert gp == wp == f"eval_{tag}" and set(gm) == set(wm)
            for k in wm:
                np.testing.assert_allclose(gm[k], wm[k], rtol=1e-5,
                                           atol=1e-5, err_msg=k)


@pytest.fixture
def world_one_group():
    """A world-1 gloo process group in this process, for the test."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("cfg_kw", [SEMI_CFG, SEMI_FUSED_CFG],
                         ids=["unfused", "fused"])
def test_world_one_group_is_bitwise_the_step_without_one(world_one_group,
                                                         cfg_kw):
    """Inside data_parallel on a group of one rank, the semi step computes
    bitwise what it computes without the context (the statistics are each
    rank's own expectations over world, the gather and the gradient
    average the identity): the context adds no arithmetic of its own."""
    from omni_pq_torch import parallel
    from omni_pq_torch.config import ModelConfig
    from omni_pq_torch.infer import build_model
    from omni_pq_torch.train import (OptimizerConfig, TrainFlags, TrainState,
                                     make_train_step)
    cfg = ModelConfig(**cfg_kw)
    rng = np.random.default_rng(1)
    lab, weak = (batch_to_tensors(make_batch(rng, 2, TINY.num_points), "cpu")
                 for _ in range(2))
    out = []
    for ctx in (contextlib.nullcontext, parallel.data_parallel):
        model = build_model(cfg, "cpu", seed=5)
        state = TrainState(model, OptimizerConfig(), ema=True)
        step = make_train_step(model, cfg, SCANNET_MEAN_SIZES, TrainFlags())
        with ctx():
            stats = step(state, lab, weak,
                         generator=torch.Generator().manual_seed(7),
                         consistency_weight=0.3)
        out.append((stats, {n: p.grad for n, p in model.named_parameters()},
                    dict(model.named_buffers()),
                    dict(state.ema_model.named_buffers())))
    for a, b in zip(*out):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def _train_lines(path):
    """The logged losses of each step and the F1 lines of a rank's log
    (the step's wall and loader ms differ by rank)."""
    out = []
    for line in open(path).read().splitlines():
        m = re.search(r"INFO (Train: .*|\[eval:.*)", line)
        if m:
            out.append(re.sub(r" (step_ms|data_ms) \S+", "", m.group(1)))
    return out


def test_train_cli_multihost_on_two_cpu_ranks(tmp_path):
    """--multihost on 2 gloo ranks: rank 0 alone writes config.json,
    metrics.jsonl and the checkpoints, both ranks log the same losses and
    F1, and the last checkpoint resumes in one process."""
    log_dir = tmp_path / "run"
    argv = ["--smoke", "--synthetic_data", "--num_point", "512", "--device",
            "cpu", "--max_epoch", "1", "--end_proportion", "1.0",
            "--print_freq", "1", "--save_freq", "1", "--batch_size", "4",
            "--rng_seed", "3", "--ema", "--gamma_mixture", "--f32"]
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "omni_pq_torch.cli.train", *argv,
         "--log_dir", str(log_dir), "--multihost", "--coordinator_address",
         f"localhost:{port}", "--num_processes", str(WORLD), "--process_id",
         str(r)], env=_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    _finish(procs)
    # (best / ema_best only if random weights score: not expected)
    assert set(os.listdir(log_dir)) - {"ckpt_epoch_best.pth",
                                       "ckpt_epoch_ema_best.pth"} == {
        "ckpt_epoch_1.pth", "ckpt_epoch_last.pth", "config.json",
        "log.rank0.txt", "log.rank1.txt", "metrics.jsonl", "tb"}
    lines = [_train_lines(log_dir / f"log.rank{r}.txt")
             for r in range(WORLD)]
    # 32 synthetic scenes, 16 a rank, 4 a step: 4 steps; 2 eval passes
    assert sum(x.startswith("Train:") for x in lines[0]) == 4
    assert sum("quad F1" in x for x in lines[0]) == 2
    assert lines[0] == lines[1]
    recs = [json.loads(x) for x in
            (log_dir / "metrics.jsonl").read_text().splitlines()]
    # one writer: each step's record once
    assert [r["step"] for r in recs if "train/total_loss" in r] == [
        1, 2, 3, 4]
    assert all(np.isfinite(v) for r in recs for v in r.values())
    last = torch.load(log_dir / "ckpt_epoch_last.pth", weights_only=True)
    assert last["step"] == 4 and last["optimizer"]["count"] == 4

    # the epoch-1 checkpoint resumes in one process: epoch 2 at batch 4 is
    # 8 steps, counted on from the file's 4
    rerun = tmp_path / "resumed"
    train_cli.main(argv + ["--log_dir", str(rerun), "--max_epoch", "2",
                           "--checkpoint_path",
                           str(log_dir / "ckpt_epoch_1.pth")])
    last = torch.load(rerun / "ckpt_epoch_last.pth", weights_only=True)
    assert last["step"] == 12 and last["optimizer"]["count"] == 12
