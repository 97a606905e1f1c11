"""The port's `.pth` checkpoints (train/checkpoint.py) on the CPU at the TINY
size, float32: save, load and one more step equal an uninterrupted run
bitwise (student, teacher, AdamW moments and accumulated gradients); the
reference's tag sentinels and teacher backfill; the infer CLI on a saved
file; and scripts/orbax_to_pth.py on a checkpoint written by the JAX
package (its eval forward within 1e-4, the moments equal)."""
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omni_pq_tpu.models import PQTransformer as JaxPQTransformer
from omni_pq_tpu.train import (OptimizerConfig as JaxOptimizerConfig,
                               create_train_state,
                               save_checkpoint as jax_save_checkpoint)
from omni_pq_torch.cli import infer as infer_cli
from omni_pq_torch.config import SCANNET_MEAN_SIZES
from omni_pq_torch.data import make_batch
from omni_pq_torch.data.preprocess import read_ply_xyzrgb
from omni_pq_torch.infer import build_model, eval_forward
from omni_pq_torch.interop import flax_to_state_dict
from omni_pq_torch.train import (OptimizerConfig, TrainFlags, TrainState,
                                 batch_to_tensors, load_checkpoint,
                                 make_train_step, save_checkpoint)
from omni_pq_torch.utils.viz import write_ply_points
from tests.test_torch_port_modules import port_config, randomised_variables
from tests.util import TINY

CFG = port_config(TINY)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU ops: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores (OpenMP threads spin while they wait)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def new_state(seed, step_freq=1):
    return TrainState(build_model(CFG, "cpu", seed=seed),
                      OptimizerConfig(total_steps=20, step_freq=step_freq),
                      ema=True)


def snapshot(state):
    """Every tensor a step may change, by name."""
    out = {f"model.{k}": v.clone() for k, v in state.model.state_dict().items()}
    out.update({f"ema.{k}": v.clone()
                for k, v in state.ema_model.state_dict().items()})
    params = dict(state.model.named_parameters())
    for name, p in params.items():
        for k, v in state.optimizer.state.get(p, {}).items():
            out[f"opt.{name}.{k}"] = v.clone()
    return out


@pytest.mark.parametrize("step_freq", [1, 2])
def test_resume_equals_an_uninterrupted_run(tmp_path, step_freq):
    rng = np.random.default_rng(0)
    batches = [(batch_to_tensors(make_batch(rng, 2, CFG.num_points), "cpu"),
                batch_to_tensors(make_batch(rng, 2, CFG.num_points), "cpu"))
               for _ in range(3)]
    flags = TrainFlags()  # EMA teacher + gamma mixture: every part moves

    def run(state, gen, which):
        step = make_train_step(state.model, CFG, SCANNET_MEAN_SIZES, flags)
        for i in which:
            step(state, *batches[i], generator=gen, consistency_weight=0.05)

    state = new_state(seed=1, step_freq=step_freq)
    gen = torch.Generator().manual_seed(9)
    run(state, gen, [0, 1])
    path = save_checkpoint(str(tmp_path), 2, state, epoch=2)
    gen_state = gen.get_state()
    run(state, gen, [2])
    want = snapshot(state)

    resumed = new_state(seed=2, step_freq=step_freq)  # other weights
    resumed, epoch, tag = load_checkpoint(path, resumed)
    assert (epoch, tag, resumed.step) == (2, "", 2)
    assert resumed.optimizer.count == (2 if step_freq == 1 else 1)
    gen = torch.Generator().manual_seed(0)
    gen.set_state(gen_state)
    run(resumed, gen, [2])
    got = snapshot(resumed)
    assert set(got) == set(want)
    assert any(k.endswith(".mu") for k in got)
    assert any(k.endswith(".acc") for k in got) == (step_freq > 1)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert resumed.step == state.step == 3


def test_tags_and_epoch_sentinels(tmp_path):
    state = new_state(seed=1)
    for tag, epoch, want in ((7, 7, 7), ("best", 5, 0), ("ema_best", 5, 0),
                             ("last", 9, 600)):
        path = save_checkpoint(str(tmp_path), tag, state, epoch=epoch)
        assert Path(path).name == f"ckpt_epoch_{tag}.pth"
        payload = torch.load(path, weights_only=True)
        assert {"model", "ema_model", "optimizer", "scheduler",
                "epoch"} <= set(payload)
        _, got_epoch, got_tag = load_checkpoint(path, new_state(seed=2))
        assert got_epoch == want
        assert got_tag == ("" if isinstance(tag, int) else tag)


def test_missing_teacher_is_backfilled_from_the_student(tmp_path):
    """A reference-layout file with no ema_model and DDP's 'module.' prefix:
    the teacher becomes the student, the optimiser stays fresh."""
    src = build_model(CFG, "cpu", seed=3)
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    torch.save({"model": sd, "epoch": 4}, tmp_path / "ref.pth")
    state = new_state(seed=4)
    state, epoch, tag = load_checkpoint(str(tmp_path / "ref.pth"), state)
    assert (epoch, tag, state.optimizer.count, state.step) == (4, "", 0, 0)
    for k, v in src.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
        assert torch.equal(state.ema_model.state_dict()[k], v), k


def test_infer_cli_loads_a_saved_checkpoint(tmp_path):
    """cli.infer reads a saved file's student, or its teacher when tagged
    ema_best, from a .npy or a .ply cloud."""
    state = new_state(seed=5)
    teacher = build_model(CFG, "cpu", seed=6)
    state.ema_model.load_state_dict(teacher.state_dict())
    rng = np.random.default_rng(1)
    pts = rng.uniform(0.5, 4.0, (900, 3)).astype(np.float32)
    write_ply_points(pts, str(tmp_path / "scene.ply"))
    # the cloud as the ASCII PLY holds it (6 decimals)
    np.save(tmp_path / "scene.npy", read_ply_xyzrgb(str(tmp_path /
                                                        "scene.ply")))

    def infer(ckpt, cloud, out):
        return infer_cli.main([
            "--checkpoint_path", str(ckpt), "--input", str(tmp_path / cloud),
            "--output", str(tmp_path / out), "--num_point", "512", "--smoke",
            "--device", "cpu", "--quad_conf", "0.0", "--obj_conf", "0.0",
            "--dump_ply", str(tmp_path / "dump")])
    last = save_checkpoint(str(tmp_path), "last", state, epoch=1)
    ema = save_checkpoint(str(tmp_path), "ema_best", state, epoch=1)
    torch.save({"model": state.model.state_dict()}, tmp_path / "student.pth")
    torch.save({"model": teacher.state_dict()}, tmp_path / "teacher.pth")
    got = infer(last, "scene.ply", "a.json")
    assert got == infer(tmp_path / "student.pth", "scene.npy", "b.json")
    assert len(got[0]) > 0 and len(got[1]) > 0
    got_ema = infer(ema, "scene.ply", "c.json")
    assert got_ema == infer(tmp_path / "teacher.pth", "scene.ply", "d.json")
    assert got_ema != got
    assert json.loads((tmp_path / "c.json").read_text())["quads"] == \
        got_ema[0]
    assert (tmp_path / "dump" / "input.ply").exists()


def load_script():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_pth", ROOT / "scripts" / "orbax_to_pth.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_weights():
    """A JAX student and teacher (random BN statistics) and their eval
    forwards on two clouds, computed once."""
    rng = np.random.default_rng(2)
    pc = (rng.uniform(size=(2, TINY.num_points, 3)) * [4.0, 4.0, 2.5]
          + 0.5).astype(np.float32)
    jmodel = JaxPQTransformer(TINY)
    variables = randomised_variables(jmodel, pc, seed=3)
    teacher = randomised_variables(jmodel, pc, seed=4)
    apply = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    outs = [jax.tree.map(np.asarray, apply(v, jnp.asarray(pc)))
            for v in (variables, teacher)]
    return pc, variables, teacher, outs


@pytest.mark.parametrize("step_freq", [1, 2])
def test_orbax_to_pth(tmp_path, jax_weights, step_freq):
    """A JAX checkpoint (random BN statistics, a teacher apart from the
    student, random AdamW moments and MultiSteps accumulators) converted:
    the port's eval forward of the student and of the teacher within 1e-4
    of JAX's, and every moment equal to JAX's."""
    pc, variables, teacher, outs = jax_weights
    rng = np.random.default_rng(step_freq)
    state = create_train_state(variables,
                               JaxOptimizerConfig(step_freq=step_freq))

    def noise(x):
        if jnp.issubdtype(x.dtype, jnp.integer):
            return jnp.full_like(x, 5)
        return jnp.asarray(rng.normal(size=x.shape), x.dtype)
    opt_state = jax.tree.map(noise, state.opt_state)
    if step_freq > 1:
        opt_state = opt_state._replace(mini_step=jnp.asarray(1, jnp.int32))
    state = state.replace(
        opt_state=opt_state,
        ema_params=teacher["params"], ema_batch_stats=teacher["batch_stats"],
        step=jnp.asarray(5, jnp.int32))
    ckpt = jax_save_checkpoint(str(tmp_path), "ema_best", state, epoch=3)
    path = load_script().convert(ckpt, str(tmp_path / "out"),
                                 ["--smoke", "--num_point", "512", "--f32"],
                                 step_freq=step_freq)
    assert Path(path).name == "ckpt_epoch_ema_best.pth"

    port = TrainState(build_model(CFG, "cpu"), OptimizerConfig(
        step_freq=step_freq), ema=True)
    port, epoch, tag = load_checkpoint(path, port)
    assert (epoch, tag, port.step) == (0, "ema_best", 5)
    for model, want in zip((port.model, port.ema_model), outs):
        got = eval_forward(model, pc)
        for k in ("last_quad_scores", "last_quad_center", "last_center",
                  "seed_features", "vote_xyz"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-4, atol=1e-4, err_msg=k)

    opt_state = state.opt_state
    if step_freq > 1:
        assert port.optimizer.mini_step == int(opt_state.mini_step)
        acc = flax_to_state_dict({"params": opt_state.acc_grads,
                                  "batch_stats": variables["batch_stats"]})
        opt_state = opt_state.inner_opt_state
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 2  # base and decoder groups
    assert port.optimizer.count == 5
    for which in ("mu", "nu"):
        # each group's tree with its masked modules as zeros, laid out by
        # the port's names: every parameter is in exactly one group
        laid_out = []
        for group in adam:
            tree = {k: (jax.tree.map(jnp.zeros_like, variables["params"][k])
                        if isinstance(v, optax.MaskedNode) else v)
                    for k, v in getattr(group, which).items()}
            laid_out.append(flax_to_state_dict(
                {"params": tree, "batch_stats": variables["batch_stats"]}))
        for name, p in port.model.named_parameters():
            parts = [sd[name] for sd in laid_out if sd[name].any()]
            assert len(parts) == 1, (which, name)
            assert torch.equal(port.optimizer.state[p][which], parts[0]), (
                which, name)
    if step_freq > 1:
        for name, p in port.model.named_parameters():
            assert torch.equal(port.optimizer.state[p]["acc"], acc[name])
