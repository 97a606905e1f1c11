"""The port's entry points on the CPU: `cli/args.py` against the JAX
package's parser, the slice as a whole (`cli.train.evaluate` against
`omni_pq_tpu.cli.train.evaluate` on one fake ScanNet val tree with one set
of weights), and the train / eval CLIs at the --smoke size on fake ScanNet
and ARKitScenes trees and on synthetic rooms (checkpoints, metrics.jsonl,
resume)."""
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from omni_pq_tpu.cli import args as jargs
from omni_pq_tpu.cli import train as jtrain
from omni_pq_tpu.config import DatasetConfig as JaxDatasetConfig
from omni_pq_tpu.data import Loader as JaxLoader
from omni_pq_tpu.data import ScannetDetectionDataset as JaxScannet
from omni_pq_tpu.models import PQTransformer as JaxPQTransformer
from omni_pq_tpu.train import (OptimizerConfig as JaxOptimizerConfig,
                               create_train_state)
from omni_pq_tpu.utils.metrics import MetricsLogger as JaxMetricsLogger
from omni_pq_torch.cli import args as targs
from omni_pq_torch.cli import eval as eval_cli
from omni_pq_torch.cli import train as train_cli
from omni_pq_torch.config import DatasetConfig
from omni_pq_torch.data import Loader, ScannetDetectionDataset
from omni_pq_torch.evals.quad import softmax
from omni_pq_torch.infer import load_model
from omni_pq_torch.interop import flax_to_state_dict
from omni_pq_torch.train import OptimizerConfig, TrainState
from omni_pq_torch.utils.logger import setup_logger
from omni_pq_torch.utils.metrics import MetricsLogger
from tests.test_torch_port_modules import port_config, randomised_variables
from tests.torch_fake_data import write_fake_arkit, write_fake_scannet
from tests.util import TINY

SCANS = [f"scene{i:04d}_00" for i in range(7)]
# float32 on the CPU (the bfloat16 default's CLI runs are
# test_torch_port_bf16.py's and chip_smoke.py's)
SMOKE = ["--smoke", "--num_point", "512", "--f32"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU ops: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores (OpenMP threads spin while they wait)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scannet(tmp_path_factory):
    """A fake ScanNet tree of 4 train and 3 val scans."""
    root = tmp_path_factory.mktemp("scannet")
    write_fake_scannet(str(root), SCANS, np.random.default_rng(0),
                       n_verts=700)
    (root / "meta_data/scannetv2_train.txt").write_text("\n".join(SCANS[:4]))
    (root / "meta_data/scannetv2_val.txt").write_text("\n".join(SCANS[4:]))
    return root


def records(log_dir):
    return [json.loads(line) for line in
            (Path(log_dir) / "metrics.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("argv,is_eval", [
    ([], False),
    (["--end_proportion", "0.5", "--max_epoch", "30", "--print_freq", "7",
      "--val_freq", "3", "--consistency_rampup", "4"], False),
    (["--end_proportion", "1.0", "--ema", "--gamma_mixture", "--f32",
      "--warmup-epoch", "2", "--ap_iou_thresholds", "0.25", "0.5"], False),
    (["--smoke", "--arkit", "--teacher_bf16", "--batch_size", "5"], False),
    ([], True),
    (["--end_proportion", "0.5", "--checkpoint_path", "x.pth"], True),
])
def test_parse_option_matches_jax(argv, is_eval):
    argv = argv + ["--log_dir", "log/x"]
    got = vars(targs.parse_option(argv, is_eval=is_eval))
    want = vars(jargs.parse_option(argv, is_eval=is_eval))
    assert got.pop("device") == "cuda"  # the port's one extra flag
    assert got == want


@pytest.mark.parametrize("argv", [["--eval_quad_topk", "64"],
                                  ["--threefry"]])
def test_refused_flags(argv, capsys):
    """The JAX flags the port keeps for scripts but refuses when set."""
    with pytest.raises(SystemExit):
        targs.parse_option(argv)
    assert "not supported by the port" in capsys.readouterr().err
    jargs.parse_option(argv)  # the JAX CLI takes them
    targs.parse_option(["--eval_quad_topk", "0"])  # defaults pass


@pytest.mark.parametrize("argv", [
    ["--multihost"], ["--coordinator_address", "localhost:1234"],
    ["--num_processes", "2"], ["--process_id", "0"]])
def test_multihost_flags_parse(argv):
    """The data-parallel flags parse as the JAX CLI's (their use:
    tests/test_torch_port_parallel.py)."""
    argv = argv + ["--log_dir", "log/x"]
    got = vars(targs.parse_option(argv))
    assert got.pop("device") == "cuda"
    assert got == vars(jargs.parse_option(argv))


def test_evaluate_matches_jax(scannet, tmp_path):
    """One set of TINY weights in both packages (flax_to_state_dict), the
    same val tree and seed: the same quad F1 and eval_student/* loss means
    within rtol 1e-4."""
    argv = SMOKE + ["--data_root", str(scannet)]
    jmodel = JaxPQTransformer(TINY)
    val = JaxScannet(str(scannet), "val", num_points=512, seed=2)
    variables = randomised_variables(
        jmodel, np.stack([val[i]["point_clouds"] for i in range(2)]), seed=5)
    jstate = create_train_state(variables, JaxOptimizerConfig(total_steps=1))
    jm = JaxMetricsLogger(str(tmp_path / "jax"), enable_tensorboard=False)
    want_f1 = jtrain.evaluate(
        jargs.parse_option(argv + ["--log_dir", str(tmp_path / "jax")],
                           is_eval=True),
        jmodel, jstate, JaxLoader(JaxScannet(str(scannet), "val",
                                             num_points=512, seed=2), 3,
                                  shuffle=False, drop_last=False),
        JaxDatasetConfig(), setup_logger(str(tmp_path / "jax")),
        metrics=jm)
    jm.close()

    model = load_model(flax_to_state_dict(jax.tree.map(np.asarray,
                                                       variables)),
                       port_config(TINY), "cpu")
    state = TrainState(model, OptimizerConfig(), ema=True)
    tm = MetricsLogger(str(tmp_path / "torch"), enable_tensorboard=False)
    loader = Loader(ScannetDetectionDataset(str(scannet), "val",
                                            num_points=512, seed=2), 3,
                    shuffle=False, drop_last=False)
    got_f1 = train_cli.evaluate(
        targs.parse_option(argv + ["--log_dir", str(tmp_path / "torch"),
                                   "--device", "cpu"], is_eval=True),
        state, loader, DatasetConfig(), setup_logger(str(tmp_path / "torch")),
        metrics=tm)
    tm.close()

    # quad confidences at the F1's 0.5 gate would make the F1 a coin toss
    loader.dataset.reseed()
    batch = next(iter(loader))
    probs = softmax(model(torch.from_numpy(batch["point_clouds"]))[
        "last_quad_scores"].detach().numpy())[..., 1]
    near = np.abs(probs - 0.5) < 1e-4
    assert got_f1 == want_f1, (
        f"quad F1 {got_f1} vs JAX {want_f1}; {int(near.sum())} quad "
        f"confidences lie within 1e-4 of the 0.5 gate")
    got, want = records(tmp_path / "torch")[0], records(tmp_path / "jax")[0]
    keys = {k for k in want if k.startswith("eval_student/")}
    assert {k for k in got if k.startswith("eval_student/")} == keys
    assert "eval_student/loss" in keys and len(keys) > 20
    for k in sorted(keys):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_train_eval_resume_on_fake_scannet(scannet, tmp_path):
    """Two epochs of the semi-supervised CLI with in-loop eval, the
    checkpoints its policy calls for, the eval CLI on the last one, and a
    resume from epoch 1 that runs epoch 2 again."""
    run = tmp_path / "run"
    base = SMOKE + ["--data_root", str(scannet), "--batch_size", "2",
                    "--max_epoch", "2", "--end_proportion", "1.0",
                    "--val_freq", "1", "--save_freq", "1", "--print_freq",
                    "1", "--ema", "--gamma_mixture", "--pc_loss",
                    "--device", "cpu", "--num_workers", "2"]
    max_f1, max_ema_f1 = train_cli.main(base + ["--log_dir", str(run),
                                                "--profile", "1"])
    recs = records(run)
    evals = [r for r in recs if "eval/quad_f1" in r]
    assert [r["eval/epoch"] for r in evals] == [1, 2]
    want = {"ckpt_epoch_1.pth", "ckpt_epoch_2.pth", "ckpt_epoch_last.pth"}
    if max(r["eval/quad_f1"] for r in evals) > 0:
        want.add("ckpt_epoch_best.pth")
    if max(r["eval/ema_quad_f1"] for r in evals) > 0.2:
        want.add("ckpt_epoch_ema_best.pth")
    assert {p.name for p in run.glob("*.pth")} == want
    assert max_f1 == max(r["eval/quad_f1"] for r in evals)
    train = [r for r in recs if "train/total_loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    for key in ("train/total_loss", "train/consistency_loss",
                "train/step_ms", "train/data_ms", "eval_student/loss",
                "eval_ema/loss", "eval_student/vote_loss"):
        vals = [r[key] for r in recs if key in r]
        assert vals and np.isfinite(vals).all(), key
    summary = json.loads((run / "profile/summary.json").read_text())
    assert summary["steps"] == 1 and summary["wall_ms"] > 0
    assert (run / "profile/trace.json").exists()
    # the spans of the profiled step and of the wait for its batches
    host_ms = summary["host_ms_per_step"]
    assert {"train.step", "train.loader_wait", "step.forward.student",
            "step.forward.teacher", "step.losses", "step.backward",
            "step.update"} <= set(host_ms)
    phases = sum(v for k, v in host_ms.items() if k.startswith("step."))
    assert 0 < phases <= host_ms["train.step"]
    assert summary["allocations_per_step"] is None  # no card

    # the eval CLI on the last checkpoint: the in-loop student's numbers
    f1 = eval_cli.main(SMOKE + ["--data_root", str(scannet), "--device",
                                "cpu", "--log_dir", str(tmp_path / "eval"),
                                "--checkpoint_path",
                                str(run / "ckpt_epoch_last.pth")])
    assert np.isfinite(f1) and f1 == evals[-1]["eval/quad_f1"]
    got = [r for r in records(tmp_path / "eval") if "eval_student/loss" in r]
    in_loop = [r for r in recs if "eval_student/loss" in r][-1]
    assert got[0]["eval_student/loss"] == in_loop["eval_student/loss"]

    # resume from epoch 1: epoch 2 only, the step count carried on
    resumed = tmp_path / "resumed"
    train_cli.main(base + ["--log_dir", str(resumed), "--checkpoint_path",
                           str(run / "ckpt_epoch_1.pth")])
    rrecs = records(resumed)
    assert [r["step"] for r in rrecs if "train/total_loss" in r] == [1, 2]
    assert [r["eval/epoch"] for r in rrecs if "eval/epoch" in r] == [2]
    last = torch.load(resumed / "ckpt_epoch_last.pth", weights_only=True)
    assert (last["step"], last["optimizer"]["count"], last["tag"]) == (
        4, 4, "last")


def test_train_and_eval_cli_on_synthetic_rooms(tmp_path):
    run = tmp_path / "run"
    train_cli.main(SMOKE + ["--synthetic_data", "--batch_size", "8",
                            "--max_epoch", "2", "--end_proportion", "1.0",
                            "--val_freq", "1", "--save_freq", "2",
                            "--print_freq", "2",
                            "--ema", "--device", "cpu", "--log_dir",
                            str(run)])
    assert {"ckpt_epoch_2.pth", "ckpt_epoch_last.pth"} <= {
        p.name for p in run.glob("*.pth")}
    recs = records(run)
    for key in ("train/total_loss", "eval/quad_f1", "eval_student/loss",
                "eval_ema/loss"):
        assert any(key in r for r in recs), key
    f1 = eval_cli.main(SMOKE + ["--synthetic_data", "--batch_size", "4",
                                "--faster_eval", "--device", "cpu",
                                "--log_dir", str(tmp_path / "eval"),
                                "--checkpoint_path",
                                str(run / "ckpt_epoch_last.pth")])
    assert np.isfinite(f1)


def test_train_cli_arkit(scannet, tmp_path):
    """--arkit: ScanNet labeled batches, ARKit weak boxes with the pc loss,
    and the ARKit valid split's quad F1."""
    arkit = tmp_path / "arkit"
    write_fake_arkit(str(arkit), [f"4104819{i}" for i in range(4)],
                     np.random.default_rng(1), n_verts=700,
                     valid_scans=["47331587", "47331588"])
    run = tmp_path / "run"
    max_f1, _ = train_cli.main(SMOKE + [
        "--batch_size", "2", "--max_epoch", "1", "--end_proportion", "1.0",
        "--val_freq", "1", "--save_freq", "9", "--print_freq", "1",
        "--faster_eval", "--ema", "--pc_loss", "--arkit",
        "--lambda_arkit_pc_loss", "1.0", "--data_root", str(scannet),
        "--arkit_data_root", str(arkit), "--device", "cpu",
        "--log_dir", str(run)])
    recs = records(run)
    ark = [r["train/arkit_pc_loss"] for r in recs
           if "train/arkit_pc_loss" in r]
    assert len(ark) == 2 and any(v != 0.0 for v in ark)
    assert any("eval/quad_f1" in r for r in recs) and np.isfinite(max_f1)
    # ARKit valid batches carry quad labels only: no eval loss stats
    assert not any("eval_student/loss" in r for r in recs)
