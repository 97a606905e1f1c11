"""One rank of the port's data-parallel checks on the CPU (not a pytest
module; tests/test_torch_port_parallel.py starts it).

Usage: python tests/torch_parallel_worker.py <rank> <world> <port> <dir>

<dir>/inputs.pt holds the global inputs of every case. With world >= 1 the
process joins a gloo group of `world` ranks on localhost:<port>, takes its
rows of each global batch and runs each case inside
`parallel.data_parallel`; with world 0 it runs each case on the global
batch in one process, without a process group (the reference). Results go
to <dir>/rank<r>.pt (or ref.pt). torch runs one intra-op thread.

Cases: "bn" (train-mode BatchNorm: output, input / weight / bias
gradients, running stats), "fused" (fused_mlp_pool train mode on the CPU
path, with its recomputing backward), "semi" and "semi_fused" (two whole
semi-supervised steps: stats, gradients after the first, and a digest of
every parameter, AdamW moment and BN buffer after the second), "sup" (one
supervised step from given weights: stats, gradients, running stats) and
"eval" (cli.train.evaluate over a sharded val set: F1 and loss means).
"""
import argparse
import contextlib
import hashlib
import logging
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from omni_pq_torch import parallel  # noqa: E402
from omni_pq_torch.config import (SCANNET_MEAN_SIZES, DatasetConfig,  # noqa: E402
                                  ModelConfig)
from omni_pq_torch.data import Loader, SyntheticDataset  # noqa: E402
from omni_pq_torch.infer import build_model, load_model  # noqa: E402
from omni_pq_torch.models.pointnet2 import BatchNorm  # noqa: E402
from omni_pq_torch.ops import fused_mlp_pool  # noqa: E402
from omni_pq_torch.train import (OptimizerConfig, TrainFlags,  # noqa: E402
                                 TrainState, make_train_step)

SEMI_FLAGS = TrainFlags(ema=True, gamma_mixture=True, arkit=False,
                        pc_loss=True)
CONSISTENCY_WEIGHT = 0.3


def rows(t, rank, world):
    """This rank's rows of a global tensor (all of it for the reference)."""
    if world == 0:
        return t
    n = t.shape[0] // world
    return t[rank * n:(rank + 1) * n]


def local_batch(batch, rank, world):
    return {k: rows(v, rank, world) for k, v in batch.items()}


def digest(t):
    return hashlib.sha1(t.detach().contiguous().numpy().tobytes()).hexdigest()


def state_digests(state):
    """A digest of every parameter, buffer (student and teacher) and AdamW
    moment: equal digests are bitwise equal tensors."""
    out = {f"model.{k}": digest(v) for k, v in
           state.model.state_dict().items()}
    out.update({f"ema.{k}": digest(v) for k, v in
                state.ema_model.state_dict().items()})
    for name, p in state.model.named_parameters():
        for k, v in state.optimizer.state.get(p, {}).items():
            out[f"opt.{name}.{k}"] = digest(v)
    return out


def rig_last_quad_head(model):
    """Every quad of the last decoder layer confident, normals along +x,
    wide and tall, centred on its query point: the gamma criterion then
    engages on the synthetic rooms' x walls."""
    head = model.prediction_quad_heads[-1]
    with torch.no_grad():
        for name, bias in (("quad_scores_head", [0.0, 3.0]),
                           ("normal_vector_head", [1.0, 0.0, 0.0]),
                           ("size_head", [10.0, 10.0]),
                           ("center_head", [0.0, 0.0, 0.0])):
            conv = getattr(head, name)
            conv.weight.mul_(0.01)
            conv.bias.copy_(torch.tensor(bias))


def case_bn(inp, rank, world):
    x = rows(inp["x"], rank, world).clone().requires_grad_()
    bn = BatchNorm(x.shape[-1]).train()
    with torch.no_grad():
        bn.weight.copy_(inp["scale"])
        bn.bias.copy_(inp["shift"])
    y = bn(x)
    (y * rows(inp["cot"], rank, world)).sum().backward()
    return dict(y=y.detach(), x_grad=x.grad, weight_grad=bn.weight.grad,
                bias_grad=bn.bias.grad, running_mean=bn.running_mean,
                running_var=bn.running_var)


def case_fused(inp, rank, world):
    g = rows(inp["grouped"], rank, world).clone().requires_grad_()
    leaves = [[t.clone().requires_grad_() for t in inp[k]]
              for k in ("weights", "scales", "biases")]
    pooled, means, variances = fused_mlp_pool(g, *leaves, train=True)
    (pooled * rows(inp["fused_cot"], rank, world)).sum().backward()
    out = dict(pooled=pooled.detach(), means=means, variances=variances,
               grouped_grad=g.grad)
    for k, ts in zip(("weights", "scales", "biases"), leaves):
        out[f"{k}_grad"] = [t.grad for t in ts]
    return out


def case_semi(inp, rank, world, cfg_kw):
    cfg = ModelConfig(**cfg_kw)
    model = build_model(cfg, "cpu", seed=5)
    rig_last_quad_head(model)
    state = TrainState(model, OptimizerConfig(), ema=True)
    step = make_train_step(model, cfg, SCANNET_MEAN_SIZES, SEMI_FLAGS)
    gen = torch.Generator().manual_seed(7)
    lab = local_batch(inp["labeled"], rank, world)
    weak = local_batch(inp["weak"], rank, world)
    stats, grads = [], None
    for i in range(2):
        st = step(state, lab, weak, generator=gen,
                  consistency_weight=CONSISTENCY_WEIGHT)
        stats.append({k: float(v) for k, v in st.items()})
        if i == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return dict(stats=stats, grads=grads, digests=state_digests(state),
                generator=digest(gen.get_state()))


def case_sup(inp, rank, world):
    cfg = ModelConfig(**inp["sup_cfg"])
    model = load_model(inp["sup_weights"], cfg, "cpu")
    state = TrainState(model, OptimizerConfig())
    step = make_train_step(model, cfg, SCANNET_MEAN_SIZES,
                           TrainFlags(ema=False, gamma_mixture=False,
                                      arkit=False))
    st = step(state, local_batch(inp["sup_batch"], rank, world))
    return dict(stats={k: float(v) for k, v in st.items()},
                grads={n: p.grad for n, p in model.named_parameters()},
                buffers={n: b for n, b in model.named_buffers()
                         if n.endswith(("running_mean", "running_var"))})


class Means:
    """Collects what evaluate logs as metrics (every rank's copy)."""

    def __init__(self):
        self.records = []

    def log(self, step, scalars, prefix=None):
        self.records.append((prefix, dict(scalars)))


def case_eval(inp, rank, world):
    from omni_pq_torch.cli.train import evaluate
    cfg = ModelConfig(**inp["eval_cfg"])
    model = build_model(cfg, "cpu", seed=9)
    rig_last_quad_head(model)
    state = TrainState(model, OptimizerConfig(), ema=True)
    ds = SyntheticDataset(6, cfg.num_points, seed=3, num_objects=3)
    # local batch 2 over a shard of 3 scenes: batches of 2 then 1; the
    # reference takes the global batches (4 then 2) in one process
    loader = (Loader(ds, 4, shuffle=False, drop_last=False) if world == 0
              else Loader(ds, 2, shuffle=False, drop_last=False,
                          shard_id=rank, num_shards=world))
    args = argparse.Namespace(ap_iou_thresholds=[0.25], faster_eval=False,
                              nms_iou_quad=0.25, dump_result=False,
                              log_dir=None)
    out = {}
    for use_ema in (False, True):
        means = Means()
        f1 = evaluate(args, state, loader, DatasetConfig(),
                      logging.getLogger("parallel_worker"), use_ema=use_ema,
                      metrics=means)
        out["ema" if use_ema else "student"] = dict(f1=f1,
                                                    means=means.records)
    return out


def main():
    rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    cases = {
        "bn": lambda: case_bn(inp, rank, world),
        "fused": lambda: case_fused(inp, rank, world),
        "semi": lambda: case_semi(inp, rank, world, inp["semi_cfg"]),
        "semi_fused": lambda: case_semi(inp, rank, world,
                                        inp["semi_fused_cfg"]),
        "eval": lambda: case_eval(inp, rank, world),
        "sup": lambda: case_sup(inp, rank, world),
    }
    if world:
        parallel.init_distributed(f"localhost:{port}", world, rank,
                                  device="cpu")
    results = {}
    for name, fn in cases.items():
        with (parallel.data_parallel() if world
              else contextlib.nullcontext()):
            results[name] = fn()
    torch.save(results, os.path.join(
        out_dir, f"rank{rank}.pt" if world else "ref.pt"))
    if world:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
