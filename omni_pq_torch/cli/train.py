"""Training CLI (the port of `omni_pq_tpu/cli/train.py`: its loop and its
supervised and semi-supervised flags).

The flags below keep the JAX CLI's names, defaults and meanings, except that
--max_epoch and --consistency_rampup count plain epochs: the JAX CLI divides
them (and its print, save and val frequencies) by --end_proportion, the
labeled share of ScanNet, which this CLI has no use for until the ScanNet
loader is ported; the port's --max_epoch N is the JAX CLI's --max_epoch N
--end_proportion 1.0. Without --ema, --gamma_mixture and --arkit, training
is the `sup` baseline of docs/SEMI_SUP.md (labeled batches only); with any
of them each step also takes a weak batch from an endless stream of
synthetic scenes (seed --rng_seed + 1), as the JAX CLI does, and the
consistency loss is weighted by the sigmoid ramp of --consistency_weight
over --consistency_rampup epochs. Every step's scalars go to
<log_dir>/metrics.jsonl as {"step", "time", "train/<stat>": value}.
Checkpoints, the in-loop evaluation and the ScanNet / ARKitScenes loaders
are not ported yet. Runs on the card unless --device cpu is given. The
model computes in bfloat16 by default, as the JAX CLI's does (--f32 opts
out, --bf16 is the default; parameters, BatchNorm statistics and losses
stay float32), and --teacher_bf16 runs the EMA teacher's forward in
bfloat16.

Run:  python -m omni_pq_torch.cli.train --synthetic_data --pc_loss \
          --ema --gamma_mixture
      (add --smoke --num_point 512 --device cpu for a tiny CPU run)
"""
from __future__ import annotations

import argparse
import json
import os
import time


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=3)
    parser.add_argument("--num_point", type=int, default=40000)
    parser.add_argument("--synthetic_data", action="store_true",
                        help="use the synthetic room generator (no data on "
                             "disk); required until the ScanNet loader is "
                             "ported")
    parser.add_argument("--max_epoch", type=int, default=600)
    parser.add_argument("--weight_decay", type=float, default=0.0005)
    parser.add_argument("--learning_rate", type=float, default=0.002)
    parser.add_argument("--decoder_learning_rate", type=float,
                        default=0.0001)
    parser.add_argument("--clip_norm", default=0.1, type=float)
    parser.add_argument("--step_freq", type=int, default=1)
    parser.add_argument("--pc_loss", action="store_true")
    # weak losses (the JAX CLI's, cli/args.py:55-67)
    parser.add_argument("--gamma_mixture", action="store_true")
    parser.add_argument("--ema", action="store_true")
    parser.add_argument("--arkit", action="store_true",
                        help="ARKit pc loss on the weak half (with "
                             "--synthetic_data the weak scenes are synthetic)")
    parser.add_argument("--ema_decay", type=float, default=0.999)
    parser.add_argument("--consistency_weight", type=float, default=0.05)
    parser.add_argument("--consistency_rampup", type=int, default=1)
    parser.add_argument("--lambda_metric_normal", type=float, default=0.0010)
    parser.add_argument("--lambda_metric_vertical", type=float,
                        default=0.0010)
    parser.add_argument("--lambda_metric_size", type=float, default=0.0010)
    parser.add_argument("--lambda_metric_score", type=float, default=0.0010)
    parser.add_argument("--lambda_arkit_pc_loss", type=float, default=0.0)
    parser.add_argument("--use_fitted_mixture", action="store_true",
                        help="label pseudo points with the EM-fitted mixture "
                             "instead of the reference's fixed initial one")
    parser.add_argument("--near_threshold", type=float, default=0.3,
                        help="GT assignment NEAR radius in meters "
                             "(reference fixed 0.3, loss_helper_pq.py:17)")
    parser.add_argument("--far_threshold", type=float, default=0.6,
                        help="GT assignment FAR radius in meters "
                             "(reference fixed 0.6, loss_helper_pq.py:18)")
    # bfloat16 compute by default, --f32 to opt out, --teacher_bf16 (the
    # JAX CLI's cli/args.py:106-126)
    parser.add_argument("--bf16", action="store_true", default=True,
                        help="bfloat16 compute for the Dense path (params "
                             "and losses stay float32; the default)")
    parser.add_argument("--f32", dest="bf16", action="store_false",
                        help="full float32 compute (opt out of the "
                             "bfloat16 default)")
    parser.add_argument("--teacher_bf16", action="store_true",
                        help="run the EMA teacher's forward in bfloat16 "
                             "(soft consistency targets only)")
    parser.add_argument("--rng_seed", type=int, default=0)
    parser.add_argument("--log_dir",
                        default=f"log/{time.strftime('%Y%m%d-%H%M%S')}")
    parser.add_argument("--smoke", action="store_true",
                        help="tiny model + tiny scenes for CI smoke runs")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default) or 'cpu'")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.synthetic_data:
        raise SystemExit("omni_pq_torch.cli.train: only --synthetic_data is "
                         "supported (the ScanNet loader is not ported yet)")

    import torch

    from ..config import SCANNET_MEAN_SIZES, SMOKE_MODEL, ModelConfig
    from ..data import Loader, SyntheticDataset, endless
    from ..infer import build_model, resolve_device
    from ..train import (OptimizerConfig, TrainFlags, batch_to_tensors,
                         TrainState, consistency_weight, make_train_step)

    device = resolve_device(args.device)
    cfg = ModelConfig(num_points=args.num_point,
                      compute_dtype="bfloat16" if args.bf16 else "float32",
                      **(SMOKE_MODEL if args.smoke else {}))
    loader = Loader(SyntheticDataset(32, args.num_point, seed=args.rng_seed),
                    args.batch_size, seed=args.rng_seed)
    model = build_model(cfg, device, seed=args.rng_seed)
    opt_cfg = OptimizerConfig(
        learning_rate=args.learning_rate,
        decoder_learning_rate=args.decoder_learning_rate,
        weight_decay=args.weight_decay, clip_norm=args.clip_norm,
        total_steps=args.max_epoch * max(len(loader), 1),
        step_freq=args.step_freq)
    state = TrainState(model, opt_cfg, ema=args.ema)
    flags = TrainFlags(
        ema=args.ema, gamma_mixture=args.gamma_mixture, arkit=args.arkit,
        pc_loss=args.pc_loss, use_fitted_mixture=args.use_fitted_mixture,
        teacher_bf16=args.teacher_bf16, ema_decay=args.ema_decay,
        lambda_metric_normal=args.lambda_metric_normal,
        lambda_metric_vertical=args.lambda_metric_vertical,
        lambda_metric_size=args.lambda_metric_size,
        lambda_metric_score=args.lambda_metric_score,
        lambda_arkit_pc_loss=args.lambda_arkit_pc_loss,
        near_threshold=args.near_threshold, far_threshold=args.far_threshold)
    weak_iter = None
    if flags.ema or flags.gamma_mixture or flags.arkit:
        weak_iter = endless(Loader(
            SyntheticDataset(32, args.num_point, seed=args.rng_seed + 1),
            args.batch_size, seed=args.rng_seed + 1))
    train_step = make_train_step(model, cfg, SCANNET_MEAN_SIZES, flags)
    generator = torch.Generator(device).manual_seed(args.rng_seed + 123)

    os.makedirs(args.log_dir, exist_ok=True)
    with open(os.path.join(args.log_dir, "config.json"), "w") as f:
        json.dump(vars(args), f, indent=2)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.2f}M params on {device}; "
          f"{len(loader)} steps an epoch", flush=True)
    last = {}
    with open(os.path.join(args.log_dir, "metrics.jsonl"), "a") as metrics:
        for epoch in range(1, args.max_epoch + 1):
            loader.set_epoch(epoch)
            tic = time.time()
            cw = consistency_weight(epoch, args.consistency_weight,
                                    args.consistency_rampup)
            for batch in loader:
                weak = (batch_to_tensors(next(weak_iter), device)
                        if weak_iter is not None else None)
                stats = train_step(state, batch_to_tensors(batch, device),
                                   weak, generator=generator,
                                   consistency_weight=cw)
                last = {k: float(v) for k, v in stats.items()}
                rec = {"step": state.step, "time": time.time(),
                       **{f"train/{k}": v for k, v in last.items()}}
                metrics.write(json.dumps(rec) + "\n")
            metrics.flush()
            print(f"epoch {epoch}: total_loss {last['total_loss']:.4f} "
                  f"grad_norm {last['grad_norm']:.4f} "
                  f"({time.time() - tic:.2f} s)", flush=True)
    return last


if __name__ == "__main__":
    main()
