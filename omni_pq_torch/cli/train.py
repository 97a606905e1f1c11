"""Training CLI, supervised baseline (the port of `omni_pq_tpu/cli/train.py`
restricted to its supervised flags).

The flags below keep the JAX CLI's names, defaults and meanings, except that
--max_epoch counts plain epochs: the JAX CLI divides it (and its print,
save and val frequencies) by --end_proportion, the labeled share of ScanNet,
which this CLI has no use for until the ScanNet loader is ported; the
port's --max_epoch N is the JAX CLI's --max_epoch N --end_proportion 1.0.
Training is the `sup` baseline of docs/SEMI_SUP.md: labeled batches only,
no EMA teacher, no gamma-mixture or ARKit loss. Every step's scalars go to
<log_dir>/metrics.jsonl as {"step", "time", "train/<stat>": value}.
Checkpoints and the in-loop evaluation are not ported yet. Runs on the card
unless --device cpu is given.

Run:  python -m omni_pq_torch.cli.train --synthetic_data --pc_loss
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
    parser.add_argument("--near_threshold", type=float, default=0.3,
                        help="GT assignment NEAR radius in meters "
                             "(reference fixed 0.3, loss_helper_pq.py:17)")
    parser.add_argument("--far_threshold", type=float, default=0.6,
                        help="GT assignment FAR radius in meters "
                             "(reference fixed 0.6, loss_helper_pq.py:18)")
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
    from ..data import Loader, SyntheticDataset
    from ..infer import build_model, resolve_device
    from ..train import (OptimizerConfig, TrainFlags, batch_to_tensors,
                         TrainState, make_train_step)

    device = resolve_device(args.device)
    cfg = ModelConfig(num_points=args.num_point,
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
    state = TrainState(model, opt_cfg)
    flags = TrainFlags(ema=False, gamma_mixture=False, arkit=False,
                       pc_loss=args.pc_loss,
                       near_threshold=args.near_threshold,
                       far_threshold=args.far_threshold)
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
            for batch in loader:
                stats = train_step(state, batch_to_tensors(batch, device),
                                   generator=generator)
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
