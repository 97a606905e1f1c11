"""Standalone evaluation driver (the port of `omni_pq_tpu/cli/eval.py`; the
reference's eval.py:296-464).

Evaluates a `.pth` checkpoint on the ScanNet val split (or ARKit valid with
--arkit, or synthetic rooms with --synthetic_data): quad F1, object mAP and
AR, and the eval-time loss stats (`cli.train.evaluate`), written to
<log_dir>/metrics.jsonl. A checkpoint tagged 'ema_best' is evaluated with
its saved teacher in the student's place (eval.py:157-159). Prints
`F1: x.xxxx` and returns the F1. Runs on the card unless --device cpu is
given.

Run:  python -m omni_pq_torch.cli.eval \
          --checkpoint_path log/x/ckpt_epoch_best.pth --data_root <root>
"""
from __future__ import annotations

import os
import sys

from .args import parse_option
from .train import evaluate, get_datasets, make_model_config


def main(argv=None):
    args = parse_option(argv, is_eval=True)

    from ..config import DatasetConfig
    from ..data import Loader
    from ..infer import build_model, resolve_device
    from ..train import OptimizerConfig, TrainState, load_checkpoint
    from ..utils.logger import setup_logger
    from ..utils.metrics import MetricsLogger

    device = resolve_device(args.device)
    os.makedirs(args.log_dir, exist_ok=True)
    logger = setup_logger(args.log_dir)
    logger.info(" ".join(sys.argv))

    _, _, val_ds = get_datasets(args)
    val_loader = Loader(val_ds, min(args.batch_size, len(val_ds)),
                        shuffle=False, drop_last=False)
    model = build_model(make_model_config(args), device, seed=args.rng_seed)
    state = TrainState(model, OptimizerConfig(total_steps=1), ema=True)
    use_ema = False
    if args.checkpoint_path:
        state, _, tag = load_checkpoint(args.checkpoint_path, state)
        use_ema = tag == "ema_best"
        logger.info(f"loaded {args.checkpoint_path} (ema={use_ema})")

    metrics = MetricsLogger(args.log_dir)
    f1 = evaluate(args, state, val_loader, DatasetConfig(), logger,
                  use_ema=use_ema, metrics=metrics)
    metrics.log(0, {"quad_f1": f1, "ema": float(use_ema)}, prefix="eval")
    metrics.close()
    print(f"F1: {f1:.4f}")
    return f1


if __name__ == "__main__":
    main()
