#!/usr/bin/env bash
# Semi-supervised training at the reference regime (train.sh:12-31 of the
# reference) with the PyTorch port, on the card: 10% labels + EMA teacher +
# gamma-mixture pseudo-labels + physical-constraint loss; bs 3 labeled + 3
# weak per step. The command line of scripts/train.sh, pointed at
# omni_pq_torch.cli.train (bfloat16 by default, --f32 to opt out;
# --device cpu to run without a card).
# Usage: scripts/train_torch.sh <data_root> [extra flags...]
set -e
DATA_ROOT=${1:-data/scannet}
shift || true
python -m omni_pq_torch.cli.train \
    --data_root "$DATA_ROOT" \
    --batch_size 3 \
    --start_proportion 0.0 --end_proportion 0.1 \
    --max_epoch 1200 \
    --ema --gamma_mixture --pc_loss \
    --consistency_weight 0.05 \
    --lambda_metric_normal 0.0005 --lambda_metric_vertical 0.0005 \
    --lambda_metric_size 0.0005 --lambda_metric_score 0.0005 \
    --learning_rate 0.002 --decoder_learning_rate 0.0001 \
    --weight_decay 0.0005 --clip_norm 0.1 \
    "$@"
