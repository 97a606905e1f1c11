#!/usr/bin/env bash
# Evaluation at the reference regime (eval.sh:9-13) with the PyTorch port,
# on the card: bs 16, quad NMS IoU 0.25, corner-match threshold 0.40m. The
# command line of scripts/eval.sh, pointed at omni_pq_torch.cli.eval; the
# checkpoint is a port .pth (scripts/orbax_to_pth.py converts a JAX one).
# Usage: scripts/eval_torch.sh <checkpoint.pth> <data_root> [extra flags...]
set -e
CKPT=${1:?checkpoint path required}
DATA_ROOT=${2:-data/scannet}
shift 2 || true
python -m omni_pq_torch.cli.eval \
    --checkpoint_path "$CKPT" \
    --data_root "$DATA_ROOT" \
    --batch_size 16 \
    --nms_iou_quad 0.25 \
    "$@"
