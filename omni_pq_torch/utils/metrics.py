"""Structured metric logging: JSONL + optional TensorBoard.

The port's own copy of `omni_pq_tpu/utils/metrics.py`.

The reference ships a TF1 TensorBoard wrapper that is never wired into its
drivers (utils/tf_logger.py, tf_visualizer.py — SURVEY.md §5.5); here metric
logging is first-class: every scalar goes to a machine-readable JSONL stream
(metrics.jsonl) and, when tensorboardX/tensorboard is importable, to TB
summaries as well.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: str, enable_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(log_dir, "tb"))
            except Exception:
                self._tb = None

    def log(self, step: int, scalars: Dict[str, float],
            prefix: Optional[str] = None):
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            key = f"{prefix}/{k}" if prefix else k
            try:
                rec[key] = float(v)
            except (TypeError, ValueError):
                continue
            if self._tb is not None:
                self._tb.add_scalar(key, rec[key], step)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
