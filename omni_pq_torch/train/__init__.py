"""Training of the port: the supervised train step, the optimiser and its
schedule, the EMA replica."""
from .schedule import warmup_cosine, consistency_weight
from .state import AdamW, OptimizerConfig, TrainState, global_norm
from .step import (SUPERVISED, TrainFlags, batch_to_tensors, make_eval_step,
                   make_train_step)

__all__ = [
    "warmup_cosine", "consistency_weight", "AdamW", "OptimizerConfig",
    "TrainState", "global_norm", "SUPERVISED",
    "TrainFlags", "batch_to_tensors", "make_eval_step", "make_train_step",
]
