"""The PQ-Transformer's program side: the port's model loaded from the
seeded state_dict through its own entry point (`infer.load_model` with the
configuration's `ModelConfig`), the timed eval call (`infer.eval_forward`)
and, for a train cell, the port's `TrainState` and the step of
`make_train_step` with the traffic's `TrainFlags`. The benchmark's only
code besides the harness that imports the program (`omni_pq_torch`): it
imports it when a cell is built, never when this file is loaded.

Traffic kinds: "eval" (closed loop of `infer.eval_forward` on batches of
`batch` rooms) and "train" (closed loop of the step on `labeled` + `weak`
rooms with the traffic's `flags`, `consistency_weight` and `optimizer`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

from portbench import check
from portbench.harness import CHECK_STEPS, sub_seed, sync

KINDS = ("eval", "train")

# the step's supervised loss terms: the reference's name -> the program's
# stats key (`calibrate.py`'s witness)
PARTS = {"vote": "vote_loss", "objectness": "objectness_loss",
         "box": "box_loss", "sem": "sem_cls_loss_sum",
         "quad_score": "quad_score_loss_sum",
         "quad_geometry": "quad_loss_sum",
         "pc": "physical_constraints_loss"}


def model_fields(cfg: Dict) -> Dict:
    """The configuration's ModelConfig fields (tuples where the dataclass
    holds tuples)."""
    from omni_pq_torch.config import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in cfg.items() if k in names}


def forwards_per_call(traffic: Dict) -> List[int]:
    """The batch of each model forward in one call: a train step with an
    EMA teacher runs two."""
    if traffic["kind"] == "eval":
        return [traffic["batch"]]
    batch = traffic["labeled"] + traffic["weak"]
    return [batch] * (2 if traffic["flags"].get("ema", True) else 1)


class System:
    """The port's PQ-Transformer on one cell (and, for a train cell, its
    TrainState and step). `fault`, where given, takes the timed call's
    place: `fault(eval_forward, model, clouds)` or `fault(step, state,
    labeled, weak, generator, consistency_weight)`."""

    def __init__(self, cell, seed: int, device, sd, fault, marks):
        import torch
        from omni_pq_torch import infer
        from omni_pq_torch.config import ModelConfig
        self.cell, self.kind, self.fault = cell, cell.traffic["kind"], fault
        self.mc = ModelConfig(**model_fields(cell.cfg))
        self.model = infer.load_model(sd, self.mc, device)
        sync(device)
        marks.append(("model", time.perf_counter()))
        if self.kind == "train":
            from omni_pq_torch.config import DatasetConfig
            from omni_pq_torch.train.state import OptimizerConfig, TrainState
            from omni_pq_torch.train.step import TrainFlags, make_train_step
            flags = TrainFlags(**cell.traffic["flags"])
            self.state = TrainState(
                self.model, OptimizerConfig(**cell.traffic["optimizer"]),
                ema=flags.ema)
            self.step_fn = make_train_step(self.model, self.mc,
                                           DatasetConfig().mean_size_arr,
                                           flags)
            self.gen = torch.Generator(device=device).manual_seed(
                sub_seed(seed, 3))
            self.initial = {k: v.detach().clone() for k, v in sd.items()}
            marks.append(("train state", time.perf_counter()))

    def call(self, entry: Dict):
        """One call of the timed entry point on a pool entry: the eval
        forward's end points, or the train step's stats."""
        from omni_pq_torch import infer
        if self.kind == "eval":
            pc = entry["point_clouds"]
            if self.fault is not None:
                return self.fault(infer.eval_forward, self.model, pc)
            return infer.eval_forward(self.model, pc)
        labeled, weak = entry["labeled"], entry.get("weak")
        step = self.step_fn
        if self.fault is not None:
            return self.fault(step, self.state, labeled, weak, self.gen,
                              self.cell.traffic["consistency_weight"])
        return step(self.state, labeled, weak, self.gen,
                    self.cell.traffic["consistency_weight"])

    @staticmethod
    def loss(stats: Dict):
        """A train call's total loss (a tensor on the device)."""
        return stats["total_loss"]

    @staticmethod
    def parts(stats: Dict) -> Dict[str, float]:
        """A train call's supervised loss terms under the reference's
        names."""
        return {k: float(stats[v]) for k, v in PARTS.items()}

    def first_steps(self, call) -> Dict:
        """Train: the first CHECK_STEPS steps through the window's own call
        (`call()`, which takes the pool's next batch), with the readings the
        reference is held to: each step's loss (and the first step's vote
        loss, which no sampling of votes reaches), each leaf's first
        gradient as AdamW got it (mu / (1 - b1) after one step), each leaf's
        change after the first step and after the last (student and teacher
        parameters, BatchNorm running statistics), and the generator's state
        after each step."""
        import torch
        losses, grad, first_change, draws = [], None, None, []
        for k in range(CHECK_STEPS):
            stats = call()
            losses.append(float(stats["total_loss"]))
            draws.append(check.generator_state(self.gen))
            if k == 0:
                first_vote = float(stats["vote_loss"])
                opt = self.state.optimizer
                grad = check.leaf_norms(
                    {n: opt.state[p]["mu"] / 0.1
                     for n, p in self.model.named_parameters()
                     if "mu" in opt.state[p]})
                with torch.no_grad():
                    first_change = check.state_change(
                        self.model, self.state.ema_model, self.initial)
        with torch.no_grad():
            change = check.state_change(self.model, self.state.ema_model,
                                        self.initial)
        del self.initial
        return {"losses": losses, "grad": grad, "change": change,
                "first_change": first_change, "draws": draws,
                "first_vote_loss": first_vote}

    def free(self):
        for name in ("model", "state", "step_fn", "gen"):
            if hasattr(self, name):
                delattr(self, name)
