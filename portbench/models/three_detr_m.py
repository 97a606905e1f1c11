"""3DETR-m's program side: the port's model loaded from the seeded
state_dict through its own entry point (`infer.load_model` with the
configuration's `ThreeDETRConfig`) and the timed eval call
(`infer.eval_forward`). The benchmark's only code besides the harness and
the PQ-Transformer's program side that imports the program
(`omni_pq_torch`): it imports it when a cell is built, never when this file
is loaded.

Traffic kinds: "eval" (closed loop of `infer.eval_forward` on batches of
`batch` rooms).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

from portbench.harness import sync

KINDS = ("eval",)


def model_fields(cfg: Dict) -> Dict:
    """The configuration's ThreeDETRConfig fields (tuples where the
    dataclass holds tuples). The keys the port holds at one value
    (`compute_dtype`, `num_angle_bin`, `dec_dim`) must hold it."""
    from omni_pq_torch.config import ThreeDETRConfig
    from omni_pq_torch.models.three_detr import ThreeDETR
    fixed = {"compute_dtype": ThreeDETRConfig.compute_dtype,
             "num_angle_bin": ThreeDETR.NUM_ANGLE_BIN,
             "dec_dim": cfg.get("enc_dim")}
    for key, value in fixed.items():
        if cfg.get(key, value) != value:
            raise ValueError(f"three_detr_m: {key} {cfg[key]!r}, the port "
                             f"holds {value!r}")
    names = {f.name for f in dataclasses.fields(ThreeDETRConfig)}
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in cfg.items() if k in names}


def forwards_per_call(traffic: Dict) -> List[int]:
    return [traffic["batch"]]


class System:
    """The port's ThreeDETR on one cell. `fault`, where given, takes the
    timed call's place: `fault(eval_forward, model, clouds)`."""

    def __init__(self, cell, seed: int, device, sd, fault, marks):
        from omni_pq_torch import infer
        from omni_pq_torch.config import ThreeDETRConfig
        self.fault = fault
        self.model = infer.load_model(
            sd, ThreeDETRConfig(**model_fields(cell.cfg)), device)
        sync(device)
        marks.append(("model", time.perf_counter()))

    def call(self, entry: Dict):
        """One eval forward on a pool entry: its end points."""
        from omni_pq_torch import infer
        pc = entry["point_clouds"]
        if self.fault is not None:
            return self.fault(infer.eval_forward, self.model, pc)
        return infer.eval_forward(self.model, pc)

    def free(self):
        del self.model
