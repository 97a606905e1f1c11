"""A test-only model's program side: one set-abstraction layer of the
port (`SAModuleVotes`: FPS, the ball query, the shared MLP, the max over
the samples), a max over the centres and a linear head. Serves eval
traffic only. `portbench/tests/test_portbench_harness.py` copies it, with
its check, counts, configuration, traffic and limits, into a copy of the
benchmark to show that a second model comes in as new files."""
from __future__ import annotations

import time
from typing import Dict, List

import torch

from portbench.harness import sync

KINDS = ("eval",)


def forwards_per_call(traffic: Dict) -> List[int]:
    return [traffic["batch"]]


class ToySA(torch.nn.Module):
    def __init__(self, cfg: Dict):
        from omni_pq_torch.models.pointnet2 import SAModuleVotes
        super().__init__()
        self.sa = SAModuleVotes(cfg["npoint"], cfg["radius"], cfg["nsample"],
                                0, cfg["mlp"], normalize_xyz=True)
        self.head = torch.nn.Linear(cfg["mlp"][-1], cfg["num_out"])

    @torch.no_grad()
    def forward(self, pc):
        _, features, inds = self.sa(pc[..., :3].contiguous())
        return {"inds": inds, "features": features,
                "logits": self.head(features.amax(dim=1))}


def forward(model, pc):
    return model(pc)


class System:
    def __init__(self, cell, seed: int, device, sd, fault, marks):
        self.model = ToySA(cell.cfg).to(device)
        self.model.load_state_dict(sd)
        self.model.eval()
        self.fault = fault
        sync(device)
        marks.append(("model", time.perf_counter()))

    def call(self, entry: Dict):
        pc = entry["point_clouds"]
        if self.fault is not None:
            return self.fault(forward, self.model, pc)
        return forward(self.model, pc)

    def free(self):
        del self.model
