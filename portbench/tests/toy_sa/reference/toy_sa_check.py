"""The test-only model's weights and check: a plain reference of one
set-abstraction layer (the reference's FPS and ball query, the relative
xyz over the radius, 1x1 convolutions with eval-mode BatchNorm and ReLU,
the max over the samples), the max over the centres and the linear head,
under the program's parameter names. `index_mismatch` counts the FPS
indices that differ, `out_gap` is the largest relative gap of the pooled
features and the logits."""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from portbench import check, weights
from portbench.reference import ops


class _Layer(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Module()
        self.conv.weight = nn.Parameter(torch.empty(cout, cin, 1, 1))
        self.bn = nn.Module()
        self.bn.bn = nn.BatchNorm1d(cout, eps=1e-5)


class ToySA(nn.Module):
    def __init__(self, cfg: Dict, low: bool = False):
        super().__init__()
        self.cfg, self.low = cfg, low
        chans = [3] + list(cfg["mlp"])
        self.sa = nn.Module()
        self.sa.mlp_module = nn.Module()
        for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
            self.sa.mlp_module.add_module(f"layer{i}", _Layer(cin, cout))
        self.head = nn.Linear(chans[-1], cfg["num_out"])

    @torch.no_grad()
    def forward(self, pc):
        cfg = self.cfg
        xyz = pc[..., :3]
        inds = ops.fps(xyz, cfg["npoint"])
        centres = ops.gather_points(xyz, inds)
        idx = ops.ball_query(cfg["radius"], cfg["nsample"], xyz, centres)
        x = (ops.group_points(xyz, idx) - centres[:, :, None, :]) \
            / cfg["radius"]
        for layer in self.sa.mlp_module.children():
            bn = layer.bn.bn
            x = ops.matmul(x, layer.conv.weight.flatten(1).T, self.low)
            x = torch.relu((x - bn.running_mean) * (
                torch.rsqrt(bn.running_var + bn.eps) * bn.weight) + bn.bias)
        features = x.amax(dim=2)
        logits = ops.matmul(features.amax(dim=1), self.head.weight.T,
                            self.low) + self.head.bias
        return {"inds": inds, "features": features, "logits": logits}


def reference_model(cfg: Dict, seed: int, device, low: bool = False):
    with torch.device(device):
        model = ToySA(cfg, low=low)
    return weights.fill(model, seed).eval()


def state_dict(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return reference_model(cfg, seed, device).state_dict()


def judge_eval(want, out) -> Dict[str, float]:
    return {"index_mismatch": float(
        (want["inds"].long() != out["inds"].long()).sum()),
        "out_gap": max(check.rel_gap(out[k], want[k])
                       for k in ("features", "logits"))}


def check_eval(cfg: Dict, seed: int, device, clouds, out) -> Dict[str, float]:
    with check.tf32(False):
        return judge_eval(reference_model(cfg, seed, device)(clouds), out)


def control_eval(cfg: Dict, seed: int, device, clouds) -> Dict[str, float]:
    """The reference with every product's operands in float8 e4m3."""
    out = reference_model(cfg, seed, device, low=True)(clouds)
    return check_eval(cfg, seed, device, clouds, out)
