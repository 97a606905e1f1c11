"""3DETR-m's weights and the comparison that decides `correct` for its
cells: what the timed path produced, held against the plain reference
(`three_detr_m.py`), which makes the same weights from the seed and reads
the same rooms; and the readings of the control (the reference with its
float32 products on TF32) and of the half-batch fault, which set the
limits. Nothing here imports the program. Eval only: the model serves no
train traffic.

Eval cells: the output of one call of the window (drawn from the seed),
all 16 rooms.
  - `index_mismatch` counts the indices that differ: the pre-encoder's,
    the interim layer's and the queries' FPS picks, and the interim ball
    query's samples. All are decided on coordinates that are copies of the
    rooms' points, so they are exact.
  - `stage_a_gap`: the encoder's output points and features (after the
    pre-encoder, the three masked layers and the interim SA layer),
    recomputed from the rooms.
  - `stage_b_gap`: the projection, the queries, the decoder and all 8
    layers' heads and boxes, recomputed from the program's encoder output
    (its points and features): the largest gap of those end points.
Each gap is max|program - reference| over max|reference| (`check.rel_gap`).

The fault "half of the batch left out" (`half_batch`, put in the program's
place through `harness.run_cell(..., fault=...)`) runs the forward on the
batch's first B - B // 2 rooms and hands them out for the whole batch;
`calibrate.py` reads no such fault for eval cells, so it is read by that
call.
"""
from __future__ import annotations

from typing import Dict

import torch

from portbench import check, weights
from portbench.harness import sub_seed
from portbench.reference.three_detr_m import ThreeDETR

INDEX_KEYS = ("pre_enc_inds", "interim_inds", "interim_ball_inds")
STAGE_A = ("enc_xyz", "enc_features")


def reference_model(cfg: Dict, seed: int, device, tf32: bool = False
                    ) -> ThreeDETR:
    """The reference 3DETR-m at `cfg` on `device`, with the seed's weights
    (`weights.fill`; the Fourier embedding's Gaussian matrix N(0, 1) times
    `gauss_scale` from a stream of its own), in eval mode."""
    with torch.device(device):
        model = ThreeDETR(cfg, tf32=tf32)
    model = weights.fill(model, seed).eval()
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 4))
    with torch.no_grad():
        b = model.pos_embedding.gauss_B
        b.copy_(torch.randn(b.shape, generator=gen, device=device)
                * cfg["gauss_scale"])
    return model


def state_dict(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seed's weights under the published state_dict names."""
    return reference_model(cfg, seed, device).state_dict()


@torch.no_grad()
def judge_eval(ref: ThreeDETR, clouds: torch.Tensor, out) -> Dict[str, float]:
    a = ref.forward_encoder(clouds)
    b = ref.forward_decoder(clouds, out["enc_xyz"], out["enc_features"])
    pairs = [(out[k], a[k]) for k in INDEX_KEYS] + [(out["query_inds"],
                                                     b["query_inds"])]
    return {"index_mismatch": float(sum(int((g.long() != w.long()).sum())
                                        for g, w in pairs)),
            "stage_a_gap": max(check.rel_gap(out[k], a[k]) for k in STAGE_A),
            "stage_b_gap": max(check.rel_gap(out[k], v) for k, v in b.items()
                               if v.is_floating_point())}


def check_eval(cfg: Dict, seed: int, device, clouds, out) -> Dict[str, float]:
    return judge_eval(reference_model(cfg, seed, device), clouds, out)


@torch.no_grad()
def control_eval(cfg: Dict, seed: int, device, clouds) -> Dict[str, float]:
    """The control put in the program's place: the reference with TF32
    products (`cfg['control']` "tf32", the precision below float32)."""
    if cfg["control"] != "tf32":
        raise ValueError(f"3DETR-m has no {cfg['control']!r} control")
    out = reference_model(cfg, seed, device, tf32=True)(clouds)
    return check_eval(cfg, seed, device, clouds, out)


def half_batch(forward, model, clouds):
    """The fault 'half of the batch left out': the forward of the batch's
    first B - B // 2 rooms, handed out for all B (room i answered by room
    i mod (B - B // 2))."""
    n = clouds.shape[0]
    rows = torch.arange(n, device=clouds.device) % (n - n // 2)
    return forward(model, clouds[rows])
