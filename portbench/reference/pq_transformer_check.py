"""The PQ-Transformer's weights and the comparison that decides `correct`
for its cells: what the timed path produced, held against the plain
reference (`pq_transformer.py`, `pq_transformer_train.py`), which makes
the same weights from the seed and reads the same rooms; and the readings
of the control (the reference in the precision below the configuration's)
and of the faults, which `calibrate.py` takes to set the limits. Nothing
here imports the program.

Eval cells: the output of one call of the window (drawn from the seed),
all 16 rooms. Stage A, the backbone and the voting, is recomputed from the
rooms: `index_mismatch` counts the sampling indices that differ (sa1,
sa2, the seeds: exact), `stage_a_gap` is the largest gap of the floating
end points (sa1-sa4 coordinates and features, the FP2 seed features, the
votes), each as max|program - reference| over max|reference|. Stage B, the
vote aggregation, the quad queries and the decoder with its heads, is
recomputed twice. `stage_b_own_gap` runs it from the reference's own
stage A, so that the reference takes nothing the program made.
`stage_b_gap` runs it from the program's seeds and votes, which stage A
has judged: its sampling then takes the same points on both sides, where
votes a rounding apart could pick another point at a near-tie and show as
a fault that is none. Each is the largest gap of stage B's end points;
`pred_size` keys (a gather at the argmax of the size scores, which are
compared) are left out. PERF.md says which a cell compares.

Train cells: the first CHECK_STEPS steps of the program, through the
window's call on the pool's first batches, against the same steps of the
reference with the same generator draws: `loss_gap` the largest relative
gap of a step's total loss; `grad_gap` and `change_gap` by the worst leaf
(`portbench/check.py`): the first gradient as AdamW got it, and the change
after the last step of the student's and the teacher's parameters and
their BatchNorm running statistics.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch

from portbench import check, weights
from portbench.harness import sub_seed
from portbench.reference.pq_transformer import PQTransformer, STAGE_A_INPUTS
from portbench.reference.pq_transformer_train import Trainer

STAGE_A_FLOAT = tuple([f"sa{i}_{k}" for i in range(1, 5)
                       for k in ("xyz", "features")]
                      + ["fp2_features", "vote_xyz", "vote_features"])
INDEX_KEYS = ("sa1_inds", "sa2_inds", "fp2_inds")


# --- weights ----------------------------------------------------------------

def reference_model(cfg: Dict, seed: int, device, low: bool = False
                    ) -> PQTransformer:
    """The reference PQ-Transformer at `cfg` on `device`, with the seed's
    weights, in eval mode (held in float64 where `cfg` computes in it)."""
    with torch.device(device):
        model = PQTransformer(cfg, low=low)
    model = weights.fill(model, seed).eval()
    return model.double() if cfg["compute_dtype"] == "float64" else model


def state_dict(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seed's weights under the published state_dict names."""
    return reference_model(cfg, seed, device).state_dict()


# --- eval -----------------------------------------------------------------

@torch.no_grad()
def judge_eval(ref, clouds: torch.Tensor, out: Mapping) -> Dict[str, float]:
    a = ref.forward_stage_a(clouds)
    numbers = {"index_mismatch": float(sum(
        int((a[k].long() != out[k].long()).sum()) for k in INDEX_KEYS)),
        "stage_a_gap": max(check.rel_gap(out[k], a[k])
                           for k in STAGE_A_FLOAT)}
    for name, inputs in (("stage_b_own_gap", a), ("stage_b_gap", out)):
        b = ref.forward_heads({k: inputs[k] for k in STAGE_A_INPUTS})
        numbers[name] = max(
            check.rel_gap(out[k], v) for k, v in b.items()
            if v.is_floating_point() and not k.endswith("pred_size"))
        del b
    return numbers


def check_eval(cfg: Dict, seed: int, device, clouds, out) -> Dict[str, float]:
    check.bf16_sums_in_f32()
    with check.tf32(False):
        ref = reference_model(cfg, seed, device)
        return judge_eval(ref, clouds, out)


@torch.no_grad()
def control_eval(cfg: Dict, seed: int, device, clouds) -> Dict[str, float]:
    """The control put in the program's place: the reference in the
    precision below the configuration's (`cfg['control']`: "tf32", float32
    products on TF32; "fp8", every product's operands in float8 e4m3)."""
    check.bf16_sums_in_f32()
    low = reference_model(cfg, seed, device, low=cfg["control"] == "fp8")
    with check.tf32(cfg["control"] == "tf32"):
        out = low.forward_stage_a(clouds)
        out.update(low.forward_heads(out))
    del low
    return check_eval(cfg, seed, device, clouds, out)


# --- train ----------------------------------------------------------------

def reference_readings(cfg: Dict, traffic: Dict, seed: int, device,
                       batches: List[Mapping], low: bool = False,
                       fault: Optional[str] = None,
                       float64: bool = False) -> Dict:
    """The reference's first steps on `batches` with the run's generator
    seed: each step's loss, the first clipped gradient by leaf, the change
    after the first step and after the last, the generator's state after
    each step. `low`: the control; `fault` "half": the half-batch fault;
    `float64`: every product and sum in float64 (a witness, not a check)."""
    check.bf16_sums_in_f32()
    flags = traffic["flags"]
    for off in ("arkit", "use_fitted_mixture", "teacher_bf16"):
        if flags.get(off):
            raise ValueError(f"the reference has no {off}")
    if float64:
        cfg = {**cfg, "compute_dtype": "float64"}
    model = reference_model(cfg, seed, device,
                            low=low and cfg["control"] == "fp8")
    trainer = Trainer(model, traffic["optimizer"], flags)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 3))
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    losses, grad, first_change, draws = [], None, None, []
    with check.tf32(low and cfg["control"] == "tf32"):
        for k, entry in enumerate(batches):
            lab, weak = entry["labeled"], entry.get("weak")
            if fault == "half":
                lab, weak = check.half(lab), check.half(weak)
            if float64:
                lab, weak = check.as_double(lab), check.as_double(weak)
            losses.append(trainer.step(lab, weak, gen,
                                       traffic["consistency_weight"]))
            draws.append(check.generator_state(gen))
            if k == 0:
                first_vote = float(trainer.parts["vote"])
                grad = check.leaf_norms(trainer.clipped_grads)
                with torch.no_grad():
                    first_change = check.state_change(model, trainer.teacher,
                                                      initial)
    with torch.no_grad():
        change = check.state_change(model, trainer.teacher, initial)
    return {"losses": losses, "grad": grad, "change": change,
            "first_change": first_change, "draws": draws,
            "first_vote_loss": first_vote}


def judge_train(got: Dict, want: Dict) -> Dict[str, float]:
    """Every number a train cell may compare; its limits file names those
    it does. `first_loss_gap` is the first step's alone, `loss_gap` the
    largest over the steps, `first_vote_loss_gap` the first step's vote
    loss (the backbone and the voting, before any sampling of votes or
    threshold on them); `first_change_gap` the worst leaf's change
    after the first step, `change_gap` after the last, and
    `median_change_gap` the median leaf's then; `median_grad_gap` the
    median leaf's gradient gap; `draws_mismatch` the steps after which the
    generator's state differs. PERF.md says which are steady enough to
    compare: the later steps carry the noise of the rounding."""
    loss = [abs(g - w) / max(abs(w), 1e-30)
            for g, w in zip(got["losses"], want["losses"])]
    g_med = check.median(want["grad"].values())
    moving = {n for n, v in want["grad"].items()
              if v >= check.ROUNDOFF_LEAF * g_med}
    change, median_change = check.change_gaps(got["change"], want["change"],
                                              moving)
    first_change, _ = check.change_gaps(got["first_change"],
                                        want["first_change"], moving)
    grad = check.leaf_gaps(got["grad"], want["grad"], want["grad"])
    vote = abs(got["first_vote_loss"] - want["first_vote_loss"]) / max(
        abs(want["first_vote_loss"]), 1e-30)
    return {"loss_gap": max(loss), "first_loss_gap": loss[0],
            "first_vote_loss_gap": vote,
            "grad_gap": max(grad), "median_grad_gap": check.median(grad),
            "first_change_gap": first_change, "change_gap": change,
            "median_change_gap": median_change,
            "draws_mismatch": float(sum(
                a != b for a, b in zip(got["draws"], want["draws"])))}


def check_train(cfg: Dict, traffic: Dict, seed: int, device,
                batches: List[Mapping], got: Dict) -> Dict[str, float]:
    with check.tf32(False):
        want = reference_readings(cfg, traffic, seed, device, batches)
    return judge_train(got, want)


def reference_first_update(cfg: Dict, traffic: Dict, seed: int, device,
                           entry: Mapping, f64: bool):
    """The reference's parameter update of the first step alone (the flat
    vector, in float64) and its supervised loss terms (`calibrate.py`'s
    witness)."""
    cfg = {**cfg, "compute_dtype": "float64"} if f64 else cfg
    model = reference_model(cfg, seed, device)
    trainer = Trainer(model, traffic["optimizer"], traffic["flags"])
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 3))
    initial = {n: p.detach().clone() for n, p in model.named_parameters()}
    lab, weak = entry["labeled"], entry.get("weak")
    if f64:
        lab, weak = check.as_double(lab), check.as_double(weak)
    trainer.step(lab, weak, gen, traffic["consistency_weight"])
    return (check.first_update(dict(model.named_parameters()), initial),
            {k: float(v) for k, v in trainer.parts.items()})
