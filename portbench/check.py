"""What every model's comparison with its plain reference shares: the
relative gap of two tensors, the TF32 and bfloat16-sum switches, the
half-batch fault, the norms of each leaf and of each leaf's change, the
generator's digest, and the gap arithmetic over leaves. Each model's own
check (`reference/<model>_check.py`, found through `harness.find_model`)
makes its weights and its reference, computes the numbers that its cells'
`limits/*.json` name, and uses these. Nothing here imports the program.

Train numbers by the worst leaf: | |program| - |reference| | over the larger
of the reference leaf's norm and the median leaf's (`leaf_gaps`);
parameter leaves whose reference gradient is under ROUNDOFF_LEAF of the
median leaf's move by round-off under Adam (a key's bias under softmax)
and are left out of the change (`change_gaps`' `moving`).
"""
from __future__ import annotations

import contextlib
import hashlib
from typing import Dict, List, Mapping, Optional

import torch

ROUNDOFF_LEAF = 1e-3


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().double(), want.detach().double()
    scale = float(want.abs().max()) if want.numel() else 0.0
    diff = float((got - want).abs().max()) if want.numel() else 0.0
    return diff / scale if scale > 0 else diff


@contextlib.contextmanager
def tf32(on: bool):
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = m.allow_tf32, c.allow_tf32
    m.allow_tf32 = c.allow_tf32 = on
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = saved


def bf16_sums_in_f32():
    """cuBLAS sums bfloat16 products in float32 (as the program asks)."""
    m = torch.backends.cuda.matmul
    m.allow_bf16_reduced_precision_reduction = False


def half(batch: Optional[Mapping]) -> Optional[Dict]:
    """The fault 'half of the batch left out': the batch's first
    B - B // 2 rows."""
    if batch is None:
        return None
    n = next(iter(batch.values())).shape[0]
    return {k: v[:n - n // 2] for k, v in batch.items()}


def as_double(batch: Optional[Mapping]) -> Optional[Dict]:
    if batch is None:
        return None
    return {k: v.double() if v.is_floating_point() else v
            for k, v in batch.items()}


# --- train: the readings of both sides ------------------------------------

def leaf_norms(tensors: Dict) -> Dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    norms = torch.stack([torch.linalg.vector_norm(tensors[n].double())
                         for n in names]).cpu().tolist()
    return dict(zip(names, norms))


def generator_state(gen) -> str:
    """A digest of a generator's state: equal after two runs of steps
    exactly when they drew the same amounts in the same order."""
    return hashlib.sha256(gen.get_state().numpy().tobytes()).hexdigest()


def state_change(model, teacher, initial: Dict) -> Dict[str, Dict]:
    """Norms of each leaf's change from `initial`: the student's and the
    teacher's parameters, and their BatchNorm running statistics."""
    out = {}
    for side, m in (("student", model), ("teacher", teacher)):
        if m is None:
            continue
        out[f"{side}.params"] = leaf_norms(
            {n: p.detach() - initial[n] for n, p in m.named_parameters()})
        out[f"{side}.bn"] = leaf_norms(
            {n: b - initial[n] for n, b in m.named_buffers()
             if n.endswith(("running_mean", "running_var"))})
    return out


def first_update(params_after: Dict, initial: Dict) -> torch.Tensor:
    """Every parameter's change from `initial`, flat, in float64, in the
    parameters' sorted order (`calibrate.py`'s witness)."""
    return torch.cat([(p.detach().double() - initial[n].double()).flatten()
                      for n, p in sorted(params_after.items())])


# --- train: the gaps ------------------------------------------------------

def median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1]
                                                    + v[len(v) // 2])


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              leaves) -> List[float]:
    leaves = list(leaves)
    if not leaves:
        return [0.0]
    med = median([want[n] for n in leaves])
    return [abs(got[n] - want[n]) / max(want[n], med, 1e-30)
            for n in leaves]


def change_gaps(got: Dict, want: Dict, moving) -> tuple:
    """The worst and the median leaf's change gap, each the largest over
    the groups (student, teacher; parameters, BatchNorm statistics)."""
    worst, med = 0.0, 0.0
    for group, ref in want.items():
        leaves = ref if group.endswith(".bn") else [n for n in ref
                                                     if n in moving]
        gaps = leaf_gaps(got[group], ref, leaves)
        worst, med = max(worst, max(gaps)), max(med, median(gaps))
    return worst, med
