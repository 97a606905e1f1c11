"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit), as `chip_smoke.py` took
them at commit 4c1c1dacbb14fd55b2b315e6b58815882cf32f9c. A card set below
700 W runs slower under load: every run prints the card's power limit."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12      # float32 outside the tensor cores (TF32 off)
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12    # bfloat16 on the tensor cores

# the peak of each compute dtype a configuration may state
OPS_PER_S = {"float32": F32_OPS_PER_S, "bfloat16": BF16_OPS_PER_S}


def bound_s(nbytes: float, nops: float, ops_per_s: float) -> float:
    """The least time the work can take: the larger of its bytes over the
    memory bandwidth and its operations over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, nops / ops_per_s)
