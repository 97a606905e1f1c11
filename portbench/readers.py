"""What the metrics' readers (`metrics/<name>.py`) share. Each reader
takes the run's `harness.Context` and returns a number, or None where the
cell gives it nothing to read (a share of a roofline or a peak is never
reported as 0). The counts are the cell's model's (`counts/<model>.py`):
`forward_flops(cfg, B)`, `step_flops(cfg, B, teacher)`, and the least time
in one forward of B clouds of the point kernels,
`point_kernels_bound_s(cfg, B)`, and of the fused SA-MLP kernel,
`fused_mlp_bound_s(cfg, B, train)`; a bound is None where the model's
forward at `cfg` runs none of the kernel, and its roofline reads nothing."""
from __future__ import annotations

from .peaks import OPS_PER_S

# the program's kernels as torch.profiler names them (chip_smoke.py's
# KERNEL_NAMES at commit 4c1c1dacbb14fd55b2b315e6b58815882cf32f9c)
FPS_KERNELS = r"::fps_kernel\b"
BALL_QUERY_KERNELS = r"::(ball_query|chunk_box)_kernel\b"
FUSED_MLP_KERNELS = (r"::(fused_mlp(_bf16)?|mlp_pass(_bf16)?|mlp_stats"
                     r"(_finish)?|mlp_pool)_kernel\b")


def traced(ctx, kind: str) -> bool:
    return ctx.kind == kind and ctx.trace is not None


def roofline(ctx, kind: str, bound_per_forward, pattern: str):
    """100 x the least time of the traced window's calls over the matching
    kernels' device time; None where nothing matches or the model has no
    bound."""
    if not traced(ctx, kind):
        return None
    bounds = [bound_per_forward(b) for b in ctx.forwards_per_call]
    if None in bounds:
        return None
    spent = ctx.trace.kernel_s(pattern)
    if spent <= 0:
        return None
    bound = ctx.trace.calls * sum(bounds)
    return 100.0 * bound / spent


def point_kernels_roofline(ctx, kind: str):
    counts, cfg = ctx.cell.model.counts, ctx.cell.cfg
    return roofline(ctx, kind,
                    lambda b: counts.point_kernels_bound_s(cfg, b),
                    f"{FPS_KERNELS}|{BALL_QUERY_KERNELS}")


def fused_mlp_roofline(ctx, kind: str):
    counts, cfg = ctx.cell.model.counts, ctx.cell.cfg
    return roofline(ctx, kind,
                    lambda b: counts.fused_mlp_bound_s(cfg, b,
                                                       kind == "train"),
                    FUSED_MLP_KERNELS)


def mfu(ctx, kind: str):
    """100 x the model FLOPs of the measured window's calls over its
    length, at the configuration's compute dtype's peak."""
    if ctx.kind != kind or ctx.trace is None or ctx.window.seconds <= 0:
        return None
    cfg, counts = ctx.cell.cfg, ctx.cell.model.counts
    if kind == "eval":
        per_call = counts.forward_flops(cfg, ctx.batch)
    else:
        per_call = counts.step_flops(
            cfg, ctx.batch, len(ctx.forwards_per_call) > 1)
    return 100.0 * per_call * ctx.window.calls / (
        ctx.window.seconds * OPS_PER_S[cfg["compute_dtype"]])


def idle_share(ctx, kind: str):
    if not traced(ctx, kind):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def launches(ctx, kind: str):
    if not traced(ctx, kind):
        return None
    return ctx.trace.launches / ctx.trace.calls
