"""Fused SharedMLP (Dense -> BN -> ReLU chain) + K max-pool of an SA layer:
the hand-written CUDA kernel and its plain version.

`fused_mlp_pool` takes the plain version for tensors on the CPU and launches
the CUDA kernel (`omni_pq_torch/csrc/fused_mlp.cu`) for tensors on the card,
at every shape: there is no size threshold and no fallback. It replaces the
JAX package's Pallas kernel `omni_pq_tpu/ops/fused_mlp.py::_make_kernel`
(the train-mode and eval-mode calls of `_forward_pallas`), entry point
`fused_mlp_pool`, gated by `supports`.

Numerics, layer by layer (the flax SharedMLP chain of the JAX package):
  a   = x @ W                                   float32
  mu, var = batch stats of a (train) or the running stats (eval);
            var = max(0, E[a^2] - E[a]^2)      flax's fast variance
  mul = rsqrt(var + eps) * scale                once, in torch, for both
  x   = relu((a - mu) * mul + bias)
then the max over the K neighbours. The kernel sums each product in its own
order (k ascending, one fma at a time), so it agrees with the plain version
(cuBLAS on the card) to float32 roundoff, not bitwise; the BN arithmetic
after the product is the same rounding step by step.

In train mode the kernel runs the chain once, as L GEMM passes (the pass
plan, `pass_plan`): pass j reads the grouped rows (j = 0) or the stored
pre-activation a_j, normalised with layer j's finished batch stats as it is
loaded, and writes a_{j+1} and its column sums; a stats launch after each
pass reduces the sums in a fixed order (two runs give bitwise the same
stats). Where C0 is tiny (sa1: xyz only) a_1 is not stored: pass 1
recomputes it from the grouped rows. The last pass writes the max and the
min of a_L over each centre's rows, and a pool launch takes the BN + ReLU of
the max where the BN multiplier is >= 0 and of the min where it is < 0:
bitwise the max over the rows of the BN + ReLU, since that map is monotone.

The backward recomputes the plain chain under autograd and backpropagates
through it (the JAX package's `_fused_bwd`); running statistics get no
gradient.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import ctypes

import torch

from . import cuda

# the CUDA kernel's limits: at most this many layers, and 256 threads a block
MAX_LAYERS = 8
# the pass plan recomputes a_1 from the grouped rows where C0 is at most this
# (C0 FMAs an element instead of a stored C1-wide row; the kernel holds up
# to 4 input channels a row for it)
RECOMPUTE_MAX_C0 = 4
_LANE = 128


def supports(K: int, channels: Sequence[int], dtype) -> bool:
    """The JAX package's gate, kept as the routing rule so that the same SA
    layers fuse in both packages: float32, K a multiple of 8 and every
    channel width a multiple of 128 (vote_aggregation's 288 stays unfused).
    The kernel itself needs K % 8 == 0 (a thread's 8 rows lie in one
    centre)."""
    return (dtype == torch.float32 and K % 8 == 0 and len(channels) <= MAX_LAYERS
            and all(c % _LANE == 0 for c in channels))


def bn_mul(var: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The per-channel BN multiplier rsqrt(var + eps) * scale, computed once
    in torch for both the kernel and the plain version."""
    return torch.rsqrt(var + eps) * scale


def plain_mlp_pool(grouped, weights, scales, biases, ra_means, ra_vars,
                   train: bool, eps: float):
    """The plain version: the SharedMLP chain + K max-pool as tensor ops.

    grouped (B, S, K, C0); weights[i] (C_{i-1}, C_i); scales/biases (C_i,);
    ra_* are used when not `train`. Returns (pooled (B, S, C_L), means,
    vars): the batch statistics of every layer (train) or () (eval)."""
    x = grouped
    means, variances = [], []
    for i, w in enumerate(weights):
        a = torch.matmul(x, w)
        if train:
            mu = a.mean(dim=(0, 1, 2))
            mu2 = (a * a).mean(dim=(0, 1, 2))
            var = torch.clamp_min(mu2 - mu * mu, 0.0)
            means.append(mu)
            variances.append(var)
        else:
            mu, var = ra_means[i], ra_vars[i]
        x = torch.relu((a - mu) * bn_mul(var, scales[i], eps) + biases[i])
    return x.amax(dim=2), tuple(means), tuple(variances)


def fused_mlp_pool_plain(grouped, weights, scales, biases, ra_means=(),
                         ra_vars=(), *, train: bool, eps: float = 1e-5):
    """`fused_mlp_pool`'s signature over the plain version on any device
    (autograd straight through the tensor ops)."""
    return plain_mlp_pool(grouped, weights, scales, biases, ra_means, ra_vars,
                          train, eps)


class Pass(NamedTuple):
    """One GEMM pass of the train mode: a_{layer+1} = h_layer @ W_layer."""
    layer: int
    source: str      # "x": the grouped rows; "a": the stored a_layer, BN +
                     # ReLU on load; "x@W0": a_1 recomputed from the rows
    store: bool      # writes a_{layer+1} to a scratch tensor
    extremes: bool   # the last pass: max and min of a_L over each centre


def pass_plan(chans: Sequence[int]) -> list[Pass]:
    """The train mode's passes for widths [C0, C1, ..., CL]: one a layer,
    each launch followed by a stats launch, then the pool launch."""
    L = len(chans) - 1
    recompute = L >= 2 and chans[0] <= RECOMPUTE_MAX_C0
    plan = []
    for j in range(L):
        source = "x" if j == 0 else ("x@W0" if j == 1 and recompute else "a")
        plan.append(Pass(j, source, store=j < L - 1 and not (
            j == 0 and recompute), extremes=j == L - 1))
    return plan


def plan_costs(chans: Sequence[int], rows: int) -> tuple[int, int]:
    """(operations, scratch bytes) of the pass plan over `rows` rows: 2 a
    multiply-add of every pass, the recompute included, and the most bytes
    of stored pre-activations alive at once (a pass's input and output)."""
    ops_n, peak = 0, 0
    for p in pass_plan(chans):
        j = p.layer
        ops_n += 2 * rows * chans[j] * chans[j + 1]
        if p.source == "x@W0":
            ops_n += 2 * rows * chans[0] * chans[1]
        alive = ((chans[j] if p.source == "a" else 0)
                 + (chans[j + 1] if p.store else 0))
        peak = max(peak, 4 * rows * alive)
    return ops_n, peak


def _check(grouped, weights, scales, biases, ra_means, ra_vars, train):
    cuda.check_cuda_tensor("fused_mlp grouped", grouped, torch.float32, 4)
    L = len(weights)
    if not 1 <= L <= MAX_LAYERS:
        raise ValueError(f"fused_mlp: 1..{MAX_LAYERS} layers, got {L}")
    K = grouped.shape[2]
    cin = grouped.shape[3]
    chans = [cin]
    for i, w in enumerate(weights):
        cuda.check_cuda_tensor(f"fused_mlp weight {i}", w, torch.float32, 2)
        if w.shape[0] != cin or w.shape[1] % 4 or w.device != grouped.device:
            raise ValueError(f"fused_mlp: weight {i} of shape "
                             f"{tuple(w.shape)} on {w.device} after width "
                             f"{cin}; widths must be multiples of 4")
        cin = w.shape[1]
        chans.append(cin)
        vecs = [scales[i], biases[i]] + (
            [] if train else [ra_means[i], ra_vars[i]])
        for v in vecs:
            cuda.check_cuda_tensor(f"fused_mlp layer {i} vector", v,
                                   torch.float32, 1, last=cin)
        if w.data_ptr() % 16:
            raise ValueError(f"fused_mlp: weight {i} is not 16-byte aligned")
    if K % 8:
        raise ValueError(f"fused_mlp kernel takes K % 8 == 0, got K={K}")
    if grouped.shape[0] * grouped.shape[1] == 0:
        raise ValueError("fused_mlp: empty input")
    if not train:  # the eval kernel holds a tile's chain in shared memory
        _, _, lib = cuda.library("fused_mlp")
        smem_bytes = lib.fused_mlp_smem_bytes
        smem_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        smem_bytes.restype = ctypes.c_longlong
        c_chans = (ctypes.c_int * len(chans))(*chans)
        need = smem_bytes(ctypes.cast(c_chans, ctypes.c_void_p), L, K)
        if need > cuda.MAX_SHARED_BYTES:
            raise ValueError(f"fused_mlp: K={K} and widths {chans} need "
                             f"{need} bytes of shared memory a block, more "
                             f"than {cuda.MAX_SHARED_BYTES}")
    return chans


def pass_tile(K: int) -> tuple[int, int]:
    """(rows a pass tile, rows a max/min segment) of the train mode's
    kernel for K neighbours, read from the built library: a tile holds
    whole segments, a segment the K rows of a centre (K <= 128) or an
    equal part of them."""
    _, _, lib = cuda.library("fused_mlp")
    fn = lib.mlp_pass_tile
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    if fn(K, ctypes.cast(out, ctypes.c_void_p)) != 0:
        raise ValueError(f"fused_mlp: no pass tile for K={K}")
    return out[0], out[1]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _eval_launch(grouped, weights, biases, mus, muls, pooled):
    B, S, K, C0 = grouped.shape
    chans = [C0] + [w.shape[1] for w in weights]
    ptrs = []
    for w, mu, mul, b in zip(weights, mus, muls, biases):
        ptrs += [w.data_ptr(), mu.data_ptr(), mul.data_ptr(), b.data_ptr()]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_chans = (ctypes.c_int * len(chans))(*chans)
    cuda.launch("fused_mlp", grouped.device, grouped.data_ptr(),
                pooled.data_ptr(), ctypes.cast(c_ptrs, ctypes.c_void_p),
                ctypes.cast(c_chans, ctypes.c_void_p), len(weights),
                B * S * K, K)


def _train_launches(grouped, weights, scales, biases, eps, pooled):
    """The pass plan on the card: L passes, L stats launches and the pool
    launch. Scratch (stored pre-activations, column sums, extremes) comes
    from torch.empty and is freed as soon as no later launch reads it.
    Returns the batch means and variances."""
    dev = grouped.device
    B, S, K, C0 = grouped.shape
    chans = [C0] + [w.shape[1] for w in weights]
    rows = B * S * K
    tile_rows, seg = pass_tile(K)
    tiles = -(-rows // tile_rows)
    empty = lambda *shape: torch.empty(  # noqa: E731
        *shape, dtype=torch.float32, device=dev)
    means, variances, muls = [], [], []
    a = ext = None
    for p in pass_plan(chans):
        j, cout = p.layer, chans[p.layer + 1]
        out = empty(rows, cout) if p.store else None
        ext = (empty(rows // seg, cout), empty(rows // seg, cout)) \
            if p.extremes else (None, None)
        psum = empty(tiles, 2, cout)
        bn = (means[j - 1], muls[j - 1], biases[j - 1]) if j else (None,) * 3
        cuda.launch("fused_mlp", dev, _ptr(a if p.source == "a" else grouped),
                    _ptr(weights[0] if p.source == "x@W0" else None),
                    C0 if p.source == "x@W0" else 0, *map(_ptr, bn),
                    weights[j].data_ptr(), chans[j], cout, rows, K, _ptr(out),
                    _ptr(ext[0]), _ptr(ext[1]), psum.data_ptr(),
                    entry="mlp_pass_launch")
        mean, var = empty(cout), empty(cout)
        cuda.launch("fused_mlp", dev, psum.data_ptr(), tiles, cout, rows,
                    mean.data_ptr(), var.data_ptr(), entry="mlp_stats_launch")
        means.append(mean)
        variances.append(var)
        muls.append(bn_mul(var, scales[j], eps))
        a = out  # the pass's input is read no more
    cuda.launch("fused_mlp", dev, ext[0].data_ptr(), ext[1].data_ptr(), B * S,
                K // seg, chans[-1], means[-1].data_ptr(), muls[-1].data_ptr(),
                biases[-1].data_ptr(), pooled.data_ptr(),
                entry="mlp_pool_launch")
    return tuple(means), tuple(variances)


def kernel_mlp_pool(grouped, weights, scales, biases, ra_means, ra_vars,
                    train: bool, eps: float):
    """The CUDA kernels on card tensors: the same signature and results as
    `plain_mlp_pool` (no autograd)."""
    _check(grouped, weights, scales, biases, ra_means, ra_vars, train)
    B, S, _, _ = grouped.shape
    pooled = torch.empty(B, S, weights[-1].shape[1], dtype=torch.float32,
                         device=grouped.device)
    if not train:
        muls = [bn_mul(v, s, eps) for v, s in zip(ra_vars, scales)]
        _eval_launch(grouped, weights, biases, ra_means, muls, pooled)
        fused_mlp_pool.launches += 1
        return pooled, (), ()
    means, variances = _train_launches(grouped, weights, scales, biases, eps,
                                       pooled)
    fused_mlp_pool.launches += 1
    return pooled, means, variances


class _FusedMLPPool(torch.autograd.Function):
    """Forward: the kernel (card) or the plain version (CPU). Backward:
    autograd through `plain_mlp_pool` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, L: int, train: bool, eps: float, grouped, *flat):
        ws, ss, bs = flat[:L], flat[L:2 * L], flat[2 * L:3 * L]
        rm, rv = flat[3 * L:4 * L], flat[4 * L:]
        fn = plain_mlp_pool if grouped.device.type == "cpu" else kernel_mlp_pool
        pooled, means, variances = fn(grouped, ws, ss, bs, rm, rv, train, eps)
        ctx.save_for_backward(grouped, *flat)
        ctx.cfg = (L, train, eps)
        ctx.mark_non_differentiable(*means, *variances)
        ctx.set_materialize_grads(False)
        return (pooled, *means, *variances)

    @staticmethod
    def backward(ctx, g_pooled, *g_stats):
        L, train, eps = ctx.cfg
        saved = ctx.saved_tensors
        n = 1 + 3 * L  # grouped, weights, scales, biases
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(saved[:n], ctx.needs_input_grad[3:3 + n])]
        rm, rv = saved[n:n + L], saved[n + L:]
        grads = [None] * (len(saved))
        wanted = [i for i, t in enumerate(inputs) if t.requires_grad]
        if g_pooled is not None and wanted:
            with torch.enable_grad():
                pooled, _, _ = plain_mlp_pool(
                    inputs[0], inputs[1:1 + L], inputs[1 + L:1 + 2 * L],
                    inputs[1 + 2 * L:], rm, rv, train, eps)
                got = torch.autograd.grad(pooled, [inputs[i] for i in wanted],
                                          g_pooled, allow_unused=True)
            for i, gr in zip(wanted, got):
                grads[i] = gr
        return (None, None, None, *grads)


def fused_mlp_pool(grouped, weights, scales, biases, ra_means=(), ra_vars=(),
                   *, train: bool, eps: float = 1e-5):
    """Fused SharedMLP (Dense -> BN -> ReLU per layer) + K max-pool.

    grouped (B, S, K, C0) float32 -> (pooled (B, S, C_L), batch means,
    batch vars); the stats tuples are empty in eval mode (`train=False`),
    which uses `ra_means`/`ra_vars`. weights[i] is (C_{i-1}, C_i), as the
    JAX package's Dense kernels. Gradients flow to grouped, weights, scales
    and biases, never to the running statistics. Each call on the card adds
    one to `fused_mlp_pool.launches` (an eval-mode call is one kernel
    launch, a train-mode call 2L+1)."""
    L = len(weights)
    ra = () if train else (*ra_means, *ra_vars)
    out = _FusedMLPPool.apply(L, bool(train), float(eps), grouped,
                              *weights, *scales, *biases, *ra)
    if not train:
        return out[0], (), ()
    return out[0], tuple(out[1:1 + L]), tuple(out[1 + L:])


fused_mlp_pool.launches = 0  # calls that launched the kernels since set to 0
