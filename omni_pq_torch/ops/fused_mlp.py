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

In train mode the kernel runs L+1 passes, as the Pallas grid does: pass i
recomputes the chain up to layer i (earlier layers normalised with their
finished batch stats) and sums layer i's per-channel sum and sum of squares
over all rows; the last pass writes the pooled output. Per-block partial sums
are reduced in a fixed order, so two runs give bitwise the same stats.

The backward recomputes the plain chain under autograd and backpropagates
through it (the JAX package's `_fused_bwd`); running statistics get no
gradient.
"""
from __future__ import annotations

from typing import Sequence

import ctypes

import torch

from . import cuda

# the CUDA kernel's limits: at most this many layers, and 256 threads a block
MAX_LAYERS = 8
# blocks per SM the wrapper sizes the partial-sum buffer for (256 threads a
# block: at most 8 resident on an SM)
_MAX_BLOCKS_PER_SM = 8
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
    _, _, lib = cuda.library("fused_mlp")
    smem_bytes = lib.fused_mlp_smem_bytes
    smem_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    smem_bytes.restype = ctypes.c_longlong
    c_chans = (ctypes.c_int * len(chans))(*chans)
    need = smem_bytes(ctypes.cast(c_chans, ctypes.c_void_p), L, K)
    if need > cuda.MAX_SHARED_BYTES:
        raise ValueError(f"fused_mlp: K={K} and widths {chans} need {need} "
                         f"bytes of shared memory a block, more than "
                         f"{cuda.MAX_SHARED_BYTES}")
    return chans


def _rows_per_tile(K: int) -> int:
    # fused_mlp.cu's tile: the smallest whole number of centres >= 32 rows
    return -(-32 // K) * K


def _launch(grouped, weights, biases, mus, muls, run_layers, stats_layer,
            pooled=None):
    """One pass of the kernel. Returns (mean, var) of layer `stats_layer`
    when it is >= 0."""
    dev = grouped.device
    B, S, K, C0 = grouped.shape
    chans = [C0] + [w.shape[1] for w in weights]
    L = len(weights)
    ptrs = []
    for i in range(L):
        have = i < len(mus) and mus[i] is not None
        ptrs += [weights[i].data_ptr(), mus[i].data_ptr() if have else 0,
                 muls[i].data_ptr() if have else 0, biases[i].data_ptr()]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_chans = (ctypes.c_int * len(chans))(*chans)
    rows = B * S * K
    ntiles = -(-rows // _rows_per_tile(K))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    max_blocks = max(1, min(ntiles, sms * _MAX_BLOCKS_PER_SM))
    mean = var = psum = None
    if stats_layer >= 0:
        c = chans[stats_layer + 1]
        psum = torch.empty(max_blocks, 2, c, dtype=torch.float32, device=dev)
        mean = torch.empty(c, dtype=torch.float32, device=dev)
        var = torch.empty(c, dtype=torch.float32, device=dev)
    cuda.launch("fused_mlp", dev, grouped.data_ptr(),
                pooled.data_ptr() if pooled is not None else None,
                ctypes.cast(c_ptrs, ctypes.c_void_p),
                ctypes.cast(c_chans, ctypes.c_void_p), L, rows, K,
                run_layers, stats_layer, max_blocks,
                psum.data_ptr() if psum is not None else None,
                mean.data_ptr() if mean is not None else None,
                var.data_ptr() if var is not None else None)
    return mean, var


def kernel_mlp_pool(grouped, weights, scales, biases, ra_means, ra_vars,
                    train: bool, eps: float):
    """The CUDA kernel on card tensors: the same signature and results as
    `plain_mlp_pool` (no autograd)."""
    _check(grouped, weights, scales, biases, ra_means, ra_vars, train)
    B, S, K, _ = grouped.shape
    L = len(weights)
    pooled = torch.empty(B, S, weights[-1].shape[1], dtype=torch.float32,
                         device=grouped.device)
    if B * S == 0:
        raise ValueError("fused_mlp: empty input")
    if not train:
        mus = list(ra_means)
        muls = [bn_mul(v, s, eps) for v, s in zip(ra_vars, scales)]
        _launch(grouped, weights, biases, mus, muls, L, -1, pooled)
        fused_mlp_pool.launches += 1
        return pooled, (), ()
    mus, muls, means, variances = [], [], [], []
    for p in range(L):
        mean, var = _launch(grouped, weights, biases, mus, muls, p + 1, p)
        means.append(mean)
        variances.append(var)
        mus.append(mean)
        muls.append(bn_mul(var, scales[p], eps))
    _launch(grouped, weights, biases, mus, muls, L, -1, pooled)
    fused_mlp_pool.launches += 1
    return pooled, tuple(means), tuple(variances)


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
    one to `fused_mlp_pool.launches` (a train-mode call runs L+1 kernel
    passes)."""
    L = len(weights)
    ra = () if train else (*ra_means, *ra_vars)
    out = _FusedMLPPool.apply(L, bool(train), float(eps), grouped,
                              *weights, *scales, *biases, *ra)
    if not train:
        return out[0], (), ()
    return out[0], tuple(out[1:1 + L]), tuple(out[1 + L:])


fused_mlp_pool.launches = 0  # calls that launched the kernel since set to 0
