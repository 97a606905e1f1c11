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

Eval mode runs one chained kernel a call where a tile of whole centres and
its chain fit in shared memory, and the pass plan otherwise (large K at
wide layers): passes with the running statistics as their BN, no stats
launches, and the pool launch. No shape goes to the plain version.

bfloat16 compute (`dtype=torch.bfloat16`, the JAX package's
`dtype=bfloat16`): the grouped rows and the weights are rounded to
bfloat16, each product sums bfloat16 x bfloat16 in float32 and is rounded
to bfloat16 (af); the statistics (float32) and the BN are taken on af in
float32, and the BN output is rounded to bfloat16 before the ReLU; the
pooled output is bfloat16. The CUDA kernels of this mode
(`csrc/fused_mlp_bf16.cu`) run the products with wgmma on the tensor
cores, fed by bulk asynchronous copies of weight stages that
`_weights_packed` lays out: the eval chain with every layer's activations
in registers (where a warpgroup's 64 rows hold whole centres and the
middle layers are at most 256 wide, `eval_chained`; else the pass plan),
the pass plan with bfloat16 scratch (a_j stored exactly as af) and without
the a_1 recompute.

The backward recomputes the plain chain under autograd, in the call's
dtype, and backpropagates through it (the JAX package's `_fused_bwd`);
running statistics get no gradient.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist

from . import cuda
from .matmul import matmul
from .. import parallel

# the CUDA kernel's limits: at most this many layers, and 256 threads a block
MAX_LAYERS = 8
# the pass plan recomputes a_1 from the grouped rows where C0 is at most this
# (C0 FMAs an element instead of a stored C1-wide row; the kernel holds up
# to 4 input channels a row for it)
RECOMPUTE_MAX_C0 = 4
_LANE = 128


# the K quantum of each compute dtype's kernels (the JAX gate's sublanes)
_K_QUANTUM = {torch.float32: 8, torch.bfloat16: 16}


def supports(K: int, channels: Sequence[int], dtype) -> bool:
    """The JAX package's gate, kept as the routing rule so that the same SA
    layers fuse in both packages: float32 with K a multiple of 8 or
    bfloat16 with K a multiple of 16, and every channel width a multiple of
    128 (vote_aggregation's 288 stays unfused). The kernels themselves need
    that K (a thread's 8 rows, a tensor-core tile's 16, lie in one
    centre)."""
    return (dtype in _K_QUANTUM and K % _K_QUANTUM[dtype] == 0
            and len(channels) <= MAX_LAYERS
            and all(c % _LANE == 0 for c in channels))


def bn_mul(var: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The per-channel BN multiplier rsqrt(var + eps) * scale, computed once
    in torch for both the kernel and the plain version."""
    return torch.rsqrt(var + eps) * scale


def plain_mlp_pool(grouped, weights, scales, biases, ra_means, ra_vars,
                   train: bool, eps: float, dtype=torch.float32):
    """The plain version: the SharedMLP chain + K max-pool as tensor ops
    (the JAX package's `plain_mlp_pool`).

    grouped (B, S, K, C0); weights[i] (C_{i-1}, C_i); scales/biases (C_i,);
    ra_* are used when not `train`. Each product runs in `dtype` (its
    output rounded to it), the statistics and the BN in float32 on the
    promoted product, the BN output is rounded to `dtype` before the ReLU.
    Inside `parallel.data_parallel` the train-mode statistics are the
    global batch's (`parallel.moments`), and so is their gradient.
    Returns (pooled (B, S, C_L) in `dtype`, means, vars): the batch
    statistics of every layer (train) or () (eval)."""
    x = grouped.to(dtype)
    means, variances = [], []
    dp = parallel.current() if train else None
    for i, w in enumerate(weights):
        a = matmul(x, w.to(dtype))
        af = a.float()
        if dp is not None:  # over the global batch, autograd-aware
            mu, var = parallel.moments(af, dp)
            means.append(mu)
            variances.append(var)
        elif train:
            mu = af.mean(dim=(0, 1, 2))
            mu2 = (af * af).mean(dim=(0, 1, 2))
            var = torch.clamp_min(mu2 - mu * mu, 0.0)
            means.append(mu)
            variances.append(var)
        else:
            mu, var = ra_means[i], ra_vars[i]
        y = (af - mu) * bn_mul(var, scales[i], eps) + biases[i]
        x = torch.relu(y.to(dtype))
    return x.amax(dim=2), tuple(means), tuple(variances)


def fused_mlp_pool_plain(grouped, weights, scales, biases, ra_means=(),
                         ra_vars=(), *, train: bool, eps: float = 1e-5,
                         dtype=torch.float32):
    """`fused_mlp_pool`'s signature over the plain version on any device
    (autograd straight through the tensor ops)."""
    return plain_mlp_pool(grouped, weights, scales, biases, ra_means, ra_vars,
                          train, eps, dtype)


class Pass(NamedTuple):
    """One GEMM pass of the train mode: a_{layer+1} = h_layer @ W_layer."""
    layer: int
    source: str      # "x": the grouped rows; "a": the stored a_layer, BN +
                     # ReLU on load; "x@W0": a_1 recomputed from the rows
    store: bool      # writes a_{layer+1} to a scratch tensor
    extremes: bool   # the last pass: max and min of a_L over each centre


def pass_plan(chans: Sequence[int], dtype=torch.float32,
              train: bool = True) -> list[Pass]:
    """The pass plan's passes for widths [C0, C1, ..., CL]: one a layer, in
    train mode each launch followed by a stats launch, then the pool
    launch. float32 recomputes a_1 from the grouped rows where C0 is tiny
    (pass 0 then only sums, and an eval plan drops it); bfloat16 stores
    a_1."""
    L = len(chans) - 1
    recompute = (dtype == torch.float32 and L >= 2
                 and chans[0] <= RECOMPUTE_MAX_C0)
    plan = []
    for j in range(L):
        if j == 0 and recompute and not train:
            continue
        source = "x" if j == 0 else ("x@W0" if j == 1 and recompute else "a")
        plan.append(Pass(j, source, store=j < L - 1 and not (
            j == 0 and recompute), extremes=j == L - 1))
    return plan


def plan_costs(chans: Sequence[int], rows: int,
               dtype=torch.float32) -> tuple[int, int]:
    """(operations, scratch bytes) of the train-mode pass plan over `rows`
    rows: 2 a multiply-add of every pass, the recompute included, and the
    most bytes of stored pre-activations alive at once (a pass's input and
    output; 4 bytes an element in float32, 2 in bfloat16)."""
    size = torch.finfo(dtype).bits // 8
    ops_n, peak = 0, 0
    for p in pass_plan(chans, dtype):
        j = p.layer
        ops_n += 2 * rows * chans[j] * chans[j + 1]
        if p.source == "x@W0":
            ops_n += 2 * rows * chans[0] * chans[1]
        alive = ((chans[j] if p.source == "a" else 0)
                 + (chans[j + 1] if p.store else 0))
        peak = max(peak, size * rows * alive)
    return ops_n, peak


def _library(dtype):
    return "fused_mlp" if dtype == torch.float32 else "fused_mlp_bf16"


def eval_chained(chans: Sequence[int], K: int, dtype=torch.float32) -> bool:
    """Whether an eval call takes the chained kernel rather than the pass
    plan, by the shared-memory need the built library reports (above any
    block's limit where its chained kernel does not take the shape: float32
    where a tile of whole centres and its chain do not fit in shared
    memory, bfloat16 where a centre exceeds a warpgroup's 64 rows or a
    middle layer the 256 columns that stay in registers)."""
    _, _, lib = cuda.library(_library(dtype))
    fn = getattr(lib, f"{_library(dtype)}_smem_bytes")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    c_chans = (ctypes.c_int * len(chans))(*chans)
    need = fn(ctypes.cast(c_chans, ctypes.c_void_p), len(chans) - 1, K)
    return need <= cuda.MAX_SHARED_BYTES


def _check(grouped, weights, scales, biases, ra_means, ra_vars, train, dtype):
    cuda.check_cuda_tensor("fused_mlp grouped", grouped, torch.float32, 4)
    if dtype not in _K_QUANTUM:
        raise ValueError(f"fused_mlp: compute dtype {dtype}, expected "
                         "float32 or bfloat16")
    L = len(weights)
    if not 1 <= L <= MAX_LAYERS:
        raise ValueError(f"fused_mlp: 1..{MAX_LAYERS} layers, got {L}")
    K = grouped.shape[2]
    cin = grouped.shape[3]
    chans = [cin]
    # float32: widths a multiple of 4 (float4 rows); bfloat16: of 64 (a
    # warp's columns in the chained kernel)
    width_q = 4 if dtype == torch.float32 else 64
    for i, w in enumerate(weights):
        cuda.check_cuda_tensor(f"fused_mlp weight {i}", w, torch.float32, 2)
        if w.shape[0] != cin or w.shape[1] % width_q \
                or w.device != grouped.device:
            raise ValueError(f"fused_mlp: weight {i} of shape "
                             f"{tuple(w.shape)} on {w.device} after width "
                             f"{cin}; widths must be multiples of {width_q}")
        cin = w.shape[1]
        chans.append(cin)
        vecs = [scales[i], biases[i]] + (
            [] if train else [ra_means[i], ra_vars[i]])
        for v in vecs:
            cuda.check_cuda_tensor(f"fused_mlp layer {i} vector", v,
                                   torch.float32, 1, last=cin)
        if w.data_ptr() % 16:
            raise ValueError(f"fused_mlp: weight {i} is not 16-byte aligned")
    q = _K_QUANTUM[dtype]
    if K % q:
        raise ValueError(f"fused_mlp kernel takes K % {q} == 0 in {dtype}, "
                         f"got K={K}")
    if grouped.shape[0] * grouped.shape[1] == 0:
        raise ValueError("fused_mlp: empty input")
    return chans


def pass_tile(K: int, dtype=torch.float32) -> tuple[int, int]:
    """(rows a pass tile, rows a max/min segment) of the pass plan's kernel
    for K neighbours, read from the built library: a tile holds whole
    segments, a segment the K rows of a centre (K <= 128) or an equal part
    of them (a multiple of 8 rows in float32, of 16 in bfloat16)."""
    name = _library(dtype)
    _, _, lib = cuda.library(name)
    fn = getattr(lib, "mlp_pass_tile" if dtype == torch.float32
                 else "mlp_pass_bf16_tile")
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    if fn(K, ctypes.cast(out, ctypes.c_void_p)) != 0:
        raise ValueError(f"fused_mlp: no pass tile for K={K}")
    return out[0], out[1]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _weights_packed(weights) -> list[tuple[torch.Tensor, int]]:
    """The bfloat16 kernels' weights: each W (C_in, C_out) rounded to
    bfloat16, transposed to W^T (C_out, kp) with k zero-padded to kp (a
    multiple of 64), and packed into the kernels' weight stages
    (`csrc/wgmma_logic.cuh::packed_weight_index`): stage k // 64 holds
    every row's 64 k, 8-row group by 8-row group, each 8 x 8 core matrix's
    128 bytes contiguous, so that a stage of any rows is one bulk copy.
    Returns [(packed, kp)]."""
    out = []
    for w in weights:
        cin, cout = w.shape
        kp = -(-cin // 64) * 64
        wt = torch.zeros(cout, kp, dtype=torch.bfloat16, device=w.device)
        wt[:, :cin] = w.t()
        out.append((wt.view(cout // 8, 8, kp // 64, 8, 8)
                    .permute(2, 0, 3, 1, 4).contiguous().view(-1), kp))
    return out


def _eval_launch(grouped, weights, biases, mus, muls, pooled, dtype):
    B, S, K, C0 = grouped.shape
    chans = [C0] + [w.shape[1] for w in weights]
    packed = None if dtype == torch.float32 else _weights_packed(weights)
    ws = weights if packed is None else [w for w, _ in packed]
    ptrs = []
    for w, mu, mul, b in zip(ws, mus, muls, biases):
        ptrs += [w.data_ptr(), mu.data_ptr(), mul.data_ptr(), b.data_ptr()]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_chans = (ctypes.c_int * len(chans))(*chans)
    args = [grouped.data_ptr(), pooled.data_ptr(),
            ctypes.cast(c_ptrs, ctypes.c_void_p),
            ctypes.cast(c_chans, ctypes.c_void_p)]
    if dtype != torch.float32:
        c_kps = (ctypes.c_int * len(ws))(*[kp for _, kp in packed])
        args.append(ctypes.cast(c_kps, ctypes.c_void_p))
    cuda.launch(_library(dtype), grouped.device, *args, len(weights),
                B * S * K, K)


def _pass_launch(dtype, p, a, bn, w, wt, cin, cout, rows, K, out, ext, psum,
                 x0, w0, c0):
    """One pass of the plan: the float32 kernel (with the a_1 recompute) or
    the bfloat16 one."""
    dev = (a if a is not None else x0).device
    if dtype == torch.float32:
        cuda.launch("fused_mlp", dev,
                    _ptr(a if p.source == "a" else x0),
                    _ptr(w0 if p.source == "x@W0" else None),
                    c0 if p.source == "x@W0" else 0, *map(_ptr, bn),
                    w.data_ptr(), cin, cout, rows, K, _ptr(out),
                    _ptr(ext[0]), _ptr(ext[1]), _ptr(psum),
                    entry="mlp_pass_launch")
    else:
        src = a if p.source == "a" else x0
        cuda.launch("fused_mlp_bf16", dev, src.data_ptr(),
                    int(p.source == "a"), *map(_ptr, bn), wt[0].data_ptr(),
                    wt[1], cin, cout, rows, K, _ptr(out),
                    _ptr(ext[0]), _ptr(ext[1]), _ptr(psum),
                    entry="mlp_pass_bf16_launch")


def _pass_launches(grouped, weights, scales, biases, eps, pooled, dtype,
                   running=None):
    """The pass plan on the card: L passes, then the pool launch. In train
    mode (`running` None) a stats launch follows each pass and the BN of a
    pass's A operand is the previous layer's batch statistics; in eval mode
    `running` = (running means, running variances) gives every BN and no
    statistics are kept. Scratch (stored pre-activations in `dtype`,
    column sums, extremes) comes from torch.empty and is freed as soon as
    no later launch reads it. Returns the batch means and variances (train)
    or ((), ()). Inside `parallel.data_parallel` each layer's statistics are
    the global batch's: its column sums are added over the ranks between
    the stats launch and a finishing launch (2 more launches a layer)."""
    dev = grouped.device
    B, S, K, C0 = grouped.shape
    chans = [C0] + [w.shape[1] for w in weights]
    rows = B * S * K
    train = running is None
    dp = parallel.current() if train else None
    tile_rows, seg = pass_tile(K, dtype)
    tiles = -(-rows // tile_rows)
    empty = lambda *shape, dt=torch.float32: torch.empty(  # noqa: E731
        *shape, dtype=dt, device=dev)
    wts = (_weights_packed(weights) if dtype != torch.float32
           else [None] * len(weights))
    if train:
        means, variances, muls = [], [], []
    else:
        means, variances = list(running[0]), list(running[1])
        muls = [bn_mul(v, s, eps) for v, s in zip(variances, scales)]
    a = ext = None
    for p in pass_plan(chans, dtype, train):
        j, cout = p.layer, chans[p.layer + 1]
        out = empty(rows, cout, dt=dtype) if p.store else None
        ext = (empty(rows // seg, cout), empty(rows // seg, cout)) \
            if p.extremes else (None, None)
        psum = empty(tiles, 2, cout) if train else None
        bn = (means[j - 1], muls[j - 1], biases[j - 1]) if j else (None,) * 3
        _pass_launch(dtype, p, a, bn, weights[j], wts[j], chans[j], cout,
                     rows, K, out, ext, psum, grouped, weights[0], C0)
        if train:
            mean, var = empty(cout), empty(cout)
            if dp is None:
                cuda.launch("fused_mlp", dev, psum.data_ptr(), tiles, cout,
                            rows, mean.data_ptr(), var.data_ptr(), None,
                            entry="mlp_stats_launch")
            else:
                # the layer's [S1, S2, n] summed over the ranks between the
                # reduction and the finish: the next pass's BN is global
                sums = empty(2 * cout + 1, dt=torch.float64)
                cuda.launch("fused_mlp", dev, psum.data_ptr(), tiles, cout,
                            rows, None, None, sums.data_ptr(),
                            entry="mlp_stats_launch")
                dist.all_reduce(sums, group=dp.group)
                cuda.launch("fused_mlp", dev, sums.data_ptr(), cout,
                            mean.data_ptr(), var.data_ptr(),
                            entry="mlp_stats_finish_launch")
            means.append(mean)
            variances.append(var)
            muls.append(bn_mul(var, scales[j], eps))
        a = out  # the pass's input is read no more
    cuda.launch("fused_mlp", dev, ext[0].data_ptr(), ext[1].data_ptr(), B * S,
                K // seg, chans[-1], means[-1].data_ptr(), muls[-1].data_ptr(),
                biases[-1].data_ptr(), pooled.data_ptr(),
                int(dtype != torch.float32), entry="mlp_pool_launch")
    return (tuple(means), tuple(variances)) if train else ((), ())


def kernel_mlp_pool(grouped, weights, scales, biases, ra_means, ra_vars,
                    train: bool, eps: float, dtype=torch.float32):
    """The CUDA kernels on card tensors: the same signature and results as
    `plain_mlp_pool` (no autograd)."""
    chans = _check(grouped, weights, scales, biases, ra_means, ra_vars,
                   train, dtype)
    B, S, K, _ = grouped.shape
    pooled = torch.empty(B, S, weights[-1].shape[1], dtype=dtype,
                         device=grouped.device)
    if not train and eval_chained(chans, K, dtype):
        muls = [bn_mul(v, s, eps) for v, s in zip(ra_vars, scales)]
        _eval_launch(grouped, weights, biases, ra_means, muls, pooled, dtype)
        means, variances = (), ()
    else:
        means, variances = _pass_launches(
            grouped, weights, scales, biases, eps, pooled, dtype,
            None if train else (ra_means, ra_vars))
    fused_mlp_pool.launches += 1
    return pooled, means, variances


class _FusedMLPPool(torch.autograd.Function):
    """Forward: the kernel (card) or the plain version (CPU). Backward:
    autograd through `plain_mlp_pool` recomputed from the saved inputs, in
    the forward's dtype and data-parallel context (its statistics and their
    gradient over the global batch)."""

    @staticmethod
    def forward(ctx, L: int, train: bool, eps: float, dtype, grouped, *flat):
        ws, ss, bs = flat[:L], flat[L:2 * L], flat[2 * L:3 * L]
        rm, rv = flat[3 * L:4 * L], flat[4 * L:]
        fn = plain_mlp_pool if grouped.device.type == "cpu" else kernel_mlp_pool
        pooled, means, variances = fn(grouped, ws, ss, bs, rm, rv, train, eps,
                                      dtype)
        ctx.save_for_backward(grouped, *flat)
        ctx.cfg = (L, train, eps, dtype)
        ctx.dp = parallel.current()
        ctx.mark_non_differentiable(*means, *variances)
        ctx.set_materialize_grads(False)
        return (pooled, *means, *variances)

    @staticmethod
    def backward(ctx, g_pooled, *g_stats):
        L, train, eps, dtype = ctx.cfg
        saved = ctx.saved_tensors
        n = 1 + 3 * L  # grouped, weights, scales, biases
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(saved[:n], ctx.needs_input_grad[4:4 + n])]
        rm, rv = saved[n:n + L], saved[n + L:]
        grads = [None] * (len(saved))
        wanted = [i for i, t in enumerate(inputs) if t.requires_grad]
        if g_pooled is not None and wanted:
            # the forward's data-parallel context: global statistics
            with torch.enable_grad(), parallel.using(ctx.dp):
                pooled, _, _ = plain_mlp_pool(
                    inputs[0], inputs[1:1 + L], inputs[1 + L:1 + 2 * L],
                    inputs[1 + 2 * L:], rm, rv, train, eps, dtype)
                got = torch.autograd.grad(pooled, [inputs[i] for i in wanted],
                                          g_pooled, allow_unused=True)
            for i, gr in zip(wanted, got):
                grads[i] = gr
        return (None, None, None, None, *grads)


def fused_mlp_pool(grouped, weights, scales, biases, ra_means=(), ra_vars=(),
                   *, train: bool, eps: float = 1e-5, dtype=torch.float32):
    """Fused SharedMLP (Dense -> BN -> ReLU per layer) + K max-pool.

    grouped (B, S, K, C0) float32 -> (pooled (B, S, C_L) in `dtype`, batch
    means, batch vars); the stats tuples are empty in eval mode
    (`train=False`), which uses `ra_means`/`ra_vars`. weights[i] is
    (C_{i-1}, C_i) float32, as the JAX package's Dense kernels; `dtype`
    (float32 or bfloat16) is the compute dtype. Gradients flow to grouped,
    weights, scales and biases, never to the running statistics. Each call
    on the card adds one to `fused_mlp_pool.launches` (an eval-mode call is
    one chained-kernel launch where its tile fits in shared memory, else L
    passes (L - 1 where float32 recomputes a_1) and a pool launch; a
    train-mode call 2L+1 launches, 3L+1 inside `parallel.data_parallel`,
    whose batch statistics are the global batch's)."""
    L = len(weights)
    ra = () if train else (*ra_means, *ra_vars)
    out = _FusedMLPPool.apply(L, bool(train), float(eps), dtype, grouped,
                              *weights, *scales, *biases, *ra)
    if not train:
        return out[0], (), ()
    return out[0], tuple(out[1:1 + L]), tuple(out[1 + L:])


fused_mlp_pool.launches = 0  # calls that launched the kernels since set to 0
