"""Data parallelism on torch.distributed (the port of
`omni_pq_tpu/parallel/mesh.py`).

The JAX package trains on a 1-D 'data' mesh: one jitted step over the
global batch, whose BatchNorm statistics, losses and gradients are those of
the global batch. Here every process (rank) runs the step on its local rows
and the step computes the same global function:
  - `data_parallel()` is a context that the model's modules consult. Inside
    it, train-mode BatchNorm (`models.pointnet2.BatchNorm`) and the fused
    SA-MLP's train mode (`ops.fused_mlp`) take their statistics over the
    global batch (one all-reduce a layer: of [E[x], E[x^2]] / world,
    autograd-aware, or the kernel's [sum x, sum x^2, n]), and dropout (`models.transformer.dropout`) draws its mask for
    the global batch's shape and keeps this rank's rows, so the generator
    of every rank stays in step with a single process's. Outside it, every
    module computes exactly what it computes without this package.
  - `gather_rows` brings end points and labels to every rank in the global
    batch's row order, so the loss modules run unchanged on the global
    batch; `all_reduce_grads` averages the gradients after the backward;
    `broadcast_state` gives every rank rank 0's train state.
The global batch is laid out segment by segment, each segment rank by rank:
a local double batch [labeled | weak] of every rank becomes
[L_0 L_1 ... | W_0 W_1 ...], the row order of a single process fed the
concatenated loaders' batches. Every rank must hold the same number of rows
in each segment (the sharded `data.Loader` pads with wrap-around for that).

The collectives on tensors are all-reduces and broadcasts (host data, a
val batch's labels, travels by all_gather_object): NCCL on the card, gloo
on the CPU, and gloo on card tensors too (several ranks on one card, which
NCCL refuses). No collective's failure is caught.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# names init_distributed's backend, "nccl" or "gloo", in place of its
# default (gloo runs several ranks on one card, which NCCL refuses)
BACKEND_ENV = "OMNI_PQ_DIST_BACKEND"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> torch.device:
    """Join the process group (the JAX package's `init_distributed`, the
    reference's init_process_group, train.py:775-776) and return this
    rank's device. Call it before any other device access.

    With `coordinator_address` ('host:port' of rank 0, the JAX CLI's flag)
    the group is tcp://coordinator_address of `num_processes` ranks, this
    one `process_id`; without it, env:// reads MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK (as torchrun sets them), as JAX reads its cluster's
    environment. The backend is $OMNI_PQ_DIST_BACKEND where set, else NCCL
    for a card and gloo for the CPU. A 'cuda' device becomes
    cuda:LOCAL_RANK (torchrun's), or cuda:(rank % cards) where LOCAL_RANK
    is not set."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but torch sees no "
                           "CUDA card; pass device='cpu' to run on the CPU")
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator_address needs --num_processes "
                             "and --process_id")
        init_method, world_, rank_ = (f"tcp://{coordinator_address}",
                                      int(num_processes), int(process_id))
    else:
        init_method, world_, rank_ = "env://", None, None
    backend = os.environ.get(BACKEND_ENV) or (
        "nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda" and device.index is None:
        cards = torch.cuda.device_count()
        local = os.environ.get("LOCAL_RANK")
        index = (int(local) if local is not None
                 else (rank_ if rank_ is not None
                       else int(os.environ["RANK"])) % cards)
        if index >= cards:
            raise ValueError(f"LOCAL_RANK {index}: this host has {cards} "
                             "card(s)")
        device = torch.device("cuda", index)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_ if world_ is not None else -1,
                            rank=rank_ if rank_ is not None else -1)
    return device


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def per_host_batch_size(global_batch: int) -> int:
    """Each rank feeds global_batch / world scenes."""
    n = world()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{n} ranks")
    return global_batch // n


class DataParallel:
    """The active data-parallel context: the process group, this rank, the
    number of ranks, and the row segments of the local batch in flight
    (`segments`; one segment of the whole local batch where none are set)."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.segments: Optional[tuple] = None

    def row_ranges(self, n: int, segments: Optional[Sequence[int]] = None):
        """[(global start, local start, rows)] of this rank's `n` local
        rows in the global batch, segment by segment, under `segments`,
        else the current segments, else one segment."""
        segs = segments or self.segments or (n,)
        if sum(segs) != n:
            raise ValueError(f"a local batch of {n} rows under segments "
                             f"{segs}")
        out, start, local = [], 0, 0
        for s in segs:
            out.append((start + self.rank * s, local, s))
            start += self.world * s
            local += s
        return out


_ACTIVE: Optional[DataParallel] = None


def current() -> Optional[DataParallel]:
    """The active `data_parallel` context, or None."""
    return _ACTIVE


@contextlib.contextmanager
def using(dp: Optional[DataParallel]):
    """Within the block, `dp` (a context `current()` returned earlier, or
    None) is the active one: a backward that recomputes a forward takes
    the forward's context."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, dp
    try:
        yield dp
    finally:
        _ACTIVE = saved


@contextlib.contextmanager
def data_parallel(group=None):
    """Within the block, the modules compute over the global batch of the
    process group `group` (the default group where None). Needs an
    initialised process group."""
    if not dist.is_initialized():
        raise RuntimeError("data_parallel needs torch.distributed's process "
                           "group (init_distributed)")
    with using(DataParallel(group)) as dp:
        yield dp


@contextlib.contextmanager
def batch_segments(*sizes: int):
    """Within the block, the local batch in flight is made of segments of
    these sizes (e.g. labeled then weak rows), each sharded over the ranks:
    dropout keeps the global mask's rows of this rank. A no-op outside
    `data_parallel`."""
    dp = _ACTIVE
    if dp is None:
        yield
        return
    saved, dp.segments = dp.segments, tuple(int(s) for s in sizes)
    try:
        yield
    finally:
        dp.segments = saved


class _AllReduceSum(torch.autograd.Function):
    """all_reduce(SUM) whose backward is the all_reduce(SUM) of the
    cotangent: every rank's result depends on every rank's input."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return None, _AllReduceSum.apply(ctx.group, grad)


def all_reduce_sum(x: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """The sum of `x` over the ranks of `dp`, on every rank (bitwise the
    same there), autograd-aware."""
    return _AllReduceSum.apply(dp.group, x)


def moments(x: torch.Tensor, dp: DataParallel):
    """flax's batch statistics over every axis but the last, of the global
    batch: mean = E[x], var = max(0, E[x^2] - E[x]^2) (the fast variance),
    each expectation the sum over the ranks of the local one over `world`
    (one all-reduce of [E_r[x], E_r[x^2]] / world; every rank holds as many
    rows). The local expectations are the ones a single process takes, so
    a world of 1 computes its statistics bitwise. Gradients flow through
    both, over the ranks."""
    C = x.shape[-1]
    dims = tuple(range(x.dim() - 1))
    local = torch.cat([x.mean(dim=dims), (x * x).mean(dim=dims)])
    s = all_reduce_sum(local * (1.0 / dp.world), dp)
    mean, mean2 = s[:C], s[C:]
    return mean, torch.clamp_min(mean2 - mean * mean, 0.0)


def _pack_key(t: torch.Tensor):
    return (t.dtype, t.device)


def gather_rows(tree: Mapping[str, torch.Tensor],
                segments: Optional[Sequence[int]] = None,
                dp: Optional[DataParallel] = None
                ) -> Dict[str, torch.Tensor]:
    """Every tensor of `tree` (leading axis: the local batch's rows, in
    `segments`) as the global batch's tensor on every rank, rows in the
    global order (segment by segment, rank by rank). One all-reduce a dtype:
    each rank writes its rows into a zero-filled global buffer and the
    buffers are summed, so the result is bitwise the same on every rank.
    Autograd-aware: the backward hands each rank the sum over ranks of its
    rows' cotangents, i.e. `world` times its rows' cotangent where every
    rank computes the same loss from the gathered tensors;
    `all_reduce_grads` divides that factor out. Booleans travel as uint8."""
    dp = dp or _ACTIVE
    if dp is None:
        raise RuntimeError("gather_rows outside data_parallel")
    keys = list(tree)
    if not keys:
        return {}
    n = tree[keys[0]].shape[0]
    ranges = dp.row_ranges(n, segments or (n,))
    wire = {k: t.to(torch.uint8) if t.dtype == torch.bool else t
            for k, t in tree.items()}
    groups: Dict[tuple, List[str]] = {}
    for k, t in wire.items():
        if t.shape[0] != n:
            raise ValueError(f"gather_rows: {k} has {t.shape[0]} rows, "
                             f"{keys[0]} {n}")
        groups.setdefault(_pack_key(t), []).append(k)
    out = {}
    for (dtype, _), ks in groups.items():
        parts = [wire[k].reshape(n, -1) for k in ks]
        local = torch.cat(parts, dim=1)
        buf = local.new_zeros((dp.world * n, local.shape[1]))
        for g, l, rows in ranges:
            buf[g:g + rows] = local[l:l + rows]
        if dtype.is_floating_point:
            buf = all_reduce_sum(buf, dp)
        else:
            dist.all_reduce(buf, group=dp.group)
        col = 0
        for k, p in zip(ks, parts):
            v = buf[:, col:col + p.shape[1]].reshape(
                (dp.world * n,) + tuple(tree[k].shape[1:])).contiguous()
            out[k] = v.bool() if tree[k].dtype == torch.bool else v
            col += p.shape[1]
    return {k: out[k] for k in keys}


def gather_scenes(batch: Mapping, dp: Optional[DataParallel] = None
                  ) -> Dict[str, np.ndarray]:
    """A host batch (numpy arrays, leading axis the local scenes) as the
    global batch on every rank: the ranks' batches concatenated in rank
    order (`all_gather_object`, for host data such as a val batch's
    labels)."""
    dp = dp or _ACTIVE
    if dp is None:
        raise RuntimeError("gather_scenes outside data_parallel")
    parts = [None] * dp.world
    dist.all_gather_object(parts, {k: np.asarray(v) for k, v in
                                   batch.items()}, group=dp.group)
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _flat_groups(tensors: Iterable[torch.Tensor]):
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(_pack_key(t), []).append(t)
    return groups.values()


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.nn.Parameter],
                     dp: Optional[DataParallel] = None) -> None:
    """Every parameter's .grad averaged over the ranks, through one flat
    buffer a dtype (a parameter without a gradient counts as zero). After
    a backward through `gather_rows`, each rank's gradient is `world`
    times its rows' share of the global gradient, so the average is the
    global batch's gradient."""
    dp = dp or _ACTIVE
    if dp is None:
        raise RuntimeError("all_reduce_grads outside data_parallel")
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for grads in _flat_groups(p.grad for p in params):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=dp.group)
        flat /= dp.world
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(
            flat.split([g.numel() for g in grads]), grads)])


@torch.no_grad()
def _broadcast(tensors: Sequence[torch.Tensor], src: int, group) -> None:
    """Rank `src`'s values of `tensors` copied into every rank's, in place
    (one flat buffer a dtype and device)."""
    for ts in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=src, group=group)
        torch._foreach_copy_(ts, [v.view_as(t) for v, t in zip(
            flat.split([t.numel() for t in ts]), ts)])


def broadcast_state(state, src: int = 0, group=None) -> None:
    """Rank `src`'s train state on every rank (the reference's DDP start,
    where every rank takes rank 0's weights): the student's and the
    teacher's parameters and buffers, the optimiser's moments, and the step
    and update counts. Every rank must hold the same structure (the same
    model; moments present for the same parameters, as after loading one
    checkpoint)."""
    tensors = list(state.model.state_dict().values())
    if state.ema_model is not None:
        tensors += list(state.ema_model.state_dict().values())
    opt = state.optimizer
    device = next(state.model.parameters()).device
    for p in (p for g in opt.param_groups for p in g["params"]):
        tensors += [opt.state[p][k] for k in sorted(opt.state.get(p, {}))]
    counts = torch.tensor([state.step, opt.count, opt.mini_step],
                          dtype=torch.int64, device=device)
    _broadcast(tensors + [counts], src, group)
    state.step, opt.count, opt.mini_step = (int(c) for c in counts.tolist())
