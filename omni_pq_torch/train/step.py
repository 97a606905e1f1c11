"""The semi-supervised train step and the eval step (the port of
`omni_pq_tpu/train/step.py`).

One step = the student's train-mode forward (batch-statistic BatchNorm,
running stats updated in place, decoder dropout from the caller's
torch.Generator) on the labeled batch, or on the double batch (labeled ‖
weak) when any semi-supervised loss is on; the EMA teacher's forward on the
double batch's `ema_point_clouds`, in train mode under `torch.no_grad()`
(its BN running stats update in place, as the JAX step's
`new_ema_batch_stats`); the four loss families of the JAX step: supervised
`get_loss` on the labeled half, gamma-mixture pseudo-labels on the weak
half, mean-teacher consistency over the double batch (times the ramped
`consistency_weight`), the ARKit pc loss on the weak half; backward, the
global gradient norm before clipping (`grad_norm`), the clipped AdamW
update, and the EMA update of the teacher.

On a card, the third call in a row of a key (the shapes and dtypes of the
batches, the state, the generator, the compute dtypes of the model, the
kernels or plain versions that `ops` routes to, the TF32 switches)
captures the whole step as one CUDA graph, and every later call of the key
replays it: its batches are copied into the graph's inputs, its host
scalars (`state.StepScalars`: learning rates, bias corrections, the EMA's
alpha, the consistency weight) into their device buffer, and the stats
come back as fresh copies. The two calls before are the warm-up of
PyTorch's whole-network capture recipe, on the side stream that captures.
The caller's generator is registered with the graph, so its draws and its
state are those of the eager step. The host counters (`TrainState.step`,
`AdamW.count`) advance once a call; the kernels' launch counters
(`.launches` of the `ops` wrappers) count the calls made through the
wrappers, so a replayed call adds nothing to them. A state keeps at most
MAX_GRAPHS graphs for one step function; a key past them runs eagerly.
All graphs of a state, those of every step function on it, capture into
one memory pool, which holds the step's activations: replays never
overlap, and a replay reads nothing from the pool that an earlier replay
wrote (its outputs are copied before the call returns). Eager always: on
the CPU, inside `parallel.data_parallel` (its collectives) and with
step_freq > 1 (the accumulating mini-steps). A graph writes the state's
tensors in place: a state whose optimiser moments were replaced
(`load_optimizer_state`) is warmed up and captured again.

The generator's draws come in a fixed order: the student's dropout masks,
the teacher's dropout masks, then the gamma criterion's choice of quads and
points (`losses.gamma.draw_choice`). With TrainFlags(ema=False,
gamma_mixture=False, arkit=False) the step is the `sup` baseline of
docs/SEMI_SUP.md. The student computes at its config's compute_dtype;
`teacher_bf16` runs the teacher's forward at bfloat16 compute on the same
float32 EMA parameters and BN state (`models.with_compute_dtype`), and its
end points go to the consistency loss in float32, as the JAX step casts
them; losses stay float32.

Inside `parallel.data_parallel` (a process group of several ranks, each
with its local batch) the step computes the single-process step on the
global batch, as the JAX step does under a mesh: the forwards take global
BatchNorm statistics and global dropout masks (the local double batch is
declared as its [labeled | weak] segments); the student's and teacher's end
points and both batches are gathered to every rank (`parallel.gather_rows`,
rows [L_0 L_1 ... | W_0 W_1 ...]), so every loss module, normaliser, the
gamma draw and every stat run unchanged on the global batch, bitwise the
same on every rank; after the backward, `parallel.all_reduce_grads`
averages the gradients, which divides out the factor `world` that the
gather's backward puts on each rank's gradient; the clip, AdamW and the EMA
update then run on equal gradients, so every rank's state stays equal.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import ops, parallel
from ..config import ModelConfig
from ..infer import eval_forward
from ..models.pointnet2 import with_compute_dtype
from ..losses import (gamma_mixture_guide_criterion, get_arkit_pc_loss,
                      get_consistency_loss, get_loss)
from ..utils.trace import span
from .state import StepScalars, TrainState, global_norm

# eager calls of a graph key before the call that captures it
WARMUP_CALLS = 2
# graphs a state keeps for one step function; further keys run eagerly
MAX_GRAPHS = 2


@dataclasses.dataclass(frozen=True)
class TrainFlags:
    """Static loss toggles: the JAX package's TrainFlags, with the same
    names and defaults (the reference's semi-supervised configuration)."""
    ema: bool = True
    gamma_mixture: bool = True
    arkit: bool = False
    pc_loss: bool = True
    use_fitted_mixture: bool = False
    # the EMA teacher's forward at bfloat16 compute (its parameters and BN
    # state stay float32; the student and the losses keep their dtype)
    teacher_bf16: bool = False
    ema_decay: float = 0.999
    lambda_metric_normal: float = 5e-4
    lambda_metric_vertical: float = 5e-4
    lambda_metric_size: float = 5e-4
    lambda_metric_score: float = 5e-4
    lambda_arkit_pc_loss: float = 0.0
    near_threshold: float = 0.3
    far_threshold: float = 0.6


SUPERVISED = TrainFlags(ema=False, gamma_mixture=False, arkit=False)


def batch_to_tensors(batch: Mapping, device,
                     dtype: torch.dtype = torch.float32
                     ) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy arrays) as tensors on `device`: floats as
    `dtype` (float32; float64 for the float64 route, whose clouds and
    labels are float64), integers as int64, booleans kept."""
    out = {}
    for k, v in batch.items():
        if torch.is_tensor(v):
            out[k] = v.to(device)
            continue
        a = np.asarray(v)
        if a.dtype.kind == "f":
            a = a.astype({torch.float32: np.float32,
                          torch.float64: np.float64}[dtype])
        elif a.dtype.kind in "iu":
            a = a.astype(np.int64)
        elif a.dtype.kind != "b":
            continue
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


class _Graph:
    """One key's captured step: the graph, its static inputs (clones of
    the capturing call's batches), its scalars' buffer and the stats it
    writes."""

    def __init__(self, step, state: TrainState, batches, generator, values,
                 stream: torch.cuda.Stream):
        self.inputs = [None if b is None else {k: v.clone()
                                               for k, v in b.items()}
                       for b in batches]
        self.scalars = StepScalars.holding(values, stream.device)
        self.generator = generator  # registered: kept while the graph lives
        self.witness = _witness(state)
        state.optimizer.zero_grad(set_to_none=True)
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph, pool=_pool(state), stream=stream,
                              capture_error_mode="thread_local"):
            self.out = step(state, *self.inputs, generator, self.scalars)
        self.graph.replay()

    def replay(self, state: TrainState, batches, values
               ) -> Dict[str, torch.Tensor]:
        for static, batch in zip(self.inputs, batches):
            for k, v in (static or {}).items():
                v.copy_(batch[k])
        self.scalars.fill(values)
        state.count_replayed_step()
        self.graph.replay()
        return self.stats()

    def stats(self) -> Dict[str, torch.Tensor]:
        """Fresh copies of the stats of the last replay."""
        return {k: v.clone() for k, v in self.out.items()}


# state -> the memory pool that its graphs share
_POOLS = weakref.WeakKeyDictionary()
# device -> the stream that warms up and captures every step
_SIDE: Dict[torch.device, torch.cuda.Stream] = {}


def _pool(state: TrainState) -> tuple:
    if state not in _POOLS:
        _POOLS[state] = torch.cuda.graph_pool_handle()
    return _POOLS[state]


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _SIDE:
        _SIDE[device] = torch.cuda.Stream(device)
    return _SIDE[device]


def captures(device: torch.device, state: TrainState) -> bool:
    """Whether the step of `state` on `device` is captured and replayed:
    on a card, outside `parallel.data_parallel` (its collectives) and with
    step_freq 1 (no accumulating mini-steps)."""
    return (device.type == "cuda" and parallel.current() is None
            and state.optimizer.step_freq == 1)


def batch_key(device: torch.device, *batches: Optional[Mapping]
              ) -> Optional[tuple]:
    """The names, shapes and dtypes of the batches' tensors, in order; None
    where a batch holds anything else than a tensor on `device`."""
    key = []
    for batch in batches:
        for k, v in (batch or {}).items():
            if not torch.is_tensor(v) or v.device != device:
                return None
            key.append((k, v.shape, v.dtype))
        key.append(None)
    return tuple(key)


@dataclasses.dataclass
class _Captured:
    """A state's graphs for one step function, and the key of its last
    call that has no graph with the number of such calls in a row."""
    graphs: Dict[tuple, _Graph] = dataclasses.field(default_factory=dict)
    warm: Tuple[Optional[tuple], int] = (None, 0)


def _witness(state: TrainState) -> Optional[torch.Tensor]:
    """The first parameter's first AdamW moment: a new tensor there means
    the moments a graph writes were replaced."""
    opt = state.optimizer
    return opt.state.get(opt.param_groups[0]["params"][0], {}).get("mu")


def make_train_step(model, cfg: ModelConfig, mean_size_arr,
                    flags: TrainFlags = SUPERVISED):
    """Returns fn(state, labeled, weak=None, generator=None,
    consistency_weight=0.0) -> stats: one step on `state` (updated in place:
    parameters, optimiser moments, BN running stats of student and
    teacher, the EMA parameters, step). `labeled` and `weak` are batches of
    tensors on the model's device (`batch_to_tensors`); `weak` must be
    given when flags.ema, gamma_mixture or arkit is set, and `generator`
    when cfg.dropout > 0 or gamma_mixture is set. Stats are detached 0-d
    tensors under the JAX step's names: every `get_loss` stat, the gamma,
    consistency and ARKit stats of the flags that are on, `total_loss` and
    `grad_norm` (the global norm before clipping).

    While a profiler runs, the step records the spans of `utils.trace`:
    `train.step` around it, its phases `step.forward.student`,
    `step.forward.teacher`, `step.losses`, `step.backward` and
    `step.update` (these six with the allocations on the model's CUDA
    device), the losses' `losses.gather` (under `parallel.data_parallel`),
    `losses.supervised`, `losses.gamma`, `losses.consistency` and
    `losses.arkit` of the flags that are on, and the update's
    `update.all_reduce` (under `parallel.data_parallel`),
    `update.grad_norm`, `update.adamw` and `update.ema`. A replayed call
    records `train.step` with the counter `graph_replays` 1 (0 in an eager
    or capturing call) and inside it `step.replay` (the copies and the
    replay) alone: its phases ran on the card."""
    num_layer = cfg.num_decoder_layers
    double = flags.ema or flags.gamma_mixture or flags.arkit
    device = next(model.parameters()).device
    # on the device once: a copy from the host inside the step would stop
    # a capture (it synchronises)
    mean_size_arr = torch.as_tensor(np.asarray(mean_size_arr)).to(device)
    dtype_modules = [m for m in model.modules()
                     if getattr(m, "compute_dtype", None) is not None]
    captured = weakref.WeakKeyDictionary()  # state -> _Captured
    eager_scalars: Dict[Tuple[str, ...], StepScalars] = {}

    def _teacher_forward(teacher, clouds, generator):
        """The EMA teacher's train-mode forward under no_grad (bfloat16
        compute with teacher_bf16), its floating end points in float32."""
        teacher.train()
        try:
            with torch.no_grad():
                if flags.teacher_bf16:
                    with with_compute_dtype(teacher, torch.bfloat16):
                        ep = teacher(clouds, generator=generator)
                else:
                    ep = teacher(clouds, generator=generator)
        finally:
            teacher.eval()
        return {k: v.float() if v.is_floating_point() else v
                for k, v in ep.items()}

    def _losses(ep, ema_ep, labeled, weak, segments, B, generator, scalars):
        """The four loss families on the step's end points: (total, stats)."""
        dp = parallel.current()
        if dp is not None:  # the losses see the global batch
            with span("losses.gather"):
                ep = parallel.gather_rows(ep, segments)
                if flags.ema:
                    ema_ep = parallel.gather_rows(ema_ep, segments)
                labeled = parallel.gather_rows(labeled)
                if double:
                    weak = parallel.gather_rows(weak)
            B *= dp.world

        # 1. supervised loss on the labeled half
        with span("losses.supervised"):
            merged = {k: v[:B] for k, v in ep.items()}
            merged.update(labeled)
            total, stats = get_loss(merged, mean_size_arr,
                                    num_layer=num_layer,
                                    pc_loss=flags.pc_loss,
                                    near=flags.near_threshold,
                                    far=flags.far_threshold)

        # 2. gamma-mixture pseudo-labels on the weak half
        if flags.gamma_mixture:
            with span("losses.gamma"):
                gm_ep = {k: v[B:] for k, v in ep.items()}
                gm_ep["point_clouds"] = weak["point_clouds"][..., :3]
                gm_ep["vertex_normals"] = weak["vertex_normals"]
                mn, mv, ms, msc, engaged = gamma_mixture_guide_criterion(
                    gm_ep, generator, use_fitted=flags.use_fitted_mixture)
                gm_loss = (flags.lambda_metric_normal * mn
                           + flags.lambda_metric_vertical * mv
                           + flags.lambda_metric_size * ms
                           + flags.lambda_metric_score * msc)
                stats.update(metric_normal=mn, metric_vertical=mv,
                             metric_size=ms, metric_score=msc,
                             gamma_mixture_filter_loss=gm_loss,
                             gamma_engaged_frac=engaged)
                total = total + gm_loss

        # 3. mean-teacher consistency over the full double batch
        if flags.ema:
            with span("losses.consistency"):
                cons_ep = dict(ep)
                for key in ("flip_x_axis", "flip_y_axis", "rot_mat",
                            "scale"):
                    cons_ep[key] = torch.cat([labeled[key], weak[key]])
                cons_loss, cons_stats = get_consistency_loss(
                    cons_ep, ema_ep, mean_size_arr, num_layer=num_layer)
                cons_loss = cons_loss * scalars.read("consistency_weight",
                                                     cons_loss.dtype)
                stats.update(cons_stats)
                # cons_stats["consistency_loss"] is the reference's
                # per-prefix object mean; this is the ramped-weight total
                stats["weighted_consistency_loss"] = cons_loss
                total = total + cons_loss

        # 4. ARKit omni-supervised pc loss on the weak half
        if flags.arkit:
            with span("losses.arkit"):
                ark_loss, collisions = get_arkit_pc_loss(
                    ep, {k: weak[k] for k in ("center_label", "size_label",
                                              "num_gt_boxes")})
                ark_loss = ark_loss * flags.lambda_arkit_pc_loss
                stats["arkit_pc_loss"] = ark_loss
                stats["arkit_collisions"] = collisions
                total = total + ark_loss
        stats["total_loss"] = total
        return total, stats

    def _update(state, stats, scalars):
        """The global gradient (the mean over ranks under
        `parallel.data_parallel`), its norm, AdamW and the EMA update."""
        if parallel.current() is not None:
            with span("update.all_reduce"):
                parallel.all_reduce_grads(model.parameters())
        with span("update.grad_norm"), torch.no_grad():
            stats["grad_norm"] = global_norm(
                p.grad for p in model.parameters() if p.grad is not None)
        with span("update.adamw"):
            state.apply_gradients(scalars)
        if flags.ema:
            with span("update.ema"):
                state.ema_update(flags.ema_decay, scalars)
        return {k: torch.as_tensor(v).detach() for k, v in stats.items()}

    def _step(state: TrainState, labeled: Mapping,
              weak: Optional[Mapping], generator: Optional[torch.Generator],
              scalars: StepScalars) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the state holds another model than the step")
        if double and weak is None:
            raise ValueError("ema, gamma_mixture and arkit need a weak batch")
        if flags.ema and state.ema_model is None:
            raise ValueError("flags.ema needs a TrainState with ema=True")
        B = labeled["point_clouds"].shape[0]
        segments = (B,)
        if double:
            segments = (B, weak["point_clouds"].shape[0])
        ema_ep = None
        with parallel.batch_segments(*segments):
            with span("step.forward.student", device):
                inputs = labeled["point_clouds"]
                if double:
                    inputs = torch.cat([inputs, weak["point_clouds"]])
                model.train()
                ep = model(inputs, generator=generator)
            if flags.ema:
                with span("step.forward.teacher", device):
                    ema_ep = _teacher_forward(
                        state.ema_model,
                        torch.cat([labeled["ema_point_clouds"],
                                   weak["ema_point_clouds"]]), generator)
        with span("step.losses", device):
            total, stats = _losses(ep, ema_ep, labeled, weak, segments, B,
                                   generator, scalars)
        with span("step.backward", device):
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
        with span("step.update", device):
            return _update(state, stats, scalars)

    def _key(state, labeled, weak, generator):
        """What the captured step depends on, or None where the step runs
        eagerly."""
        if not captures(device, state):
            return None
        batches = batch_key(device, labeled, weak)
        if batches is None:
            return None
        return (batches, id(generator),
                tuple(dict.fromkeys(m.compute_dtype for m in dtype_modules)),
                ops.fps, ops.ball_query, ops.ball_query_group,
                ops.fused_mlp_pool, torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)

    def _eager(state, labeled, weak, generator, values):
        names = tuple(values)
        if names not in eager_scalars:
            eager_scalars[names] = StepScalars(names, device)
        scalars = eager_scalars[names]
        scalars.fill(values)
        return _step(state, labeled, weak, generator, scalars)

    def _on_side_stream(fn, *args):
        """fn(*args) on the side stream, ordered after and before the
        current stream's work."""
        current = torch.cuda.current_stream(device)
        stream = _side_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = fn(*args)
        current.wait_stream(stream)
        return out

    def train_step(state: TrainState, labeled: Mapping,
                   weak: Optional[Mapping] = None,
                   generator: Optional[torch.Generator] = None,
                   consistency_weight=0.0) -> Dict[str, torch.Tensor]:
        with span("train.step", device) as sp:
            values = state.optimizer.step_values()
            if flags.ema:
                values.update(state.ema_values(flags.ema_decay,
                                               state.step + 1))
                values["consistency_weight"] = float(consistency_weight)
            args = (state, labeled, weak, generator, values)
            key = _key(state, labeled, weak, generator)
            mine = (captured.setdefault(state, _Captured())
                    if key is not None else None)
            entry = mine.graphs.get(key) if mine is not None else None
            if entry is not None and entry.witness is not _witness(state):
                mine.graphs.clear()  # the moments were replaced
                entry = None
            sp.counter("graph_replays", int(entry is not None))
            if entry is not None:
                with span("step.replay"):
                    if not model.training:
                        model.train()
                    return entry.replay(state, (labeled, weak), values)
            if mine is None or len(mine.graphs) >= MAX_GRAPHS:
                return _eager(*args)
            last, calls = mine.warm
            mine.warm = key, (calls + 1 if last == key else 1)
            if mine.warm[1] <= WARMUP_CALLS:
                return _on_side_stream(_eager, *args)
            mine.warm = None, 0
            entry = mine.graphs[key] = _Graph(
                _step, state, (labeled, weak), generator, values,
                _side_stream(device))
            return entry.stats()

    return train_step


def make_eval_step():
    """Returns fn(state, point_clouds, use_ema=False) -> end_points: the
    eval-mode forward (running BN stats, no dropout) of the state's model or
    of its EMA replica."""

    def eval_step(state: TrainState, point_clouds, use_ema: bool = False):
        model = state.ema_model if use_ema else state.model
        if model is None:
            raise ValueError("use_ema=True on a TrainState without an EMA "
                             "replica")
        was_training = model.training
        model.eval()
        try:
            return eval_forward(model, point_clouds)
        finally:
            model.train(was_training)

    return eval_step
