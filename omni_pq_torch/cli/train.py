"""Training CLI (the port of `omni_pq_tpu/cli/train.py`).

The same flag surface (`cli/args.py`, the JAX CLI's flags, defaults and
epoch normalisation by --end_proportion) and the same loop: labeled batches
of ScanNet (--data_root), or synthetic rooms with --synthetic_data, each
step with a weak batch from an endless stream when --ema, --gamma_mixture
or --arkit is on (ScanNet's whole train split, or ARKitScenes' weak boxes
with --arkit); the per-iteration cosine LR with --warmup-epoch; means of
every stat of the step every --print_freq steps in <log_dir>/metrics.jsonl (as
{"step", "time", "train/<stat>": value}, with the wall ms a step and the
host ms a step spent waiting for the loaders); evaluation of the student
and the EMA teacher (quad F1, object mAP and AR, and the eval-time loss
stats under eval_student/ and eval_ema/) every --val_freq epochs; the
best / ema_best / periodic / last checkpoints (`train/checkpoint.py`);
resume from --checkpoint_path at the epoch after the file's; --profile N
writes a torch.profiler trace of N steps (from the second) to
<log_dir>/profile, with summary.json: the window's wall and device ms, and
from the port's spans (`utils.trace`) the host ms a step in each span
(`train.step` and its phases, the losses, the update, the model's stages,
the kernels' launches, and `train.loader_wait`, the wait for each step's
batches) and the allocations a step.

One difference from the JAX loop: each evaluation pass draws the val
clouds again from the val dataset's seed (`reseed()`), so every pass, and
the eval CLI, scores the same clouds; the JAX loop draws on from one
stream. Runs on the card unless --device cpu is given. The model computes
in bfloat16 by default (--f32 opts out).

--multihost trains data-parallel over torch.distributed (`parallel`), as
the JAX CLI over its mesh: one process a card (NCCL; --device cpu: gloo
ranks on the CPU), the group from --coordinator_address / --num_processes
/ --process_id or from torchrun's environment; --batch_size scenes a
process from its shard of the labeled split, the same weak batches on
every process, each step the single-process step on the global batch;
evaluation over the sharded val split with the full-set metrics on every
process; rank 0 alone writes config.json, metrics.jsonl, the profile and
the checkpoints, and every rank logs to <log_dir>/log.rank<r>.txt.

Run:  python -m omni_pq_torch.cli.train --ema --gamma_mixture --pc_loss \
          --end_proportion 0.1 --data_root <scannet_root>
      (add --synthetic_data for a run without data on disk, and --smoke
      --num_point 512 --device cpu for a tiny CPU run)
      torchrun --nproc_per_node N -m omni_pq_torch.cli.train --multihost ...
      (N cards; add --device cpu for N gloo ranks on the CPU)
"""
from __future__ import annotations

import json
import os
import sys
import time

from .args import parse_option

# the step stats the log line shows (the JAX loop's list; metrics.jsonl
# gets every stat's mean)
SHOWN_STATS = ("total_loss", "loss", "vote_loss", "objectness_loss",
               "box_loss", "quad_loss_sum", "consistency_loss",
               "weighted_consistency_loss", "gamma_mixture_filter_loss",
               "arkit_pc_loss", "arkit_collisions", "grad_norm")
# a val batch with these keys carries the full label set
LOSS_KEYS = ("vote_label", "center_label", "gt_quad_centers")


def make_model_config(args):
    from ..config import SMOKE_MODEL, ModelConfig
    kw = dict(
        num_proposal=args.num_target, num_quad_proposal=args.quad_num_target,
        num_decoder_layers=args.num_decoder_layers, nhead=args.nhead,
        dim_feedforward=args.dim_feedforward,
        dropout=args.transformer_dropout, num_points=args.num_point,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        input_feature_dim=int(args.use_color) * 3 + int(args.use_height))
    if args.smoke:
        kw.update(SMOKE_MODEL)
    return ModelConfig(**kw)


def get_datasets(args):
    """(labeled, weak, val) datasets of the run."""
    from ..data import (ARKitSceneDataset, ScannetDetectionDataset,
                        SyntheticDataset)
    if args.synthetic_data:
        return (SyntheticDataset(32, args.num_point, seed=args.rng_seed),
                SyntheticDataset(32, args.num_point, seed=args.rng_seed + 1),
                SyntheticDataset(8, args.num_point, seed=args.rng_seed + 2))
    labeled = ScannetDetectionDataset(
        args.data_root, "train", num_points=args.num_point,
        use_color=args.use_color, use_height=args.use_height, augment=False,
        start_proportion=args.start_proportion,
        end_proportion=args.end_proportion, seed=args.rng_seed)
    if args.arkit:
        # omni-supervised mode: weak ARKit boxes for training, the
        # human-annotated ARKit valid split for evaluation (train.py:230-253)
        weak = ARKitSceneDataset(args.arkit_data_root, "train",
                                 num_points=args.num_point,
                                 seed=args.rng_seed + 1)
        val = ARKitSceneDataset(args.arkit_data_root, "valid",
                                num_points=args.num_point,
                                seed=args.rng_seed + 2)
    else:
        weak = ScannetDetectionDataset(
            args.data_root, "train", num_points=args.num_point,
            use_color=args.use_color, use_height=args.use_height,
            augment=False, start_proportion=0.0, end_proportion=1.0,
            seed=args.rng_seed + 1)
        val = ScannetDetectionDataset(
            args.data_root, "val", num_points=args.num_point,
            use_color=args.use_color, use_height=args.use_height,
            augment=False, seed=args.rng_seed + 2)
    return labeled, weak, val


def evaluate(args, state, val_loader, dataset_config, logger, use_ema=False,
             max_batches=None, metrics=None, epoch=0):
    """evaluate_one_epoch (train.py:609-768): the eval forward of the
    student (or the teacher, `use_ema`) on every val batch, quad F1 and
    object mAP / AR at each --ap_iou_thresholds (skipped under
    --faster_eval), and the eval-time supervised loss stats (train.py:
    638-668) on batches that carry the full label set, whose means are
    logged and written under eval_{student|ema}/. Returns the quad F1.

    Inside `parallel.data_parallel` (a sharded val loader, the same number
    of scenes on every rank), each rank forwards its shard, the end points
    and the batch are gathered to every rank (rows rank by rank), and every
    rank computes the full-set metrics and the loss stats of the global
    batches, as the JAX CLI's multi-process evaluation (its
    cli/train.py:144-172): the loader's wrap-around padding scenes count,
    as there."""
    import torch

    from .. import parallel
    from ..config import SCANNET_MEAN_SIZES
    from ..evals import (APCalculator, QuadAPCalculator, parse_groundtruths,
                         parse_predictions, parse_quad_groundtruths,
                         parse_quad_predictions)
    from ..losses import get_loss
    from ..train import batch_to_tensors, make_eval_step

    config_dict = {"remove_empty_box": False, "use_3d_nms": True,
                   "nms_iou": 0.25, "use_old_type_nms": False,
                   "cls_nms": True, "per_class_proposal": True,
                   "conf_thresh": 0.0, "quad_thresh": 0.5,
                   "dataset_config": dataset_config,
                   "nms_iou_quad": args.nms_iou_quad}
    quad_calc = QuadAPCalculator(ap_iou_thresh=args.ap_iou_thresholds[0])
    obj_calcs = {t: APCalculator(ap_iou_thresh=t)
                 for t in args.ap_iou_thresholds}
    eval_step = make_eval_step()
    model = state.ema_model if use_ema else state.model
    device = next(model.parameters()).device
    num_layer = model.cfg.num_decoder_layers
    loss_sums: dict = {}
    loss_batches = 0
    dp = parallel.current()
    val_loader.dataset.reseed()
    for bi, batch in enumerate(val_loader):
        if max_batches is not None and bi >= max_batches:
            break
        ep = eval_step(state, batch["point_clouds"], use_ema=use_ema)
        if dp is not None:  # the global batch on every rank
            ep = parallel.gather_rows(ep)
            batch = parallel.gather_scenes(batch)
        if all(k in batch for k in LOSS_KEYS):
            merged = dict(ep)
            merged.update(batch_to_tensors(batch, device))
            with torch.no_grad():
                _, stats = get_loss(merged, SCANNET_MEAN_SIZES,
                                    num_layer=num_layer)
            for k, v in stats.items():
                loss_sums[k] = loss_sums.get(k, 0.0) + float(v)
            loss_batches += 1
        # what the decode reads, on the host in float32 (the JAX loop's
        # packed fetch)
        ep = {k: v.float().cpu().numpy() for k, v in ep.items()
              if k.startswith("last_")}
        merged = dict(ep)
        merged.update(batch)
        pred_cls, _, pred_corners = parse_quad_predictions(
            merged, config_dict, "last_")
        gt_cls, gt_corners = parse_quad_groundtruths(merged, config_dict)
        quad_calc.step(pred_cls, gt_cls, pred_corners, gt_corners,
                       list(batch["horizontal_quads"]))
        # ARKit valid batches carry quad GT only (arkitscenes_dataset.py
        # valid split): object mAP needs the full ScanNet label set
        if not args.faster_eval and "box_label_mask" in batch:
            obj_pred, _ = parse_predictions(merged, config_dict, "last_")
            obj_gt = parse_groundtruths(merged, config_dict)
            for calc in obj_calcs.values():
                calc.step(obj_pred, obj_gt)
        if args.dump_result and bi == 0 and parallel.rank() == 0:
            from ..utils.viz import dump_object_results, dump_quad_results
            dump_dir = os.path.join(args.log_dir, "dump")
            dump_quad_results(ep, dump_dir)
            dump_object_results(ep, dataset_config, dump_dir)

    f1 = quad_calc.compute_F1(calculated=True)
    tag = "ema" if use_ema else "student"
    if loss_batches:
        means = {k: v / loss_batches for k, v in sorted(loss_sums.items())}
        shown = {k: means[k] for k in ("loss", "vote_loss", "objectness_loss",
                                       "box_loss", "quad_loss_sum")
                 if k in means}
        logger.info(f"[eval:{tag}] " + " ".join(
            f"{k} {v:.4f}" for k, v in shown.items()))
        if metrics is not None:
            metrics.log(epoch, means, prefix=f"eval_{tag}")
    logger.info(f"[eval:{tag}] quad F1 = {f1:.4f}")
    if not args.faster_eval:
        for t, calc in obj_calcs.items():
            m = calc.compute_metrics()
            logger.info(f"[eval:{tag}] mAP@{t} = {m['mAP']:.4f} "
                        f"AR = {m['AR']:.4f}")
    return f1


def batches(train_loader, weak_iter):
    """(labeled batch, weak batch or None) pairs, each fetch under the span
    `train.loader_wait`."""
    from ..utils.trace import span
    labeled = iter(train_loader)
    while True:
        with span("train.loader_wait"):
            batch = next(labeled, None)
            if batch is None:
                return
            weak = next(weak_iter) if weak_iter is not None else None
        yield batch, weak


class StepProfiler:
    """--profile N: a torch.profiler trace of steps 2 .. N+1 (from the end
    of step 1, so the window holds the waits for their batches), written
    to <log_dir>/profile/trace.json, with summary.json: the window's wall
    ms (host clock, synchronised), the device's kernel ms and their
    ratio, and from the spans the window recorded (`utils.trace`) the host
    ms a step in each span name and the allocations a step (the counter
    of `train.step`, on a card). `after_step` returns the seconds it took
    itself, which the loop keeps out of its step times."""

    def __init__(self, steps: int, log_dir: str, device):
        self.steps = steps
        self.dir = os.path.join(log_dir, "profile")
        self.device = device
        self.prof = None

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def after_step(self, global_step: int, logger) -> float:
        if not self.steps or global_step not in (1, 1 + self.steps):
            return 0.0
        t_in = time.perf_counter()
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from ..utils import trace
        if global_step == 1:
            activities = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            self._sync()
            trace.clear()
            self.prof = profile(activities=activities)
            self.prof.start()
            self.t0 = time.perf_counter()
        elif self.prof is not None and global_step == 1 + self.steps:
            self._sync()
            wall_ms = (time.perf_counter() - self.t0) * 1e3
            self.prof.stop()
            events = [e for e in self.prof.key_averages()
                      if not e.is_user_annotation]
            device_ms = sum(e.self_device_time_total for e in events
                            if e.device_type == DeviceType.CUDA) / 1e3
            os.makedirs(self.dir, exist_ok=True)
            self.prof.export_chrome_trace(os.path.join(self.dir,
                                                       "trace.json"))
            summary = {"steps": self.steps, "wall_ms": wall_ms,
                       "device_ms": device_ms,
                       "busy_share": device_ms / wall_ms,
                       **span_summary(trace.records(), self.steps)}
            trace.clear()
            with open(os.path.join(self.dir, "summary.json"), "w") as f:
                json.dump(summary, f, indent=1)
            logger.info(f"profiler trace ({self.steps} steps) written to "
                        f"{self.dir}: {summary}")
            self.prof = None
        return time.perf_counter() - t_in


def span_summary(records, steps: int) -> dict:
    """Host ms a step in each span name, and the allocations a step (None
    off a card), from the spans of `steps` steps."""
    ns = {}
    for r in records:
        ns[r.name] = ns.get(r.name, 0) + r.t1_ns - r.t0_ns
    allocs = [r.counters["allocations"] for r in records
              if r.name == "train.step" and "allocations" in r.counters]
    return {"host_ms_per_step": {k: v / 1e6 / steps for k, v in
                                 sorted(ns.items(), key=lambda kv: -kv[1])},
            "allocations_per_step": sum(allocs) / steps if allocs else None}


def main(argv=None):
    args = parse_option(argv)

    import torch.distributed as dist

    from .. import parallel
    from ..infer import resolve_device

    if not args.multihost:
        return train(args, resolve_device(args.device))
    # before any other device access (the reference's init_process_group,
    # train.py:775-776, before model.cuda())
    device = parallel.init_distributed(args.coordinator_address,
                                       args.num_processes, args.process_id,
                                       device=args.device)
    try:
        with parallel.data_parallel():
            return train(args, device)
    finally:
        dist.destroy_process_group()


def train(args, device):
    """The training loop on `device`; data-parallel over the process group
    inside `parallel.data_parallel`. Returns (best F1, best teacher F1)."""
    import torch

    from .. import parallel
    from ..config import SCANNET_MEAN_SIZES, DatasetConfig
    from ..data import Loader, PrefetchLoader, endless
    from ..infer import build_model
    from ..train import (OptimizerConfig, TrainFlags, TrainState,
                         batch_to_tensors, consistency_weight,
                         load_checkpoint, make_train_step, save_checkpoint)
    from ..utils.logger import setup_logger
    from ..utils.metrics import MetricsLogger

    dp = parallel.current()
    rank, world = (dp.rank, dp.world) if dp is not None else (0, 1)
    lead = rank == 0  # writes the files of the run
    os.makedirs(args.log_dir, exist_ok=True)
    logger = setup_logger(args.log_dir, distributed_rank=rank)
    logger.info(" ".join(sys.argv))
    if lead:
        with open(os.path.join(args.log_dir, "config.json"), "w") as f:
            json.dump(vars(args), f, indent=2)
    metrics = MetricsLogger(args.log_dir) if lead else None

    labeled_ds, weak_ds, val_ds = get_datasets(args)
    logger.info(f"datasets: labeled {len(labeled_ds)} weak {len(weak_ds)} "
                f"val {len(val_ds)}" + (f"; rank {rank} of {world}"
                                        if dp is not None else ""))
    # --batch_size scenes a process, from its shard of the labeled and val
    # splits (the JAX CLI's cli/train.py:292-302)
    train_loader = PrefetchLoader(
        Loader(labeled_ds, args.batch_size, seed=args.rng_seed,
               shard_id=rank, num_shards=world),
        num_workers=args.num_workers)
    val_loader = Loader(val_ds, min(16, len(val_ds)), shuffle=False,
                        drop_last=False, shard_id=rank, num_shards=world)
    flags = TrainFlags(
        ema=args.ema, gamma_mixture=args.gamma_mixture, arkit=args.arkit,
        pc_loss=args.pc_loss, use_fitted_mixture=args.use_fitted_mixture,
        teacher_bf16=args.teacher_bf16, ema_decay=args.ema_decay,
        lambda_metric_normal=args.lambda_metric_normal,
        lambda_metric_vertical=args.lambda_metric_vertical,
        lambda_metric_size=args.lambda_metric_size,
        lambda_metric_score=args.lambda_metric_score,
        lambda_arkit_pc_loss=args.lambda_arkit_pc_loss,
        near_threshold=args.near_threshold, far_threshold=args.far_threshold)
    weak_iter = None
    if flags.ema or flags.gamma_mixture or flags.arkit:
        # not sharded: every process feeds the same weak batches, as the
        # JAX CLI does (its cli/train.py:297-299)
        weak_iter = endless(PrefetchLoader(
            Loader(weak_ds, args.batch_size, seed=args.rng_seed + 1),
            num_workers=args.num_workers))

    cfg = make_model_config(args)
    dataset_config = DatasetConfig()
    model = build_model(cfg, device, seed=args.rng_seed)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model: {n_params / 1e6:.2f}M params on {device}")

    iters_per_epoch = max(len(train_loader), 1)
    warmup_steps = (args.warmup_epoch * iters_per_epoch
                    if args.warmup_epoch > 0 else 0)
    opt_cfg = OptimizerConfig(
        learning_rate=args.learning_rate,
        decoder_learning_rate=args.decoder_learning_rate,
        weight_decay=args.weight_decay, clip_norm=args.clip_norm,
        total_steps=(args.max_epoch - max(args.warmup_epoch, 0))
        * iters_per_epoch,
        warmup_steps=warmup_steps, warmup_multiplier=args.warmup_multiplier,
        step_freq=args.step_freq)
    state = TrainState(model, opt_cfg, ema=True)
    start_epoch = args.start_epoch
    if args.checkpoint_path:  # every rank loads the file
        state, ckpt_epoch, _ = load_checkpoint(args.checkpoint_path, state)
        start_epoch = ckpt_epoch + 1
        logger.info(f"resumed from {args.checkpoint_path} at epoch "
                    f"{ckpt_epoch}")
    if dp is not None:  # every rank starts from rank 0's state
        parallel.broadcast_state(state)
    train_step = make_train_step(model, cfg, SCANNET_MEAN_SIZES, flags)
    generator = torch.Generator(device).manual_seed(args.rng_seed + 123)
    profiler = StepProfiler(args.profile if lead else 0, args.log_dir,
                            device)

    f1, ema_f1, max_f1, max_ema_f1 = 0.0, 0.2, 0.0, 0.2
    global_step = 0
    for epoch in range(start_epoch, args.max_epoch + 1):
        train_loader.set_epoch(epoch)
        tic = time.time()
        cw = consistency_weight(epoch, args.consistency_weight,
                                args.consistency_rampup)
        stat_acc, n_acc, data_s = {}, 0, 0.0
        window_t0 = t0 = time.perf_counter()
        for batch_idx, (batch, weak) in enumerate(batches(train_loader,
                                                          weak_iter)):
            data_s += time.perf_counter() - t0  # waiting for the loaders
            stats = train_step(
                state, batch_to_tensors(batch, device),
                batch_to_tensors(weak, device) if weak is not None else None,
                generator=generator, consistency_weight=cw)
            global_step += 1
            window_t0 += profiler.after_step(global_step, logger)
            for key, v in stats.items():  # summed on the device
                stat_acc[key] = stat_acc[key] + v if key in stat_acc else v
            n_acc += 1
            if (batch_idx + 1) % args.print_freq == 0:
                sums = torch.stack([v.to(device, torch.float32)
                                    for v in stat_acc.values()])
                means = {k: s / n_acc for k, s in zip(stat_acc,
                                                      sums.tolist())}
                now = time.perf_counter()
                means["step_ms"] = (now - window_t0) * 1e3 / n_acc
                means["data_ms"] = data_s * 1e3 / n_acc
                logger.info(f"Train: [{epoch}][{batch_idx + 1}/"
                            f"{len(train_loader)}] " + " ".join(
                                f"{k} {means[k]:.4f}" for k in
                                (*SHOWN_STATS, "step_ms", "data_ms")
                                if k in means))
                if metrics is not None:
                    metrics.log(global_step, means, prefix="train")
                stat_acc, n_acc, data_s, window_t0 = {}, 0, 0.0, now
            t0 = time.perf_counter()
        logger.info(f"epoch {epoch}, total time {time.time() - tic:.2f}s")

        if epoch % args.val_freq == 1 or args.val_freq == 1:
            f1 = evaluate(args, state, val_loader, dataset_config, logger,
                          use_ema=False, metrics=metrics, epoch=epoch)
            ema_f1 = evaluate(args, state, val_loader, dataset_config,
                              logger, use_ema=True, metrics=metrics,
                              epoch=epoch)
            if metrics is not None:
                metrics.log(global_step, {"quad_f1": f1,
                                          "ema_quad_f1": ema_f1,
                                          "epoch": epoch}, prefix="eval")
            if f1 > max_f1:
                if lead:
                    save_checkpoint(args.log_dir, "best", state, epoch)
                max_f1 = f1
            if ema_f1 > max_ema_f1:
                if lead:
                    save_checkpoint(args.log_dir, "ema_best", state, epoch)
                max_ema_f1 = ema_f1
        if lead and epoch % args.save_freq == 0:
            save_checkpoint(args.log_dir, epoch, state, epoch)

    if lead:
        save_checkpoint(args.log_dir, "last", state, args.max_epoch)
        metrics.close()
    logger.info(f"done; best F1 {max_f1:.4f} ema {max_ema_f1:.4f}")
    return max_f1, max_ema_f1

if __name__ == "__main__":
    main()
