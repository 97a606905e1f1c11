"""CLI argument surface matching the reference train.py:42-138 / eval.py
(same flag names; one parser shared by both drivers): the port's own copy
of `omni_pq_tpu/cli/args.py`, with the same flags, defaults and meanings,
and one more, --device ('cuda', the default, or 'cpu'). Quirk preserved:
print/save/val freq, max_epoch and consistency_rampup are divided by
end_proportion (label-rate-normalized epochs, train.py:128-132).

Two of the JAX package's flags are kept so that its scripts still parse,
and refused when set to anything but their defaults: --eval_quad_topk (the
TPU's packing of what the host fetches at eval; the port's eval decodes
every proposal) and --threefry (a choice of the TPU's PRNG; the port draws
from a torch.Generator). --multihost with --coordinator_address,
--num_processes and --process_id is data parallelism over
torch.distributed (`omni_pq_torch.parallel`), with --batch_size per
process, as in the JAX CLI."""
from __future__ import annotations

import argparse
import time


def build_parser(is_eval: bool = False) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    # Model
    parser.add_argument('--num_target', type=int, default=256)
    parser.add_argument('--quad_num_target', type=int, default=256)
    parser.add_argument('--sampling', default='vote', type=str)
    # Transformer
    parser.add_argument('--nhead', default=8, type=int)
    parser.add_argument('--num_decoder_layers', default=6, type=int)
    parser.add_argument('--dim_feedforward', default=2048, type=int)
    parser.add_argument('--transformer_dropout', default=0.1, type=float)
    parser.add_argument('--transformer_activation', default='relu', type=str)
    # Data
    parser.add_argument('--batch_size', type=int, default=3 if not is_eval else 16)
    parser.add_argument('--dataset', default='scannet')
    parser.add_argument('--data_root', default='data/scannet',
                        help='root dir of the preprocessed ScanNet layout')
    parser.add_argument('--arkit_data_root', default='data/arkitscenes')
    parser.add_argument('--num_point', type=int, default=40000)
    parser.add_argument('--use_height', action='store_true')
    parser.add_argument('--use_color', action='store_true')
    parser.add_argument('--num_workers', type=int, default=4)
    parser.add_argument('--arkit', action='store_true')
    parser.add_argument('--synthetic_data', action='store_true',
                        help='use the synthetic room generator (no data on disk)')
    # Dataset splitting
    parser.add_argument('--start_proportion', default=0.0, type=float)
    parser.add_argument('--end_proportion', default=0.1, type=float)
    # Training
    parser.add_argument('--start_epoch', type=int, default=1)
    parser.add_argument('--max_epoch', type=int, default=600)
    parser.add_argument('--optimizer', type=str, default='adamW')
    parser.add_argument('--weight_decay', type=float, default=0.0005)
    parser.add_argument('--learning_rate', type=float, default=0.002)
    parser.add_argument('--decoder_learning_rate', type=float, default=0.0001)
    parser.add_argument('--lr-scheduler', dest='lr_scheduler', type=str,
                        default='cosine', choices=['step', 'cosine'])
    parser.add_argument('--warmup-epoch', dest='warmup_epoch', type=int, default=-1)
    parser.add_argument('--warmup-multiplier', dest='warmup_multiplier',
                        type=int, default=100)
    parser.add_argument('--clip_norm', default=0.1, type=float)
    parser.add_argument('--bn_momentum', type=float, default=0.1)
    parser.add_argument('--syncbn', action='store_true')
    # Weak loss
    parser.add_argument('--gamma_mixture', action='store_true')
    parser.add_argument('--ema', action='store_true')
    parser.add_argument('--ema_decay', type=float, default=0.999)
    parser.add_argument('--consistency_weight', type=float, default=0.05)
    parser.add_argument('--consistency_rampup', type=int, default=1)
    parser.add_argument('--lambda_metric_normal', type=float, default=0.0010)
    parser.add_argument('--lambda_metric_vertical', type=float, default=0.0010)
    parser.add_argument('--lambda_metric_size', type=float, default=0.0010)
    parser.add_argument('--lambda_metric_score', type=float, default=0.0010)
    parser.add_argument('--lambda_arkit_pc_loss', type=float, default=0.0)
    parser.add_argument('--use_fitted_mixture', action='store_true',
                        help='label pseudo points with the EM-fitted mixture '
                             'instead of the reference\'s fixed initial one')
    # io
    parser.add_argument('--checkpoint_path', default=None)
    parser.add_argument('--log_dir',
                        default=f'log/{time.strftime("%Y%m%d-%H%M%S")}')
    parser.add_argument('--print_freq', type=int, default=10)
    parser.add_argument('--save_freq', type=int, default=10)
    parser.add_argument('--val_freq', type=int, default=1)
    parser.add_argument('--step_freq', type=int, default=1)
    # others
    parser.add_argument('--ap_iou_thresholds', type=float, default=[0.25],
                        nargs='+')
    parser.add_argument('--rng_seed', type=int, default=0)
    # multi-host data parallelism (the reference's torch.distributed.launch
    # surface, train.py:771-799); without --coordinator_address the
    # process group reads torchrun's environment
    parser.add_argument('--multihost', action='store_true',
                        help='data parallelism over torch.distributed '
                             '(--batch_size is per process)')
    parser.add_argument('--coordinator_address', default=None,
                        help='host:port of process 0 (default: cluster env)')
    parser.add_argument('--num_processes', type=int, default=None)
    parser.add_argument('--process_id', type=int, default=None)
    parser.add_argument('--profile', type=int, default=0, metavar='N',
                        help='trace N train steps (from the second) with '
                             'torch.profiler into <log_dir>/profile')
    parser.add_argument('--pc_loss', action='store_true')
    # extension flags (not in the reference): GT-assignment radii
    parser.add_argument('--near_threshold', type=float, default=0.3,
                        help='GT assignment NEAR radius in meters '
                             '(reference fixed 0.3, loss_helper_pq.py:17)')
    parser.add_argument('--far_threshold', type=float, default=0.6,
                        help='GT assignment FAR radius in meters '
                             '(reference fixed 0.6, loss_helper_pq.py:18)')
    parser.add_argument('--dump_result', action='store_true')
    # Eval
    parser.add_argument('--nms_iou_quad', type=float, default=0.25)
    parser.add_argument('--faster_eval', action='store_true')
    parser.add_argument('--smoke', action='store_true',
                        help='tiny model + tiny scenes for CI smoke runs')
    # bfloat16 compute is the default, as in the JAX CLI (parameters,
    # BatchNorm statistics, losses and the point kernels stay float32);
    # --f32 opts out, --bf16 is an accepted no-op. The library default
    # (ModelConfig.compute_dtype) stays float32.
    parser.add_argument('--bf16', action='store_true', default=True,
                        help='bfloat16 compute for the Dense path '
                             '(params and losses stay float32; the default)')
    parser.add_argument('--f32', dest='bf16', action='store_false',
                        help='full float32 compute (opt out of the bfloat16 '
                             'default; the reference itself ran TF32 matmuls)')
    parser.add_argument('--threefry', action='store_true',
                        help='refused: a choice of the JAX package\'s PRNG')
    parser.add_argument('--teacher_bf16', action='store_true',
                        help='run the EMA-teacher forward in bfloat16 '
                             '(soft consistency targets only; the student '
                             'and all losses stay float32)')
    parser.add_argument('--eval_quad_topk', type=int, default=0,
                        help='refused unless 0: the JAX package\'s '
                             'packing of the eval fetch')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    return parser


def parse_option(argv=None, is_eval: bool = False):
    parser = build_parser(is_eval)
    args = parser.parse_args(argv)
    # Flags kept for reference CLI parity but with only the reference's
    # default behavior implemented: error on unsupported values instead of
    # silently ignoring them. (--syncbn needs no plumbing: the whole global
    # batch normalizes under one jitted step, which IS sync-BN semantics.)
    if args.sampling != 'vote':
        parser.error(f"--sampling {args.sampling}: only 'vote' is "
                     "implemented (the reference default)")
    if args.transformer_activation != 'relu':
        parser.error(f"--transformer_activation {args.transformer_activation}:"
                     " only 'relu' is implemented (the reference default)")
    if args.lr_scheduler != 'cosine':
        parser.error(f"--lr-scheduler {args.lr_scheduler}: only 'cosine' is "
                     "implemented (the reference's training regime)")
    if args.optimizer.lower() != 'adamw':
        parser.error(f"--optimizer {args.optimizer}: only adamW is "
                     "implemented (the reference default)")
    if args.bn_momentum != 0.1:
        parser.error("--bn_momentum: fixed at the reference default 0.1 "
                     "(flax momentum 0.9); plumbing a non-default value is "
                     "not implemented")
    refused = {
        '--eval_quad_topk': (args.eval_quad_topk != 0,
                             "the TPU's packing of the eval fetch; the "
                             "port's eval decodes every proposal"),
        '--threefry': (args.threefry, "a choice of the JAX package's PRNG; "
                       "the port draws from a torch.Generator"),
    }
    for flag, (is_set, why) in refused.items():
        if is_set:
            parser.error(f"{flag}: not supported by the port: {why}")
    if not is_eval:
        args.print_freq = int(args.print_freq / args.end_proportion)
        args.save_freq = int(args.save_freq / args.end_proportion)
        args.val_freq = int(args.val_freq / args.end_proportion)
        args.max_epoch = int(args.max_epoch / args.end_proportion)
        args.consistency_rampup = int(args.consistency_rampup / args.end_proportion)
    return args
