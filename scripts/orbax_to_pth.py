#!/usr/bin/env python
"""Convert a JAX package checkpoint (orbax) into a `.pth` of the PyTorch
port, so that the port's train CLI resumes from it and its eval and infer
CLIs load it.

The checkpoint is restored with `omni_pq_tpu.train.load_checkpoint` into a
state skeleton built from the JAX CLI's model flags (which must be those of
the run that wrote it, e.g. --smoke --num_point 512, --step_freq N). The
student and the EMA teacher go through `interop.from_jax.flax_to_state_dict`;
the AdamW moments of optax's two parameter groups (base and decoder,
`omni_pq_tpu/train/state.py:69-77`) are merged and laid out the same way,
onto the port's parameter names, with optax's update count and, under
--step_freq > 1, MultiSteps' accumulated gradients and position. The file
is written by the port's `save_checkpoint` as `<out_dir>/ckpt_epoch_{tag}.pth`
(a periodic checkpoint's tag is its epoch), with the JAX step count. The
epoch stored is the one `omni_pq_tpu.train.load_checkpoint` reports (its
sentinels for 'last', 'best' and 'ema_best'), which the port's loader maps
the same way.

Usage:
  python scripts/orbax_to_pth.py log/run/ckpt_epoch_last out_dir/ [--smoke ...]
  # then: python -m omni_pq_torch.cli.eval \
  #           --checkpoint_path out_dir/ckpt_epoch_last.pth [--smoke ...]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def adam_moments(opt_state):
    """(count, mu, nu) of optax's ScaleByAdamState leaves in `opt_state`,
    the groups' masked trees merged into one tree of the parameters."""
    import optax

    found = []

    def walk(node):
        if isinstance(node, optax.ScaleByAdamState):
            found.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, tuple):
            for v in node:
                walk(v)

    walk(opt_state)
    if not found:
        raise ValueError("no AdamW state in the checkpoint's optimiser")
    mu, nu = {}, {}
    for s in found:
        for k, v in s.mu.items():
            if not isinstance(v, optax.MaskedNode):
                mu[k], nu[k] = v, s.nu[k]
    counts = {int(s.count) for s in found}
    if len(counts) != 1:
        raise ValueError(f"the parameter groups disagree on the count {counts}")
    return counts.pop(), mu, nu


def convert(ckpt_path: str, out_dir: str, model_argv, step_freq: int = 1):
    """Write the port's .pth of the orbax checkpoint `ckpt_path`; returns
    its path."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from omni_pq_tpu.cli.args import parse_option as jax_parse_option
    from omni_pq_tpu.cli.train import make_model_config as jax_model_config
    from omni_pq_tpu.models import PQTransformer as JaxPQTransformer
    from omni_pq_tpu.train import (OptimizerConfig as JaxOptimizerConfig,
                                   create_train_state, load_checkpoint)
    from omni_pq_torch.cli.args import parse_option
    from omni_pq_torch.cli.train import make_model_config
    from omni_pq_torch.infer import build_model
    from omni_pq_torch.interop import flax_to_state_dict
    from omni_pq_torch.train import (OptimizerConfig, TrainState,
                                     save_checkpoint)
    from omni_pq_torch.train.checkpoint import load_optimizer_state

    jcfg = jax_model_config(jax_parse_option(model_argv, is_eval=True))
    jmodel = JaxPQTransformer(jcfg)
    rng = np.random.default_rng(0)
    cloud = rng.uniform(0.5, 4.0, (1, jcfg.num_points,
                                   3 + jcfg.input_feature_dim))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.asarray(cloud, jnp.float32))
    jstate = create_train_state(variables,
                                JaxOptimizerConfig(step_freq=step_freq))
    jstate, epoch, tag = load_checkpoint(ckpt_path, jstate)
    jstate = jax.device_get(jstate)

    cfg = make_model_config(parse_option(model_argv + ["--device", "cpu"],
                                         is_eval=True))
    state = TrainState(build_model(cfg, "cpu"), OptimizerConfig(), ema=True)
    state.model.load_state_dict(flax_to_state_dict(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    state.ema_model.load_state_dict(flax_to_state_dict(
        {"params": jstate.ema_params,
         "batch_stats": jstate.ema_batch_stats}))

    opt_state, mini_step, acc = jstate.opt_state, 0, None
    if isinstance(opt_state, optax.MultiStepsState):
        mini_step, acc = int(opt_state.mini_step), opt_state.acc_grads
        opt_state = opt_state.inner_opt_state
    count, mu, nu = adam_moments(opt_state)

    def by_name(tree):
        return flax_to_state_dict({"params": tree,
                                   "batch_stats": jstate.batch_stats})
    trees = {"mu": by_name(mu), "nu": by_name(nu)}
    if acc is not None:
        trees["acc"] = by_name(acc)
    moments = {}
    for name, p in state.model.named_parameters():
        moments[name] = {k: t[name] for k, t in trees.items()}
        for k, v in moments[name].items():
            if v.shape != p.shape:
                raise ValueError(f"{name}: {k} of shape {tuple(v.shape)}, "
                                 f"parameter {tuple(p.shape)}")
    load_optimizer_state(state, {"state": moments, "count": count,
                                 "mini_step": mini_step})
    state.step = int(jstate.step)
    return save_checkpoint(out_dir, tag or epoch, state, epoch)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="Other arguments are the JAX CLI's model flags.")
    ap.add_argument("checkpoint", help="orbax checkpoint directory")
    ap.add_argument("out_dir", help="directory for the .pth")
    ap.add_argument("--step_freq", type=int, default=1,
                    help="the run's --step_freq (optax.MultiSteps)")
    args, model_argv = ap.parse_known_args(argv)
    path = convert(args.checkpoint, args.out_dir, model_argv, args.step_freq)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
