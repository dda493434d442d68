"""Carry a run trained with the JAX package into the PyTorch port.

    python scripts/orbax_to_ckpt.py LOGDIR [--step N] [--out DIR]

Restores the orbax checkpoint under ``LOGDIR/checkpoint/`` (the newest
step, or ``--step N``) with the JAX package's ``CheckpointManager`` into
the template of ``create_train_state``, and writes
``DIR/checkpoint_{step}.ckpt`` (``DIR`` defaults to ``LOGDIR``) in the
layout of ``ddnerf_tpu_torch/train/checkpoint.py::save_train_checkpoint``,
with ``LOGDIR/config.yml`` copied beside it:

* the networks, through ``ddnerf_tpu_torch/utils/weights.py::
  params_to_state_dict`` (kernels transposed to ``nn.Linear`` weights);
* optax's ``scale_by_adam`` state as torch Adam's, per parameter in the
  port's order (coarse network first): ``mu`` -> ``exp_avg``, ``nu`` ->
  ``exp_avg_sq`` (transposed as the weights are), ``count`` -> ``step``;
* in place of a generator state, the marker
  ``ddnerf_tpu_torch.train.checkpoint.GENERATOR_SEED_KEY``: a JAX random
  key has no counterpart among the port's generator states, so a run
  resumed from the file draws from a generator seeded from
  ``experiment.randomseed`` and the step.

The port's eval and video CLIs read the directory as they read a logdir
of their own, and its train CLI resumes from it.  Run it where JAX and
orbax are installed; copy the directory to the machine with the card.
"""

import argparse
import os
import shutil
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def adam_state_dict(opt_state, nets):
    """optax ``(ScaleByAdamState, ScaleByScheduleState)`` -> the state dict
    of the port's ``torch.optim.Adam`` over ``nets`` (``[(name, module)]``,
    the port's parameter order)."""
    import torch

    from ddnerf_tpu_torch.utils.weights import params_to_state_dict

    adam = opt_state[0]
    count = int(np.asarray(adam.count))
    state, idx = {}, 0
    for name, module in nets:
        mu = params_to_state_dict(adam.mu[name])
        nu = params_to_state_dict(adam.nu[name])
        for pname, p in module.named_parameters():
            if mu[pname].shape != p.shape:
                raise ValueError(f"{name}/{pname}: the JAX moment is "
                                 f"{tuple(mu[pname].shape)}, the port's "
                                 f"parameter {tuple(p.shape)}")
            state[idx] = {"step": torch.tensor(float(count)),
                          "exp_avg": mu[pname], "exp_avg_sq": nu[pname]}
            idx += 1
    return state, count


def convert(logdir: str, step=None, out=None) -> str:
    """Write the port's checkpoint of the JAX run in ``logdir``; returns
    its path."""
    import jax

    from ddnerf_tpu.models.nerf import NerfPipeline as JaxPipeline
    from ddnerf_tpu.train import checkpoint as jax_ckpt
    from ddnerf_tpu.train.state import create_train_state
    from ddnerf_tpu_torch.config import Config
    from ddnerf_tpu_torch.models.nerf import NerfPipeline
    from ddnerf_tpu_torch.train import checkpoint as ckpt
    from ddnerf_tpu_torch.train.state import TrainState
    from ddnerf_tpu_torch.utils.weights import (
        pipeline_state_from_params,
        save_checkpoint,
    )

    out = out or logdir
    jcfg = jax_ckpt.load_config_snapshot(logdir)
    template = create_train_state(jcfg, JaxPipeline(jcfg),
                                  jax.random.PRNGKey(0))
    manager = jax_ckpt.CheckpointManager(
        logdir, max_to_keep=jcfg.experiment.max_keep_ckpts)
    try:
        jstate = manager.restore(template, step=step)
    finally:
        manager.close()
    jstep = int(np.asarray(jstate.step))

    os.makedirs(out, exist_ok=True)
    src = os.path.join(logdir, "config.yml")
    dst = os.path.join(out, "config.yml")
    if os.path.abspath(src) != os.path.abspath(dst):
        shutil.copyfile(src, dst)
    cfg = Config.from_yaml(dst).resolved()
    pipe = NerfPipeline(cfg, "cpu")
    pipe.load_state_dicts(**pipeline_state_from_params(
        jax.device_get(jstate.params)))
    nets = [("coarse", pipe.coarse)] + (
        [] if pipe.shared_net else [("fine", pipe.fine)])
    adam, count = adam_state_dict(jax.device_get(jstate.opt_state), nets)
    if count != jstep:
        raise ValueError(f"the Adam state counts {count} updates, the "
                         f"checkpoint's step is {jstep}")
    sd = TrainState(cfg, pipe).optimizer_state_dict()
    sd["state"] = adam
    path = ckpt.step_path(out, jstep)
    save_checkpoint(path, pipe.coarse, None if pipe.shared_net else pipe.fine,
                    step=jstep,
                    extra={ckpt.OPTIMIZER_KEY: sd,
                           ckpt.GENERATOR_SEED_KEY:
                               "converted from an orbax checkpoint of the "
                               "JAX package, whose random key has no "
                               "generator state"})
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("logdir", help="A JAX run's logdir (config.yml and "
                                   "checkpoint/).")
    ap.add_argument("--step", type=int, default=None,
                    help="A retained step (default: the newest).")
    ap.add_argument("--out", default=None,
                    help="Where to write (default: LOGDIR itself).")
    args = ap.parse_args(argv)
    path = convert(args.logdir, args.step, args.out)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
