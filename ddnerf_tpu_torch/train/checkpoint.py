"""Config snapshot and checkpoint of a run's logdir.

Counterpart of ``ddnerf_tpu/train/checkpoint.py``: the config snapshot
(``config.yml``, the source of truth for eval) and a single rolling
checkpoint.  The port writes the reference-format ``checkpoint.ckpt``
(:mod:`ddnerf_tpu_torch.utils.weights`), which its eval CLI reads, with
the Adam state under one extra key; the JAX package's orbax checkpoints
and resume come with the drivers slice.
"""

from __future__ import annotations

import os

from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.utils.weights import save_checkpoint

CHECKPOINT_NAME = "checkpoint.ckpt"
OPTIMIZER_KEY = "optimizer_state_dict"


def save_config_snapshot(cfg: Config, logdir: str) -> None:
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "config.yml"), "w") as f:
        f.write(cfg.dump())


def load_config_snapshot(logdir: str) -> Config:
    """``logdir/config.yml`` (written at train start), resolved."""
    return Config.from_yaml(os.path.join(logdir, "config.yml")).resolved()


def save_train_checkpoint(logdir: str, pipeline, state) -> str:
    """``logdir/checkpoint.ckpt`` of both networks at ``state.step`` (the
    number of updates applied, as the JAX package saves), with the
    optimizer's state dict under ``optimizer_state_dict``."""
    path = os.path.join(logdir, CHECKPOINT_NAME)
    save_checkpoint(path, pipeline.coarse, pipeline.fine, step=state.step,
                    extra={OPTIMIZER_KEY: state.optimizer.state_dict()})
    return path
