"""Config snapshot of a run's logdir.

Counterpart of ``ddnerf_tpu/train/checkpoint.py::load_config_snapshot``.
The JAX module's orbax checkpoint manager is not ported; the port reads and
writes reference-format ``checkpoint.ckpt`` files
(:mod:`ddnerf_tpu_torch.utils.weights`).
"""

from __future__ import annotations

import os

from ddnerf_tpu_torch.config import Config


def load_config_snapshot(logdir: str) -> Config:
    """``logdir/config.yml`` (written at train start), resolved."""
    return Config.from_yaml(os.path.join(logdir, "config.yml")).resolved()
