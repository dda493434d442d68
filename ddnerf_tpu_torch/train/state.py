"""Train state: the step counter and one Adam over both networks.

Counterpart of ``ddnerf_tpu/train/state.py``: ``optax.chain(
scale_by_adam(), scale_by_learning_rate(lr))`` over the combined
``{coarse, fine}`` parameters.  ``torch.optim.Adam`` with its default
betas (0.9, 0.999) and eps 1e-8 is the same update; the learning rate is
set to ``lr(step)`` before every update, with ``step`` counted from 0 as
optax counts its updates.  The reference runs one Adam per network with
the same externally set rate (train_model.py:146-150); Adam is
elementwise, so one optimizer over both is the same thing.
"""

from __future__ import annotations

import torch

from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.core.schedules import make_lr_schedule


class TrainState:
    """``step`` (updates applied so far), the pipeline's ``optimizer`` and
    the learning-rate ``schedule``."""

    def __init__(self, cfg: Config, pipeline):
        if cfg.optimizer.type.lower() != "adam":
            raise ValueError(f"unsupported optimizer {cfg.optimizer.type!r}")
        self.step = 0
        self.schedule = make_lr_schedule(cfg)
        self.optimizer = torch.optim.Adam(pipeline.parameters(),
                                          lr=self.schedule(0))

    def apply_gradients(self) -> float:
        """One Adam update at ``lr(step)`` from the parameters' ``.grad``;
        advances ``step`` and returns the rate used."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        return lr
