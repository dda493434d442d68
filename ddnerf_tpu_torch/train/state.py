"""Train state: the step counter and one Adam over both networks.

Counterpart of ``ddnerf_tpu/train/state.py``: ``optax.chain(
scale_by_adam(), scale_by_learning_rate(lr))`` over the combined
``{coarse, fine}`` parameters.  ``torch.optim.Adam`` with its default
betas (0.9, 0.999) and eps 1e-8 is the same update; the learning rate is
set to ``lr(step)`` before every update, with ``step`` counted from 0 as
optax counts its updates.  The reference runs one Adam per network with
the same externally set rate (train_model.py:146-150); Adam is
elementwise, so one optimizer over both is the same thing.

On a CUDA device the optimizer is ``capturable``: its step counts live on
the device and it reads the rate from the 0-d device tensor ``lr``, so the
update can be recorded into a CUDA graph (``train/step.py::
CapturedTrainStep``) and run eagerly with bitwise the same arithmetic.  On
the CPU it is the plain optimizer with a Python rate.  A checkpoint holds
the optimizer's state in one layout whichever of the two wrote it
(:meth:`TrainState.optimizer_state_dict`), and either loads the other's.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.core.schedules import make_lr_schedule


class TrainState:
    """``step`` (updates applied so far, a host counter), the pipeline's
    ``optimizer``, the learning-rate ``schedule`` and ``lr``, a 0-d float32
    tensor on the parameters' device that holds the rate of the newest
    update (on CUDA the optimizer reads it)."""

    def __init__(self, cfg: Config, pipeline):
        if cfg.optimizer.type.lower() != "adam":
            raise ValueError(f"unsupported optimizer {cfg.optimizer.type!r}")
        self.step = 0
        self.schedule = make_lr_schedule(cfg)
        params = pipeline.parameters()
        device = params[0].device
        self.capturable = device.type == "cuda"
        self.lr = torch.full((), self.schedule(0), dtype=torch.float32,
                             device=device)
        self.optimizer = torch.optim.Adam(
            params, lr=self.lr if self.capturable else self.schedule(0),
            capturable=self.capturable)
        self._own_groups()

    def _own_groups(self) -> None:
        """The param groups read this state's rate and mode, not a loaded
        file's."""
        for group in self.optimizer.param_groups:
            group["capturable"] = self.capturable
            group["lr"] = self.lr if self.capturable else float(self.lr)

    def set_lr(self, lr: float) -> None:
        """The rate the next update uses."""
        self.lr.fill_(lr)
        if not self.capturable:
            for group in self.optimizer.param_groups:
                group["lr"] = lr

    def apply_gradients(self) -> float:
        """One Adam update at ``lr(step)`` from the parameters' ``.grad``;
        advances ``step`` and returns the rate used."""
        lr = self.schedule(self.step)
        self.set_lr(lr)
        self.optimizer.step()
        self.step += 1
        return lr

    # ------------------------------------------------------- checkpoints

    def optimizer_state_dict(self) -> Dict[str, Any]:
        """``optimizer.state_dict()`` in the layout the plain CPU optimizer
        writes, whichever mode this state runs in: every step count a 0-d
        float32 CPU tensor, ``lr`` a Python float, ``capturable`` false."""
        sd = self.optimizer.state_dict()
        lr = float(self.lr)
        return {
            "state": {
                idx: {name: v.cpu() if name == "step" else v
                      for name, v in entry.items()}
                for idx, entry in sd["state"].items()},
            "param_groups": [dict(group, lr=lr, capturable=False)
                             for group in sd["param_groups"]],
        }

    def load_optimizer_state_dict(self, sd: Dict[str, Any], step: int) -> None:
        """Restore Adam's moments and step counts from ``sd`` (either
        optimizer's layout) and set ``step``.  Adam's own step counts must
        equal ``step``: they set its bias correction, ``step`` sets the
        schedules.  An optimizer that has already stepped keeps its state
        tensors and is written in place, because a captured graph holds
        their addresses."""
        counts = {int(entry["step"]) for entry in sd["state"].values()}
        if counts - {int(step)}:
            raise ValueError(f"the optimizer state counts {sorted(counts)} "
                             f"updates, the checkpoint's iter is {step}")
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        if self.optimizer.state:
            if len(sd["state"]) != len(params):
                raise ValueError(
                    f"the optimizer state holds {len(sd['state'])} "
                    f"parameters, this model has {len(params)}")
            with torch.no_grad():
                for idx, p in enumerate(params):
                    for name, value in sd["state"][idx].items():
                        self.optimizer.state[p][name].copy_(value)
        else:
            self.optimizer.load_state_dict(sd)
            self._own_groups()
            where = params[0].device if self.capturable else "cpu"
            for entry in self.optimizer.state.values():
                entry["step"] = entry["step"].to(device=where,
                                                 dtype=torch.float32)
        self.step = int(step)
        if self.step > 0:
            self.set_lr(self.schedule(self.step - 1))
