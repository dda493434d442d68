"""Per-step schedules as plain functions of the integer step.

Counterpart of ``ddnerf_tpu/core/schedules.py`` (reference
train_model.py:101-142): the delayed log-lerp learning rate, the annealed
``gaussian_smooth_factor`` and the ``pdf_padding`` flip.  The step is a
Python int counted from 0 (the optimizer's update count), so each value is
a Python float or bool computed on the host, with the JAX package's float32
arithmetic.
"""

from __future__ import annotations

import numpy as np

from ddnerf_tpu_torch.config import Config

_F32 = np.float32


def learning_rate_decay(step: int, lr_init, lr_final, max_steps,
                        lr_delay_steps=0, lr_delay_mult=1.0) -> float:
    """mip-NeRF log-lerp decay with a sine warm-up
    (reference nerf_helpers.py:211-245)."""
    step = _F32(step)
    if lr_delay_steps > 0:
        delay_rate = _F32(lr_delay_mult) + _F32(1.0 - lr_delay_mult) * np.sin(
            _F32(0.5 * np.pi) * np.clip(step / _F32(lr_delay_steps), 0.0, 1.0)
        )
    else:
        delay_rate = _F32(1.0)
    t = np.clip(step / _F32(max_steps), _F32(0.0), _F32(1.0))
    log_lerp = np.exp(np.log(_F32(lr_init)) * (_F32(1.0) - t)
                      + np.log(_F32(lr_final)) * t)
    return float(_F32(delay_rate * log_lerp))


def make_lr_schedule(cfg: Config):
    """The schedule the reference hardcodes at train_model.py:101-107."""
    opt = cfg.optimizer

    def schedule(step: int) -> float:
        return learning_rate_decay(
            step, lr_init=opt.lr_init, lr_final=opt.lr_final,
            max_steps=cfg.experiment.train_iters,
            lr_delay_steps=opt.lr_delay_steps,
            lr_delay_mult=opt.lr_delay_mult)

    return schedule


def gaussian_smooth_factor(step: int, cfg: Config) -> float:
    """Linear anneal from ``gaussian_smooth_factor`` to ``final_smooth``
    over ``finnish_smooth`` steps, then constant (train_model.py:121-138)."""
    tp = cfg.train_params
    dsmooth = (tp.gaussian_smooth_factor - tp.final_smooth) / tp.finnish_smooth
    if step < tp.finnish_smooth:
        return float(_F32(tp.gaussian_smooth_factor) - _F32(dsmooth) * _F32(step))
    return float(_F32(tp.final_smooth))


def pdf_padding(step: int, cfg: Config) -> bool:
    """True until ``max_pdf_pad_iters``, then False (train_model.py:140-142);
    a config that starts with ``pdf_padding: false`` never pads."""
    tp = cfg.train_params
    return bool(tp.pdf_padding and step < tp.max_pdf_pad_iters)
