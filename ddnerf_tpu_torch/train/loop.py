"""The training loop driver on one device.

Counterpart of ``ddnerf_tpu/train/loop.py`` (reference
train_model.py:19-264) in its per-iteration form: config snapshot, seeded
networks, the device-resident ray store, one train step per iteration,
the ``[TRAIN]`` line at ``print_every`` and at the last iteration, train
scalars through the JAX package's ``Documenter`` (``metrics.jsonl``, and
TensorBoard when tensorboardX is importable) every
``train_scalars_every`` iterations, a whole-image validation at
``validate_every``, and ``checkpoint.ckpt`` at ``save_every`` and at the
end.  Not here yet: resume, the block-mode scalars, the mesh, profiling,
depth analysis and host-side sampling for stores above
``parallel.max_store_gb``.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ddnerf_tpu.viz.documentation import Documenter
from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.data.datasets import load_train_store
from ddnerf_tpu_torch.eval.evaluate import resolve_device
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.render.renderer import ImageRenderer
from ddnerf_tpu_torch.train.checkpoint import (
    save_config_snapshot,
    save_train_checkpoint,
)
from ddnerf_tpu_torch.train.state import TrainState
from ddnerf_tpu_torch.train.step import schedule_values, train_step_from_store


def train(cfg: Config, max_iters: Optional[int] = None, device="cuda"):
    """Train ``cfg`` on ``device`` for ``max_iters`` (default
    ``experiment.train_iters``) iterations.  Returns (state, logdir)."""
    dev = resolve_device(device)
    logdir = os.path.join(cfg.experiment.logdir, cfg.experiment.id)
    os.makedirs(logdir, exist_ok=True)
    # Dataset build may rescale near/far (pose normalization).
    store, val_ds, cfg = load_train_store(cfg, dev)
    save_config_snapshot(cfg, logdir)

    seed = cfg.experiment.randomseed
    pipeline = NerfPipeline(cfg, dev, seed=seed)
    state = TrainState(cfg, pipeline)
    generator = torch.Generator(device=dev).manual_seed(seed)
    renderer = ImageRenderer(cfg, pipeline, mode="validation")
    exp = cfg.experiment
    total = max_iters or exp.train_iters
    rays_per_iter = cfg.nerf.train.num_random_rays

    def is_event(i, every):
        return i % every == 0 or i == total - 1

    doc = Documenter(logdir, primary=True)
    try:
        t_start = time.time()
        for i in range(total):
            metrics = train_step_from_store(cfg, pipeline, state, store,
                                            generator)
            printing = is_event(i, exp.print_every)
            if printing or (exp.train_scalars_every >= 1
                            and i % exp.train_scalars_every == 0):
                m = {k: float(v) for k, v in metrics.items()}
                extra = None
                if printing:
                    # rays/s since the start, first-step set-up included.
                    rate = (i + 1) * rays_per_iter / (time.time() - t_start)
                    m["rays_per_sec"] = rate
                    extra = {"train/rays_per_sec": rate}
                    print(f"[TRAIN] iter {i} loss {m['loss']:.4f} "
                          f"psnr {m['psnr_fine']:.2f} lr {m['lr']:.2e} "
                          f"({rate:,.0f} rays/s)", flush=True)
                doc.write_train_iter(i, m, extra_scalars=extra)
            if is_event(i, exp.validate_every):
                _validate(cfg, i, state, renderer, val_ds, doc)
            if (i > 0 and i % exp.save_every == 0) or i == total - 1:
                save_train_checkpoint(logdir, pipeline, state)
    finally:
        doc.close()
    return state, logdir


def _validate(cfg: Config, i: int, state: TrainState,
              renderer: ImageRenderer, val_ds, doc: Documenter) -> None:
    """Whole-image validation: metrics, dp loss and the μ/σ histograms
    (loop.py:350-424)."""
    t_val = time.time()
    pose, gt = val_ds.get_next_validation_pose()
    out = renderer.render_image_from_pose(
        pose, val_ds.H, val_ds.W, val_ds.focal,
        sched=schedule_values(cfg, state.step))
    vm = validation_metrics(cfg, out, gt)
    w = out[0]["weights"].reshape(-1, out[0]["weights"].shape[-1])
    pdf = w / np.maximum(w.sum(-1, keepdims=True), 1e-12)
    mask = pdf > 0.1
    for key in ("mus", "sigmas", "smoothed_sigmas"):
        out[0][f"{key}_hist"] = out[0][key].reshape(-1, pdf.shape[-1])[mask]
    doc.write_valid_iter(i, vm, out, gt, True)
    print(f"[VAL] iter {i} loss {vm['loss']:.4f} psnr {vm['psnr_fine']:.2f} "
          f"dp_loss {vm['dp_loss']:.4f} time {time.time() - t_val:.1f}s",
          flush=True)


def validation_metrics(cfg: Config, out, gt):
    """Whole-image validation losses (train_model.py:209-223; the JAX
    loop's ``_validation_metrics``)."""
    gt = np.asarray(gt, np.float32)
    loss_coarse = float(np.mean((out[0]["rgb"] - gt) ** 2))
    loss_fine = float(np.mean((out[1]["rgb"] - gt) ** 2))
    coefs = cfg.train_params.loss_coeficients
    dp = float(out[1]["dp_loss"])
    return {
        "loss_coarse": loss_coarse,
        "loss_fine": loss_fine,
        "psnr_coarse": -10.0 * np.log10(max(loss_coarse, 1e-5)),
        "psnr_fine": -10.0 * np.log10(max(loss_fine, 1e-5)),
        "dp_loss": dp,
        "loss": (coefs[0] * loss_coarse + coefs[1] * loss_fine
                 + cfg.train_params.dp_coeficient * dp),
    }
