"""The training loop driver on one device.

Counterpart of ``ddnerf_tpu/train/loop.py`` (reference
train_model.py:19-264) in its per-iteration form: config snapshot, seeded
networks, resume from the logdir's newest checkpoint (or from
``load_checkpoint``), the device-resident ray store, one train step per
iteration, the ``[TRAIN]`` line at ``print_every`` and at the last
iteration, train scalars through the ``Documenter`` (``metrics.jsonl``, and
TensorBoard when tensorboardX is importable) every ``train_scalars_every``
iterations, a whole-image validation at ``validate_every`` (with the NDC
depth un-warp and, under ``train_params.depth_analysis_rays``, the
per-ray depth-analysis figures), and the retained checkpoints at
``save_every`` and at the end.  Both model families.  Not here: the
block-mode scalars and the mesh; a ray store above
``parallel.max_store_gb`` raises (``data/datasets.py``).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ddnerf_tpu_torch.viz.documentation import Documenter
from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.core.rays import switch_t_ndc_to_regular
from ddnerf_tpu_torch.data.datasets import load_train_store
from ddnerf_tpu_torch.eval.depth_analysis import run_depth_analysis
from ddnerf_tpu_torch.eval.evaluate import resolve_device
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.render.renderer import ImageRenderer
from ddnerf_tpu_torch.train import checkpoint as ckpt
from ddnerf_tpu_torch.train.state import TrainState
from ddnerf_tpu_torch.train.step import schedule_values, train_step_from_store


def _resume_path(logdir: str, load_checkpoint: str) -> Optional[str]:
    """The checkpoint a run starts from: ``load_checkpoint`` (a checkpoint
    file, or a logdir that holds one: ``ddnerf_tpu/train/loop.py:70-82``),
    else the logdir's own newest, else none."""
    if load_checkpoint:
        if os.path.isfile(load_checkpoint):
            return load_checkpoint
        return ckpt.checkpoint_path(load_checkpoint)
    try:
        return ckpt.checkpoint_path(logdir)
    except FileNotFoundError:
        return None


def train(cfg: Config, max_iters: Optional[int] = None, device="cuda",
          load_checkpoint: str = ""):
    """Train ``cfg`` on ``device`` up to iteration ``max_iters`` (default
    ``experiment.train_iters``).  A logdir that already holds a checkpoint
    is continued from it: networks, Adam state, step, the generator and the
    validation round-robin are restored, and the loop runs the remaining
    iterations.  Returns (state, logdir)."""
    dev = resolve_device(device)
    logdir = os.path.join(cfg.experiment.logdir, cfg.experiment.id)
    os.makedirs(logdir, exist_ok=True)
    # Dataset build may rescale near/far (pose normalization).
    store, val_ds, cfg = load_train_store(cfg, dev)
    resume = _resume_path(logdir, load_checkpoint)

    exp = cfg.experiment
    seed = exp.randomseed
    pipeline = NerfPipeline(cfg, dev, seed=seed)
    state = TrainState(cfg, pipeline)
    generator = torch.Generator(device=dev).manual_seed(seed)
    if resume is not None:
        step = ckpt.load_train_checkpoint(resume, pipeline, state, generator)
        # Round-robin parity on resume (train_model.py:81).
        val_ds.current_idx = (step // exp.validate_every) % len(val_ds)
        print(f"resumed from {resume} at iteration {step}", flush=True)
    # Only now: a checkpoint this config cannot continue has raised above
    # and left the snapshot that eval reads as it was.
    ckpt.save_config_snapshot(cfg, logdir)
    renderer = ImageRenderer(cfg, pipeline, mode="validation")
    total = max_iters or exp.train_iters
    start = state.step
    if start >= total:
        print(f"nothing to train: iteration {start} is at or past the last "
              f"({total})", flush=True)
    rays_per_iter = cfg.nerf.train.num_random_rays
    da_rays = (val_ds.load_depth_analysis_rays(cfg)
               if cfg.train_params.depth_analysis_rays else None)

    def is_event(i, every):
        return i % every == 0 or i == total - 1

    doc = Documenter(logdir, primary=True)
    try:
        t_start = time.time()
        for i in range(start, total):
            metrics = train_step_from_store(cfg, pipeline, state, store,
                                            generator)
            printing = is_event(i, exp.print_every)
            if printing or (exp.train_scalars_every >= 1
                            and i % exp.train_scalars_every == 0):
                m = {k: float(v) for k, v in metrics.items()}
                extra = None
                if printing:
                    # rays/s since this run's start, first-step set-up
                    # included.
                    rate = ((i - start + 1) * rays_per_iter
                            / (time.time() - t_start))
                    m["rays_per_sec"] = rate
                    extra = {"train/rays_per_sec": rate}
                    print(f"[TRAIN] iter {i} loss {m['loss']:.4f} "
                          f"psnr {m['psnr_fine']:.2f} lr {m['lr']:.2e} "
                          f"({rate:,.0f} rays/s)", flush=True)
                doc.write_train_iter(i, m, extra_scalars=extra)
            if is_event(i, exp.validate_every):
                _validate(cfg, i, state, renderer, val_ds, doc, da_rays)
            if i > 0 and is_event(i, exp.save_every):
                ckpt.save_train_checkpoint(logdir, pipeline, state, generator,
                                           max_to_keep=exp.max_keep_ckpts)
    finally:
        doc.close()
    return state, logdir


def _validate(cfg: Config, i: int, state: TrainState,
              renderer: ImageRenderer, val_ds, doc: Documenter,
              da_rays=None) -> None:
    """Whole-image validation: metrics, the NDC depth un-warp, for DDNeRF
    the dp loss and the μ/σ histograms, and the depth-analysis figures of
    ``da_rays`` (``load_depth_analysis_rays``'s tuple) when given
    (loop.py:350-403)."""
    t_val = time.time()
    sched = schedule_values(cfg, state.step)
    pose, gt = val_ds.get_next_validation_pose()
    out = renderer.render_image_from_pose(
        pose, val_ds.H, val_ds.W, val_ds.focal, sched=sched)
    vm = validation_metrics(cfg, out, gt)
    if cfg.dataset.ndc_rays:
        ro_reg, rd_reg, _ = val_ds.get_current_regular_validation_rays(
            fixed=cfg.dataset.fix_validation_unwarp_rays)
        for j in (0, 1):
            out[j]["depth"] = switch_t_ndc_to_regular(out[j]["depth"], ro_reg,
                                                      rd_reg)
    if cfg.is_ddnerf():
        w = out[0]["weights"].reshape(-1, out[0]["weights"].shape[-1])
        pdf = w / np.maximum(w.sum(-1, keepdims=True), 1e-12)
        mask = pdf > 0.1
        for key in ("mus", "sigmas", "smoothed_sigmas"):
            out[0][f"{key}_hist"] = out[0][key].reshape(-1,
                                                        pdf.shape[-1])[mask]
    doc.write_valid_iter(i, vm, out, gt, cfg.is_ddnerf())
    if da_rays is not None:
        da_origins, da_directions, da_radii, da_depth, _ = da_rays
        da_out = run_depth_analysis(cfg, renderer.pipeline, da_origins,
                                    da_directions, da_radii, sched)
        doc.write_depth_analysis_rays(i, da_out, da_depth, cfg.dataset.near,
                                      cfg.dataset.far)
    line = (f"[VAL] iter {i} loss {vm['loss']:.4f} "
            f"psnr {vm['psnr_fine']:.2f} time {time.time() - t_val:.1f}s")
    if "dp_loss" in vm:  # DDNeRF: appended to the JAX package's line
        line += f" dp_loss {vm['dp_loss']:.4f}"
    print(line, flush=True)


def validation_metrics(cfg: Config, out, gt):
    """Whole-image validation losses (train_model.py:209-223; the JAX
    loop's ``_validation_metrics``); the dp loss only for DDNeRF."""
    gt = np.asarray(gt, np.float32)
    loss_coarse = float(np.mean((out[0]["rgb"] - gt) ** 2))
    loss_fine = float(np.mean((out[1]["rgb"] - gt) ** 2))
    coefs = cfg.train_params.loss_coeficients
    loss = coefs[0] * loss_coarse + coefs[1] * loss_fine
    m = {
        "loss_coarse": loss_coarse,
        "loss_fine": loss_fine,
        "psnr_coarse": -10.0 * np.log10(max(loss_coarse, 1e-5)),
        "psnr_fine": -10.0 * np.log10(max(loss_fine, 1e-5)),
    }
    if cfg.is_ddnerf():
        dp = float(out[1]["dp_loss"])
        loss += cfg.train_params.dp_coeficient * dp
        m["dp_loss"] = dp
    m["loss"] = loss
    return m
