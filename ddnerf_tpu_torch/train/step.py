"""The train step: schedules, forward (coarse→fine), loss assembly
(Σ coefⱼ·MSE, and + dp_coef·dp_loss for DDNeRF), backward and the Adam
update.

Counterpart of ``ddnerf_tpu/train/step.py`` (reference
train_model.py:132-177).  PyTorch runs eagerly, so the step is a plain
function; the JAX package's ``lax.scan`` blocks of several steps have no
counterpart here (CUDA graphs are later work).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.core import schedules
from ddnerf_tpu_torch.core.math import img2mse, mse2psnr
from ddnerf_tpu_torch.data.datasets import sample_rays_on_device
from ddnerf_tpu_torch.models.nerf import NerfPipeline, RayBatch, ScheduleValues
from ddnerf_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]  # origins, directions, radii, rgb


def schedule_values(cfg: Config, step: int) -> ScheduleValues:
    return ScheduleValues(
        gaussian_smooth_factor=schedules.gaussian_smooth_factor(step, cfg),
        pdf_padding=schedules.pdf_padding(step, cfg),
    )


def compute_loss(cfg: Config, pipeline: NerfPipeline, rays: RayBatch,
                 target: torch.Tensor, sched: ScheduleValues,
                 generator: Optional[torch.Generator] = None,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss assembly mirroring train_model.py:156-167; the dp loss and the
    μ/σ regularizer metrics only for DDNeRF (``ddnerf_tpu/train/step.py:
    66-73``).  PSNR is not taken here: under microbatching it comes from
    the aggregated MSEs."""
    out = pipeline.render_rays(rays, sched, "train", generator)
    loss_coarse = img2mse(out[0]["rgb"], target)
    loss_fine = img2mse(out[1]["rgb"], target)
    coefs = cfg.train_params.loss_coeficients
    loss = coefs[0] * loss_coarse + coefs[1] * loss_fine
    metrics = {"loss_coarse": loss_coarse, "loss_fine": loss_fine}
    if cfg.is_ddnerf():
        dp_loss = out[1]["dp_loss"]
        loss = loss + cfg.train_params.dp_coeficient * dp_loss
        metrics["dp_loss"] = dp_loss
        for key in ("mus_loss", "sig_loss", "mus_reg", "sig_reg"):
            metrics[key] = out[0][key]
    metrics["loss"] = loss
    return loss, metrics


def train_step(cfg: Config, pipeline: NerfPipeline, state: TrainState,
               batch: Batch, generator: Optional[torch.Generator] = None,
               ) -> Dict[str, torch.Tensor]:
    """One step on ``batch``: gradients (accumulated over equal chunks of
    ``parallel.microbatch_rays`` rays when it divides the batch: the mean
    of the chunk means, ``step.py:125-140``), then the Adam update.
    Returns detached scalar metrics on the device."""
    sched = schedule_values(cfg, state.step)
    near, far = cfg.dataset.near, cfg.dataset.far
    params = pipeline.parameters()
    for p in params:
        p.grad = None

    def accumulate(part: Batch) -> Dict[str, torch.Tensor]:
        rays = RayBatch.create(part["origins"], part["directions"],
                               part["radii"], near, far)
        loss, m = compute_loss(cfg, pipeline, rays, part["rgb"], sched,
                               generator)
        loss.backward()  # .grad accumulates over chunks
        return {key: v.detach() for key, v in m.items()}

    mb = cfg.parallel.microbatch_rays
    num_rays = batch["origins"].shape[0]
    if mb and num_rays > mb and num_rays % mb == 0:
        k = num_rays // mb
        sums: Dict[str, torch.Tensor] = {}
        for j in range(k):
            part = {key: v[j * mb:(j + 1) * mb] for key, v in batch.items()}
            for key, v in accumulate(part).items():
                sums[key] = sums[key] + v if key in sums else v
        with torch.no_grad():
            for p in params:
                p.grad /= k
        metrics = {key: v / k for key, v in sums.items()}
    else:
        metrics = accumulate(batch)
    metrics["psnr_coarse"] = mse2psnr(metrics["loss_coarse"])
    metrics["psnr_fine"] = mse2psnr(metrics["loss_fine"])
    metrics["lr"] = torch.tensor(state.apply_gradients())
    return metrics


def train_step_from_store(cfg: Config, pipeline: NerfPipeline,
                          state: TrainState, store: torch.Tensor,
                          generator: torch.Generator,
                          ) -> Dict[str, torch.Tensor]:
    """:func:`train_step` on a batch drawn from the device-resident ray
    store ``[n_img, n_pix, 10]`` (step.py:156-172); ``generator`` draws the
    rays, then the jitter and the density noise."""
    ro, rd, radii, rgb = sample_rays_on_device(
        store, generator, cfg.nerf.train.num_random_rays,
        cfg.dataset.single_image_mode)
    batch = {"origins": ro, "directions": rd, "radii": radii, "rgb": rgb}
    return train_step(cfg, pipeline, state, batch, generator)
