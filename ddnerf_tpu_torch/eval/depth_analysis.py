"""Depth-analysis diagnostics: densified per-ray pdfs for annotated
keypoint rays.

Counterpart of ``ddnerf_tpu/eval/depth_analysis.py`` (reference
models.py:309-319): a post-processing step over the pipeline's normal
validation outputs (t_vals, weights, μ, σ), for both model families.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.core import dd
from ddnerf_tpu_torch.core.math import truncated_gaussian_tails
from ddnerf_tpu_torch.models.nerf import NerfPipeline, RayBatch, ScheduleValues


def run_depth_analysis(
    cfg: Config,
    pipeline: NerfPipeline,
    da_origins,
    da_directions,
    da_radii,
    sched: Optional[ScheduleValues] = None,
    generator: Optional[torch.Generator] = None,
) -> Dict[int, Dict[str, np.ndarray]]:
    """Render the (few) annotated rays in validation mode on the pipeline's
    device and attach the densified pdf curves: ``uniform_incell_pdf`` per
    cycle and, for DDNeRF, ``gaussian_incell_pdf`` and
    ``smoothed_gaussian_incell_pdf`` on the fine cycle.  Returns numpy
    arrays per cycle, as the JAX function.  Without a generator, one seeded
    with 0 is used (the JAX function's ``PRNGKey(0)``)."""
    dev = pipeline.device
    if sched is None:
        sched = ScheduleValues.for_eval(cfg)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def on_device(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    near, far = cfg.dataset.near, cfg.dataset.far
    rays = RayBatch.create(on_device(da_origins), on_device(da_directions),
                           on_device(da_radii), near, far)
    out = pipeline.render_rays(rays, sched, "validation", generator)

    extra: Dict[int, Dict[str, torch.Tensor]] = {
        i: {"uniform_incell_pdf": dd.uniform_incell_pdf(
            out[i]["t_vals"], out[i]["weights"], near, far)} for i in (0, 1)}
    if cfg.is_ddnerf():
        t0, w0, mus = out[0]["t_vals"], out[0]["weights"], out[0]["mus"]
        for key, sigmas in (
                ("gaussian_incell_pdf", out[0]["sigmas"]),
                ("smoothed_gaussian_incell_pdf", out[0]["smoothed_sigmas"])):
            _, part_inside = truncated_gaussian_tails(mus, sigmas)
            extra[1][key] = dd.gaussian_incell_pdf(t0, w0, mus, sigmas,
                                                   part_inside, near, far)
    return {i: {k: v.float().cpu().numpy()
                for k, v in {**out[i], **extra[i]}.items()} for i in (0, 1)}
