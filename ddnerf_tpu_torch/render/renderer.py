"""Whole-image rendering from a camera pose, chunked over the ray axis.

Counterpart of ``ddnerf_tpu/render/renderer.py::ImageRenderer``'s pose
path (``render_image_from_pose`` / ``render_images_from_poses``) with ray
generation and chunking folded in from ``train/step.py::make_eval_step``.
Rays are generated on the device from the [4, 4] pose and rendered in
chunks of ``nerf.validation.chunksize``; maps come back as float32 numpy.
``mode="render"`` returns the image maps; ``mode="validation"`` (the
train loop's validation image) adds the coarse weights and μ/σ maps and
the scalar ``dp_loss``, averaged over chunks weighted by their ray counts
(renderer.py:537-543).  The JAX renderer's packed fetch and dispatch
pipelining serve its host link and are not carried over.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.core.rays import get_ray_bundle
from ddnerf_tpu_torch.models.nerf import NerfPipeline, RayBatch, ScheduleValues

# The maps a render returns (the JAX renderer's DEFAULT_KEYS), and what
# validation adds (the JAX train loop's extract keys, loop.py:173-175).
MAP_KEYS = ("rgb", "disp", "acc", "depth", "corrected_disp_map")
VALIDATION_KEYS = MAP_KEYS + ("weights", "mus", "sigmas", "smoothed_sigmas",
                              "dp_loss")
Maps = Dict[int, Dict[str, np.ndarray]]


class ImageRenderer:
    def __init__(self, cfg: Config, pipeline: NerfPipeline,
                 mode: str = "render"):
        if mode not in ("render", "validation"):
            raise ValueError(f"mode={mode!r}: expected render | validation")
        self.cfg = cfg
        self.pipeline = pipeline
        self.mode = mode
        self.keys = MAP_KEYS if mode == "render" else VALIDATION_KEYS
        self.chunk = cfg.nerf.validation.chunksize

    def render_flat(self, origins, directions, radii,
                    generator: Optional[torch.Generator] = None,
                    sched: Optional[ScheduleValues] = None,
                    ) -> Dict[int, Dict[str, torch.Tensor]]:
        """Render ``N`` rays (device tensors ``[N, 3]``, ``[N, 3]``,
        ``[N, 1]``) chunk by chunk -> per-cycle ``[N(, C)]`` device maps
        and 0-d scalars."""
        if sched is None:
            sched = ScheduleValues.for_eval(self.cfg)
        ds = self.cfg.dataset
        n = origins.shape[0]
        parts: Dict[int, Dict[str, list]] = {0: {}, 1: {}}
        for start in range(0, n, self.chunk):
            sl = slice(start, min(start + self.chunk, n))
            rays = RayBatch.create(origins[sl], directions[sl], radii[sl],
                                   ds.near, ds.far)
            out = self.pipeline.render_rays(rays, sched, self.mode, generator)
            for i in (0, 1):
                for key in self.keys:
                    v = out[i].get(key)
                    if v is not None:
                        parts[i].setdefault(key, []).append(
                            v * (sl.stop - sl.start) if v.dim() == 0 else v)
        return {i: {k: (torch.stack(v).sum() / n if v[0].dim() == 0
                        else torch.cat(v))
                    for k, v in parts[i].items()}
                for i in parts}

    def render_image_from_pose(self, pose, h: int, w: int, focal,
                               generator: Optional[torch.Generator] = None,
                               sched: Optional[ScheduleValues] = None) -> Maps:
        """Render an ``[h, w]`` image from a [4, 4] (or [3, 4]) camera pose
        -> per-cycle float32 numpy maps (``[h, w, C]`` for per-ray vectors,
        ``[h, w]`` for per-ray scalars, a float for a scalar).  Without a
        generator, one seeded with 0 is used per image (the JAX renderer's
        ``PRNGKey(0)``)."""
        dev = self.pipeline.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        ro, rd, radii = get_ray_bundle(h, w, float(focal), pose, device=dev)
        flat = self.render_flat(ro.reshape(-1, 3), rd.reshape(-1, 3),
                                radii.reshape(-1, 1), generator, sched)
        result: Maps = {0: {}, 1: {}}
        for i in flat:
            for key, v in flat[i].items():
                arr = v.float().cpu().numpy()
                if arr.ndim == 0:
                    result[i][key] = float(arr)
                else:
                    result[i][key] = arr.reshape(h, w, -1) if arr.ndim == 2 \
                        else arr.reshape(h, w)
        return result

    def render_images_from_poses(self, poses: Iterable, h: int, w: int,
                                 focal, sched: Optional[ScheduleValues] = None,
                                 ) -> Iterator[Maps]:
        """Yield :meth:`render_image_from_pose` for each pose."""
        for pose in poses:
            yield self.render_image_from_pose(pose, h, w, focal, sched=sched)
