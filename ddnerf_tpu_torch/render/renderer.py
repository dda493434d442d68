"""Whole-image rendering from a camera pose, chunked over the ray axis.

Counterpart of ``ddnerf_tpu/render/renderer.py::ImageRenderer``'s pose
path (``render_image_from_pose`` / ``render_images_from_poses``) with ray
generation and chunking folded in from ``train/step.py::make_eval_step``.
Rays are generated on the device from the [4, 4] pose and rendered in
chunks of ``nerf.validation.chunksize``; maps come back as float32 numpy.
The JAX renderer's packed fetch and dispatch pipelining serve its host
link and are not carried over.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.core.rays import get_ray_bundle
from ddnerf_tpu_torch.models.nerf import NerfPipeline, RayBatch, ScheduleValues

# The maps a render returns (the JAX renderer's DEFAULT_KEYS).
MAP_KEYS = ("rgb", "disp", "acc", "depth", "corrected_disp_map")
Maps = Dict[int, Dict[str, np.ndarray]]


class ImageRenderer:
    def __init__(self, cfg: Config, pipeline: NerfPipeline):
        self.cfg = cfg
        self.pipeline = pipeline
        self.chunk = cfg.nerf.validation.chunksize

    def render_flat(self, origins, directions, radii,
                    generator: Optional[torch.Generator] = None,
                    sched: Optional[ScheduleValues] = None,
                    ) -> Dict[int, Dict[str, torch.Tensor]]:
        """Render ``N`` rays (device tensors ``[N, 3]``, ``[N, 3]``,
        ``[N, 1]``) chunk by chunk -> per-cycle ``[N(, C)]`` device maps."""
        if sched is None:
            sched = ScheduleValues.for_eval(self.cfg)
        ds = self.cfg.dataset
        n = origins.shape[0]
        parts: Dict[int, Dict[str, list]] = {0: {}, 1: {}}
        for start in range(0, n, self.chunk):
            sl = slice(start, min(start + self.chunk, n))
            rays = RayBatch.create(origins[sl], directions[sl], radii[sl],
                                   ds.near, ds.far)
            out = self.pipeline.render_rays(rays, sched, "render", generator)
            for i in (0, 1):
                for key in MAP_KEYS:
                    if out[i].get(key) is not None:
                        parts[i].setdefault(key, []).append(out[i][key])
        return {i: {k: torch.cat(v) for k, v in parts[i].items()}
                for i in parts}

    def render_image_from_pose(self, pose, h: int, w: int, focal,
                               generator: Optional[torch.Generator] = None,
                               sched: Optional[ScheduleValues] = None) -> Maps:
        """Render an ``[h, w]`` image from a [4, 4] (or [3, 4]) camera pose
        -> per-cycle float32 numpy maps (``[h, w, 3]`` rgb, ``[h, w]``
        scalars).  Without a generator, one seeded with 0 is used per image
        (the JAX renderer's ``PRNGKey(0)``)."""
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
                result[i][key] = arr.reshape(h, w, -1) if arr.ndim == 2 \
                    else arr.reshape(h, w)
        return result

    def render_images_from_poses(self, poses: Iterable, h: int, w: int,
                                 focal, sched: Optional[ScheduleValues] = None,
                                 ) -> Iterator[Maps]:
        """Yield :meth:`render_image_from_pose` for each pose."""
        for pose in poses:
            yield self.render_image_from_pose(pose, h, w, focal, sched=sched)
