"""Whole-image rendering from a camera pose, chunked over the ray axis.

Counterpart of ``ddnerf_tpu/render/renderer.py::ImageRenderer``'s pose
paths (``render_image_from_pose`` / ``render_images_from_poses`` and the
video frames ``render_video_frame_from_pose`` /
``render_video_frames_from_poses``) with ray generation and chunking
folded in from ``train/step.py::make_eval_step``.  Rays are generated on
the device from the [4, 4] pose, projected to NDC space there when
``dataset.ndc_rays`` (over the whole image, before chunking: the NDC radii
are neighbour differences on the pixel grid), and rendered in chunks of
``nerf.validation.chunksize``.  Image maps come back as float32 numpy;
video frames keep only the fine ``rgb`` and ``disp`` and are quantized to
uint8 on the device, so only the uint8 maps reach the host.
``mode="render"`` returns the image maps; ``mode="validation"`` (the
train loop's validation image) adds, for DDNeRF, the coarse weights and
μ/σ maps and the scalar ``dp_loss``, averaged over chunks weighted by
their ray counts (renderer.py:537-543); mip-NeRF has none of those and
validates with the image maps alone.  The JAX renderer's packed fetch and its one-frame
dispatch lookahead serve its host link and are not carried over.

On a data-parallel group (``pipeline.mesh``, ``parallel/mesh.py``) each
chunk's rays are split over the ranks, as the JAX renderer shards each
chunk over its mesh (renderer.py:316-411, 486-505): rank r renders rows
``[r·p, (r+1)·p)`` of a chunk of ``c`` rays, ``p = ceil(c / D)``, its share
padded with the chunk's last ray to ``p`` rows.  The chunks are the
single-device ones, and every random draw is made for the whole chunk and
sliced (``core/draws.py``), so a ray meets the same draws on any number of
ranks.  Every rank generates (and NDC-projects) the whole image's rays,
and one all-gather at the end gives every rank the whole maps, which are
then what a single device returns; a video frame is quantized after it, so
the disparity is normalized by the whole frame's range.  A scalar (the
validation dp loss) is the chunks' values weighted by each rank's real
rays, summed over the ranks.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.core.rays import (
    get_ray_bundle,
    ndc_mipnerf_rays_device,
)
from ddnerf_tpu_torch.models.nerf import NerfPipeline, RayBatch, ScheduleValues
from ddnerf_tpu_torch.utils.profiling import FRAME_ROOT, span

# The maps a render returns (the JAX renderer's DEFAULT_KEYS; a map the
# model lacks, as mip-NeRF the μ-corrected disparity, is left out), and what
# DDNeRF's validation adds (the JAX train loop's extract keys,
# loop.py:181-183).
MAP_KEYS = ("rgb", "disp", "acc", "depth", "corrected_disp_map")
VALIDATION_KEYS = MAP_KEYS + ("weights", "mus", "sigmas", "smoothed_sigmas",
                              "dp_loss")
VIDEO_KEYS = ("rgb", "disp")  # a video frame's maps (JAX extract_keys)
Maps = Dict[int, Dict[str, np.ndarray]]


def quantize_video_frame(rgb: torch.Tensor, disp: torch.Tensor,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rgb [..., 3]`` and ``disp [...]`` float maps -> uint8 maps, on
    their device, exactly as the JAX frame program (renderer.py:397-409,
    ``viz.cast_to_image`` / ``cast_to_disparity_image``): rgb clipped to
    [0, 1], times 255, truncated; disparity with non-finite values set to
    0, normalized by its min and span (a zero span divides by 1), clipped,
    times 255, truncated."""
    rgb_u8 = (torch.clamp(rgb, 0.0, 1.0) * 255).to(torch.uint8)
    d = torch.nan_to_num(disp, nan=0.0, posinf=0.0, neginf=0.0)
    lo = torch.min(d)
    span = torch.max(d) - lo
    norm = (d - lo) / torch.where(span > 0, span, torch.ones_like(span))
    disp_u8 = (torch.clamp(norm, 0.0, 1.0) * 255).to(torch.uint8)
    return rgb_u8, disp_u8


class ImageRenderer:
    def __init__(self, cfg: Config, pipeline: NerfPipeline,
                 mode: str = "render"):
        if mode not in ("render", "validation"):
            raise ValueError(f"mode={mode!r}: expected render | validation")
        self.cfg = cfg
        self.pipeline = pipeline
        self.mode = mode
        self.keys = (VALIDATION_KEYS if mode == "validation"
                     and cfg.is_ddnerf() else MAP_KEYS)
        self.chunk = cfg.nerf.validation.chunksize

    def render_flat(self, origins, directions, radii,
                    generator: Optional[torch.Generator] = None,
                    sched: Optional[ScheduleValues] = None,
                    keys: Optional[Sequence[str]] = None,
                    ) -> Dict[int, Dict[str, torch.Tensor]]:
        """Render ``N`` rays (device tensors ``[N, 3]``, ``[N, 3]``,
        ``[N, 1]``) chunk by chunk -> per-cycle ``[N(, C)]`` device maps
        and 0-d scalars, of ``keys`` (default: the mode's maps)."""
        if sched is None:
            sched = ScheduleValues.for_eval(self.cfg)
        keys = self.keys if keys is None else keys
        mesh = self.pipeline.mesh
        if mesh is not None and mesh.sharded:
            return self._render_flat_sharded(origins, directions, radii,
                                             generator, sched, keys)
        ds = self.cfg.dataset
        n = origins.shape[0]
        parts: Dict[int, Dict[str, list]] = {0: {}, 1: {}}
        for start in range(0, n, self.chunk):
            sl = slice(start, min(start + self.chunk, n))
            with span("ddnerf.render.chunk"):
                rays = RayBatch.create(origins[sl], directions[sl], radii[sl],
                                       ds.near, ds.far)
                out = self.pipeline.render_rays(rays, sched, self.mode,
                                                generator)
                for i in (0, 1):
                    for key in keys:
                        v = out[i].get(key)
                        if v is not None:
                            parts[i].setdefault(key, []).append(
                                v * (sl.stop - sl.start) if v.dim() == 0 else v)
        with span("ddnerf.render.assemble"):
            return {i: {k: (torch.stack(v).sum() / n if v[0].dim() == 0
                            else torch.cat(v))
                        for k, v in parts[i].items()}
                    for i in parts}

    def _render_flat_sharded(self, origins, directions, radii, generator,
                             sched: ScheduleValues, keys: Sequence[str],
                             ) -> Dict[int, Dict[str, torch.Tensor]]:
        """:meth:`render_flat` on a mesh: this rank's share of every chunk,
        then one all-gather of the packed maps (see the module
        docstring)."""
        mesh = self.pipeline.mesh
        ds = self.cfg.dataset
        n, dev = origins.shape[0], origins.device
        maps: Dict[Tuple[int, str], list] = {}
        sums: Dict[Tuple[int, str], torch.Tensor] = {}
        owner = np.empty(n, np.int64)  # the rank that renders each ray
        at = np.empty(n, np.int64)  # and its row in that rank's buffer
        local = 0
        for start in range(0, n, self.chunk):
            stop = min(start + self.chunk, n)
            p = -(-(stop - start) // mesh.size)
            lo = min(start + mesh.rank * p, stop)
            hi = min(lo + p, stop)
            with span("ddnerf.render.chunk"):
                rows = torch.arange(lo, lo + p, device=dev).clamp_(max=stop - 1)
                rays = RayBatch.create(
                    origins[rows], directions[rows], radii[rows], ds.near,
                    ds.far, rows=(lo - start, hi - start, stop - start))
                out = self.pipeline.render_rays(rays, sched, self.mode,
                                                generator)
                k = np.arange(stop - start)
                owner[start:stop], at[start:stop] = k // p, local + k % p
                for i in (0, 1):
                    for key in keys:
                        v = out[i].get(key)
                        if v is None:
                            continue
                        if v.dim() == 0:  # weighted by this rank's real rays
                            w = v.float() * (hi - lo)
                            sums[(i, key)] = (sums[(i, key)] + w
                                              if (i, key) in sums else w)
                        else:
                            maps.setdefault((i, key), []).append(v)
                local += p
        with span("ddnerf.render.assemble"):
            src = torch.from_numpy(owner * local + at).to(dev)
            return self._gather(mesh, maps, sums, src, n)

    @staticmethod
    def _gather(mesh, maps, sums, src: torch.Tensor, n: int,
                ) -> Dict[int, Dict[str, torch.Tensor]]:
        """This rank's map rows (``maps``: per (cycle, key) the chunks'
        ``[p, ...]`` pieces) and weighted scalar sums -> every rank's whole
        ``[n, ...]`` maps, in ray order, and the scalars' means over the
        ``n`` rays: one all-gather of every map packed as float32 columns
        (exact: the maps are float32), one all-reduce of the scalars."""
        out: Dict[int, Dict[str, torch.Tensor]] = {0: {}, 1: {}}
        parts = {key: torch.cat(v) for key, v in maps.items()}
        if parts:
            packed = torch.cat([v.reshape(v.shape[0], -1).float()
                                for v in parts.values()], dim=1)
            whole = mesh.all_gather(packed)
            whole = whole.reshape(-1, packed.shape[1])[src]
            widths = [v[0].numel() for v in parts.values()]
            for (i, key), v, col in zip(parts, parts.values(),
                                        whole.split(widths, dim=1)):
                out[i][key] = col.reshape(n, *v.shape[1:]).to(v.dtype)
        if sums:
            total = mesh.all_reduce(torch.stack(list(sums.values()))) / n
            for (i, key), v in zip(sums, total.unbind(0)):
                out[i][key] = v
        return out

    def _render_pose(self, pose, h, w, focal, generator, sched, keys=None):
        """Rays of the pose, generated (and, under ``dataset.ndc_rays``,
        NDC-projected: ``ddnerf_tpu/render/renderer.py:350-354``) on the
        device, rendered flat.  Without a generator, one seeded with 0 is
        used per image (the JAX renderer's ``PRNGKey(0)``)."""
        dev = self.pipeline.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        with span("ddnerf.render.rays"):
            ro, rd, radii = get_ray_bundle(h, w, float(focal), pose, device=dev)
            if self.cfg.dataset.ndc_rays:
                ro, rd, radii = ndc_mipnerf_rays_device(h, w, focal, ro, rd)
                radii = radii[..., None]
        return self.render_flat(ro.reshape(-1, 3), rd.reshape(-1, 3),
                                radii.reshape(-1, 1), generator, sched, keys)

    def render_image_from_pose(self, pose, h: int, w: int, focal,
                               generator: Optional[torch.Generator] = None,
                               sched: Optional[ScheduleValues] = None) -> Maps:
        """Render an ``[h, w]`` image from a [4, 4] (or [3, 4]) camera pose
        -> per-cycle float32 numpy maps (``[h, w, C]`` for per-ray vectors,
        ``[h, w]`` for per-ray scalars, a float for a scalar)."""
        with span(FRAME_ROOT):
            flat = self._render_pose(pose, h, w, focal, generator, sched)
            result: Maps = {0: {}, 1: {}}
            with span("ddnerf.render.to_host"):
                for i in flat:
                    for key, v in flat[i].items():
                        arr = v.float().cpu().numpy()
                        if arr.ndim == 0:
                            result[i][key] = float(arr)
                        else:
                            result[i][key] = (arr.reshape(h, w, -1)
                                              if arr.ndim == 2
                                              else arr.reshape(h, w))
        return result

    def render_images_from_poses(self, poses: Iterable, h: int, w: int,
                                 focal, sched: Optional[ScheduleValues] = None,
                                 ) -> Iterator[Maps]:
        """Yield :meth:`render_image_from_pose` for each pose."""
        for pose in poses:
            yield self.render_image_from_pose(pose, h, w, focal, sched=sched)

    def render_video_frame_from_pose(self, pose, h: int, w: int, focal,
                                     sched: Optional[ScheduleValues] = None,
                                     ) -> Tuple[np.ndarray, np.ndarray]:
        """One video frame from a [4, 4] camera pose: the fine rgb and
        disparity, quantized on the device (:func:`quantize_video_frame`)
        -> ``(rgb_u8 [h, w, 3], disp_u8 [h, w])`` numpy."""
        with span(FRAME_ROOT):
            flat = self._render_pose(pose, h, w, focal, None, sched, VIDEO_KEYS)
            with span("ddnerf.render.quantize"):
                rgb_u8, disp_u8 = quantize_video_frame(flat[1]["rgb"],
                                                       flat[1]["disp"])
            with span("ddnerf.render.to_host"):
                return (rgb_u8.cpu().numpy().reshape(h, w, 3),
                        disp_u8.cpu().numpy().reshape(h, w))

    def render_video_frames_from_poses(
            self, poses: Iterable, h: int, w: int, focal,
            sched: Optional[ScheduleValues] = None,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield :meth:`render_video_frame_from_pose` for each pose."""
        for pose in poses:
            yield self.render_video_frame_from_pose(pose, h, w, focal, sched)
