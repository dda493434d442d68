"""Video rendering of a trained run.

Counterpart of ``ddnerf_tpu/render/video.py::render_model_video``
(reference render_video.py:17-106): reads the config snapshot and
a checkpoint of a logdir, renders the dataset's render-pose path and
writes a side-by-side rgb | disparity video at 24 fps
(``video/video.avi``, frames ``[H, 2W, 3]``) and, on request, one PNG per
frame (``video/frame_%04d.png``).  Each frame is rendered on the device
and only its uint8 maps come to the host (:meth:`~ddnerf_tpu_torch.
render.renderer.ImageRenderer.render_video_frames_from_poses`).

The files are written by :mod:`ddnerf_tpu_torch.render.media`, with the
standard library, on every machine: an uncompressed AVI of 24-bit DIB
frames where the JAX package writes DIVX through OpenCV, and PNGs where it
uses imageio.

Under ``torchrun`` with more than one rank every rank renders its share of
each frame, the whole frame is quantized after the gather, and rank 0 alone
writes the files and prints (``ddnerf_tpu/render/video.py:28-30,54,83``).

``profile_frames`` > 0 first renders that many frames with the tracer live
and prints their stage table, then as many under ``torch.profiler``, whose
Chrome trace goes under ``logdir/plugins/profile/`` (:func:`_profile_frames`).
"""

from __future__ import annotations

import os
import time

import numpy as np

from ddnerf_tpu_torch.data.assembly import get_datasets
from ddnerf_tpu_torch.eval.evaluate import load_pipeline, resolve_device
from ddnerf_tpu_torch.models.nerf import ScheduleValues
from ddnerf_tpu_torch.parallel.mesh import maybe_mesh
from ddnerf_tpu_torch.render.media import AviWriter, write_png
from ddnerf_tpu_torch.render.renderer import ImageRenderer
from ddnerf_tpu_torch.train.checkpoint import load_config_snapshot
from ddnerf_tpu_torch.utils import profiling


def side_by_side(rgb: np.ndarray, disp: np.ndarray) -> np.ndarray:
    """``rgb [H, W, 3]`` and ``disp [H, W]`` uint8 -> the video frame
    ``[H, 2W, 3]``: rgb on the left, the disparity as grey on the right."""
    return np.concatenate([rgb, np.repeat(disp[..., None], 3, axis=-1)],
                          axis=1)


def _profile_frames(renderer: ImageRenderer, poses, h: int, w: int, focal,
                   sched: ScheduleValues, frames: int, logdir: str,
                   primary: bool = True) -> None:
    """Where a video frame's time goes: one frame to warm up, then
    ``frames`` frames of ``poses`` (from the first, round the path) with
    the tracer live and no profiler, whose stage table is printed (device
    ms from CUDA events, host ms), then as many under ``torch.profiler``,
    its Chrome trace (with the tracer's spans) under
    ``logdir/plugins/profile/`` and its digest printed.  Every rank renders;
    rank 0 (``primary``) alone prints and traces."""
    poses = [poses[i % len(poses)] for i in range(frames)]
    renderer.render_video_frame_from_pose(poses[0], h, w, focal, sched)
    profiling.enable()
    profiling.reset()
    try:
        for profiled in (False, True):
            with profiling.trace(logdir, enable=primary and profiled) as prof:
                for _ in renderer.render_video_frames_from_poses(
                        poses, h, w, focal, sched):
                    pass
            if primary and not profiled:
                print(profiling.stage_table(profiling.snapshot(),
                                            profiling.FRAME_ROOT), flush=True)
    finally:
        profiling.disable()
    if prof is not None:
        print(f"[profile] trace of {frames} frames: {prof.trace_path}")
        print(profiling.summarize(prof, frames, unit="frame"), flush=True)


def render_model_video(basedir: str, save_images: bool = False,
                       fps: int = 24, max_frames: int = 0,
                       torch_checkpoint: str | None = None,
                       checkpoint_step: int | None = None,
                       device: str = "cuda", profile_frames: int = 0) -> str:
    """Render the video of the run in ``basedir``: the first ``max_frames``
    render poses (0: all) at the dataset's resolution, from the logdir's
    newest checkpoint, its retained ``checkpoint_step`` or the file
    ``torch_checkpoint``; first, with ``profile_frames`` > 0, that many
    frames with the tracer live and as many under the profiler
    (:func:`_profile_frames`).  Returns the path of ``video.avi``."""
    savedir = os.path.join(basedir, "video")
    cfg = load_config_snapshot(basedir)
    mesh = maybe_mesh(cfg, device)
    dev = resolve_device(device) if mesh is None else mesh.device
    primary = mesh is None or mesh.primary
    if primary:
        os.makedirs(savedir, exist_ok=True)

    _, val_ds, cfg = get_datasets(cfg)
    pipeline = load_pipeline(basedir, cfg, dev, torch_checkpoint,
                             checkpoint_step, mesh)
    sched = ScheduleValues.for_eval(cfg)
    renderer = ImageRenderer(cfg, pipeline, mode="render")
    h, w = val_ds.H, val_ds.W

    if profile_frames:
        _profile_frames(renderer, val_ds.render_poses, h, w, val_ds.focal,
                        sched, profile_frames, basedir, primary)
    n = len(val_ds.render_poses)
    if max_frames:
        n = min(n, max_frames)
    path = os.path.join(savedir, "video.avi")
    frames = renderer.render_video_frames_from_poses(
        val_ds.render_poses[:n], h, w, val_ds.focal, sched=sched)
    times = []
    if not primary:  # render this rank's shares; rank 0 writes
        for _ in frames:
            pass
        return path
    with AviWriter(path, 2 * w, h, fps) as writer:
        for idx in range(n):
            t0 = time.perf_counter()
            rgb, disp = next(frames)  # uint8 on the host: the frame is done
            times.append(time.perf_counter() - t0)
            frame = side_by_side(rgb, disp)
            writer.write(frame)
            if save_images:
                write_png(os.path.join(savedir, f"frame_{idx:04d}.png"),
                          frame)
            print(f"frame {idx}/{n} ({times[-1]:.2f}s)")
    if times:
        print(f"avg render time per frame: {np.mean(times):.3f}s on {dev}")
    print(f"video written to {path}")
    return path
