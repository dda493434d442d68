"""The render cells: frames back to back from one client in a closed loop,
each through ``render/renderer.py::ImageRenderer.render_video_frame_from_pose``
(the path of ``cli/render_video.py``: the validation settings, the
config's ``render_kernel_variant``), from the call to the uint8 maps on
the host.

Poses follow the video's orbit round the scene; the seed picks where on
it the window starts.  Set-up builds the pipeline from the seed's
weights and renders one frame.  The window renders frames until
``--seconds`` have passed: ``render_rays_per_s`` is the pixels of all its
frames over its wall time, ``frame_ms_p90`` the 90th percentile of all
its frames' times.  A traced run then profiles ``traced_frames`` more.
Once the window has closed, frames drawn from the seed are rendered
again by the plain reference and their maps compared.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import compare, counts, scene, tracing
from portbench import harness
from portbench.harness import LayerRun
from portbench.reference import nerf as reference


class Program:
    """The renderer at the cell's sizes, with the seed's weights."""

    def __init__(self, cfg_dict: dict, seed: int, device, clock=None):
        stage = clock.stage if clock is not None else (lambda name: None)
        from ddnerf_tpu_torch.config import Config
        from ddnerf_tpu_torch.models.nerf import NerfPipeline
        from ddnerf_tpu_torch.render.renderer import ImageRenderer

        stage("imports")
        device = torch.device(device)
        harness.start_device(device, stage)
        self.cfg = Config.from_dict(cfg_dict).resolved()
        self.weights = scene.make_weights(cfg_dict, seed, device)
        stage("weights")
        self.pipeline = NerfPipeline(self.cfg, device, seed=0)
        self.pipeline.load_state_dicts(*self.weights.values())
        self.renderer = ImageRenderer(self.cfg, self.pipeline, mode="render")
        stage("pipeline")

    def frame(self, pose, h, w, focal):
        with record_function("portbench.frame"):
            return self.renderer.render_video_frame_from_pose(pose, h, w, focal)

    def window(self, seconds: float, poses, start: int, h, w, focal):
        """Frames until ``seconds`` have passed -> (frames' maps, their
        times in seconds, wall seconds)."""
        maps, times = [], []
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            maps.append(self.frame(poses[(start + len(maps)) % len(poses)], h, w, focal))
            b = time.perf_counter()
            times.append(b - a)
            if b - t0 >= seconds:
                return maps, times, b - t0

    def traced(self, frames: int, poses, h, w, focal):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with record_function(tracing.STRETCH):
                for i in range(frames):
                    self.frame(poses[i % len(poses)], h, w, focal)
                torch.cuda.synchronize()
        return tracing.digest(*tracing.from_profile(prof))


def frame_work(cfg_dict: dict, h: int, w: int):
    specs = scene.net_specs(cfg_dict)
    nets = [(hid, d) for _, hid, d in specs]
    if len(nets) == 1:
        nets = nets * 2
    v = cfg_dict["nerf"]["validation"]
    return counts.frame_work(nets, h * w, v["chunksize"], (v["num_coarse"], v["num_fine"]))


def judged_frames(seed: int, count: int, sample: int):
    """Which of ``count`` frames are compared: ``sample`` drawn from the
    seed (every frame is of one size)."""
    rng = np.random.default_rng(scene.sub_seed(seed, "judged frames"))
    return sorted(rng.choice(count, size=min(sample, count), replace=False).tolist())


def reference_frames(cfg_dict, weights, poses, h, w, focal, quant, device):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    setup = reference.Setup(cfg_dict)
    return [reference.render_frame(setup, weights, p, h, w, focal, quant, device)
            for p in poses]


def run(ctx) -> dict:
    cfg_dict = ctx.config["config"]
    traffic = ctx.traffic
    sc = ctx.config["scene"]
    h, w, focal = sc["height"], sc["width"], scene.focal_of(sc)
    poses = scene.orbit_poses(traffic["orbit_frames"], traffic["elevation_deg"],
                              traffic["orbit_radius"])
    start = scene.sub_seed(ctx.seed, "orbit") % len(poses)
    prog = Program(cfg_dict, ctx.seed, ctx.device, ctx.clock)
    prog.frame(poses[start - 1], h, w, focal)
    ctx.clock.stage("warm-up frame")
    harness.settle()
    setup_s = ctx.clock.total()
    maps, times, wall = prog.window(ctx.seconds, poses, start, h, w, focal)
    digest = (prog.traced(traffic["traced_frames"], poses, h, w, focal)
              if ctx.trace else None)
    peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
    weights = prog.weights
    del prog
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    picks = judged_frames(ctx.seed, len(maps), traffic["judged_frames"])
    ref = reference_frames(cfg_dict, weights,
                           [poses[(start + i) % len(poses)] for i in picks],
                           h, w, focal,
                           reference.QUANTS[cfg_dict["parallel"]["compute_dtype"]],
                           ctx.device)
    flop, bound_ms = frame_work(cfg_dict, h, w)
    p90 = statistics.quantiles(times, n=10)[-1] if len(times) > 1 else times[0]
    print(f"[window] {len(times)} frames, median {1e3 * statistics.median(times):.3f} ms, "
          f"p90 {1e3 * p90:.3f} ms; ms each: "
          f"{' '.join(f'{1e3 * t:.1f}' for t in times)}", file=sys.stderr)
    return {
        "numbers": compare.frame_numbers([maps[i] for i in picks], ref),
        "attempted": len(maps),
        "failed": 0,
        "end_to_end": {"render_rays_per_s": len(maps) * h * w / wall,
                       "frame_ms_p90": 1e3 * p90, "setup_s": setup_s},
        "layer": LayerRun("render", len(maps), wall, flop, bound_ms, digest,
                          traffic["traced_frames"]),
        "peak_bytes": peak,
    }
