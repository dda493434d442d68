"""Replayed chunk graphs against eager chunks in 800x800 video frames, on
one NVIDIA GPU.

    python3 scripts/ab_render_graphs.py [--config configs/blender_dd.yml]
        [--size 800] [--frames 20] [--busy 0]

Renders video frames of the config (seeded random weights) round the
benchmark's orbit (``portbench/traffic/render.json``: 180 poses at -30
degrees, radius 4), through ``ImageRenderer.render_video_frame_from_pose``
as it ships (one CUDA graph per chunk shape, ``render/graphs.py``) and with
the same renderer's chunks run eagerly, in turns eager, graph, graph,
eager.  Per mode: the first frame's wall (the graph mode's captures), the
median and 90th percentile of ``--frames`` frames' walls, and one frame
under ``torch.profiler``: its host calls into the CUDA runtime by name
(``cudaLaunchKernel`` and ``cudaGraphLaunch`` are the launches) and its
device busy time.  Each frame pair's maps are compared, and must be
equal.  ``--busy N`` first starts N CPU-bound processes beside the
renderer and stops them at the end.  The first line is the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ddnerf_tpu_torch.config import load_config  # noqa: E402
from ddnerf_tpu_torch.data.synthetic import pose_spherical  # noqa: E402
from ddnerf_tpu_torch.models.nerf import NerfPipeline  # noqa: E402
from ddnerf_tpu_torch.render.renderer import ImageRenderer  # noqa: E402
from ddnerf_tpu_torch.utils import profiling  # noqa: E402


def spin() -> None:
    """A CPU-bound process: counts until it is terminated."""
    n = 0
    while True:
        n += 1


def frames(renderer, poses, size, focal):
    walls, maps = [], []
    for pose in poses:
        t0 = time.perf_counter()
        maps.append(renderer.render_video_frame_from_pose(pose, size, size, focal))
        walls.append(time.perf_counter() - t0)
    return walls, maps


def profiled(renderer, pose, size, focal):
    """One frame under the profiler -> (host runtime calls by name, device
    busy ms)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        renderer.render_video_frame_from_pose(pose, size, size, focal)
        torch.cuda.synchronize()
    calls = {e.key: e.count for e in prof.key_averages()
             if e.key.startswith("cuda")}
    kernels = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.time_range.end > e.time_range.start]
    return calls, profiling._union(kernels) / 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="configs/blender_dd.yml")
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--busy", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    spinners = [multiprocessing.get_context("spawn").Process(target=spin,
                                                             daemon=True)
                for _ in range(args.busy)]
    for p in spinners:
        p.start()
    try:
        run(args)
    finally:
        for p in spinners:
            p.terminate()
            p.join(timeout=10)


def run(args):
    cfg = load_config(os.path.join(REPO, args.config))
    size = args.size
    focal = 0.5 * size / math.tan(0.5 * 0.6911112070083618)
    poses = [np.asarray(pose_spherical(a, -30.0, 4.0))
             for a in np.linspace(-180.0, 180.0, 181)[:-1]]
    pipe = NerfPipeline(cfg, "cuda", seed=0)
    graph = ImageRenderer(cfg, pipe, mode="render")
    eager = ImageRenderer(cfg, pipe, mode="render")
    eager._graphs = None  # the same renderer with its chunks run eagerly
    modes = {"graph": graph, "eager": eager}
    for name, renderer in modes.items():
        t0 = time.perf_counter()
        renderer.render_video_frame_from_pose(poses[0], size, size, focal)
        print(f"[{name}] first frame {time.perf_counter() - t0:.3f} s"
              f"{' (captures the graphs)' if name == 'graph' else ''}",
              flush=True)
    print(f"[graph] render.graph_nodes {profiling.counter('render.graph_nodes')}, "
          f"graph.captures {profiling.counter('graph.captures')}", flush=True)
    walls = {name: [] for name in modes}
    for turn, name in enumerate(("eager", "graph", "graph", "eager")):
        at = 1 + turn * args.frames
        w, maps = frames(modes[name], poses[at:at + args.frames], size, focal)
        walls[name] += w
        other = "graph" if name == "eager" else "eager"
        ref = modes[other].render_video_frame_from_pose(poses[at], size, size,
                                                        focal)
        same = all(np.array_equal(a, b) for a, b in zip(maps[0], ref))
        print(f"[turn {turn}] {name}: median {1e3 * statistics.median(w):.2f} ms; "
              f"first frame equal to {other}'s: {same}", flush=True)
        if not same:
            raise SystemExit("the graph and eager frames differ")
    for name, w in walls.items():
        p90 = statistics.quantiles(w, n=10)[-1]
        q = statistics.quantiles(w, n=4)
        print(f"[{name}] {len(w)} frames: median {1e3 * statistics.median(w):.2f} "
              f"ms, p90 {1e3 * p90:.2f} ms, spread (Q3-Q1)/median "
              f"{100 * (q[2] - q[0]) / statistics.median(w):.2f}%; "
              f"rays/s {len(w) * size * size / sum(w):,.0f}", flush=True)
    for name, renderer in modes.items():
        calls, busy = profiled(renderer, poses[5], size, focal)
        launches = calls.get("cudaLaunchKernel", 0) + calls.get("cudaGraphLaunch", 0)
        top = ", ".join(f"{k} {v}" for k, v in sorted(calls.items(),
                                                      key=lambda kv: -kv[1])[:8])
        print(f"[{name}] one profiled frame: {launches} launch calls "
              f"(cudaLaunchKernel + cudaGraphLaunch), device busy {busy:.2f} ms; "
              f"runtime calls: {top}", flush=True)


if __name__ == "__main__":
    main()
