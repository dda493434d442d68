"""Where an 800x800 frame's time goes in the PyTorch port, on one NVIDIA GPU.

    python3 scripts/profile_torch_frame.py [--size 800] [--top 8]

Renders one frame of ``configs/synthetic_smoke.yml`` (the full DDNeRF model,
seeded random weights) through the in-kernel-IPE forward
(``render_kernel_variant: ipe2``), through the forward fed the torch IPE
(``mlp``) and, unprofiled only, through the plain version.  For each kernel
path: the unprofiled wall of an image render and of a uint8 video frame
(best of three), then one render under ``torch.profiler`` through
``utils/profiling.py::summarize``: device busy time (the union of the
device kernels' intervals), the device span (first kernel start to last
kernel end), the number of device kernels and the largest kernels by total
time.  The first line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import math
import os
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
from ddnerf_tpu_torch.utils.profiling import summarize  # noqa: E402


def best_wall(fn, reps=3):
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return min(walls)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    cfg = load_config(os.path.join(REPO, "configs", "synthetic_smoke.yml"))
    size = args.size
    focal = 0.5 * size / math.tan(0.5 * 0.6911)
    pose = np.asarray(pose_spherical(30.0, -30.0, 4.0))
    for name, policy, variant in (("ipe2", "auto", "ipe2"),
                                  ("mlp", "auto", "mlp"),
                                  ("plain", "off", "mlp")):
        c = cfg.replace_at("parallel.pallas_mlp", policy).replace_at(
            "parallel.render_kernel_variant", variant)
        renderer = ImageRenderer(c, NerfPipeline(c, "cuda", seed=0))
        image = lambda: renderer.render_image_from_pose(pose, size, size, focal)
        video = lambda: renderer.render_video_frame_from_pose(pose, size, size,
                                                              focal)
        renderer.render_image_from_pose(pose, 32, 32, focal * 32 / size)
        image()
        print(f"[{name}] wall, image / uint8 video frame: "
              f"{best_wall(image):.3f} / {best_wall(video):.3f} s", flush=True)
        if policy == "off":
            continue
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            image()
            torch.cuda.synchronize()
        print(summarize(prof, 1, top=args.top, tag=name, unit="frame"),
              flush=True)


if __name__ == "__main__":
    main()
