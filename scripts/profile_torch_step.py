"""Where a train step's time goes in the PyTorch port, on one NVIDIA GPU.

    python3 scripts/profile_torch_step.py [--steps 20] [--top 12]
        [dot.path value ...]

Trains ``configs/synthetic_smoke.yml`` (the full DDNeRF model, 2048 rays per
step, seeded random weights; ``nerf.type GeneralMipNerfModel`` as an
override profiles the mip-NeRF step) through the fused-MLP kernels (``pallas_mlp:
auto``) and through the plain version (``off``).  For each: the unprofiled
ms/step over ``--steps`` steady steps (host clock, ending in a
synchronise), then 5 steady steps under ``torch.profiler``: device busy time
(the sum of the device kernels' times) per step, the device span (first
kernel start to last kernel end), the device kernels launched per step and
the largest kernels by total time, per step.  The first line is the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ddnerf_tpu_torch.config import load_config  # noqa: E402
from ddnerf_tpu_torch.data.datasets import (  # noqa: E402
    load_train_store,
    sample_rays_on_device,
)
from ddnerf_tpu_torch.models.nerf import NerfPipeline  # noqa: E402
from ddnerf_tpu_torch.train.state import TrainState  # noqa: E402
from ddnerf_tpu_torch.train.step import train_step  # noqa: E402

WARMUP, PROFILED = 5, 5


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("opts", nargs="*", default=[],
                    help="Config overrides as 'dot.path value' pairs.")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg = load_config(os.path.join(REPO, "configs", "synthetic_smoke.yml"))
    if args.opts:
        cfg = cfg.merge_from_list(args.opts).resolved()
        print("overrides: " + " ".join(args.opts), flush=True)
    store, _, cfg = load_train_store(cfg, dev)
    rays = cfg.nerf.train.num_random_rays
    for name, policy in (("kernel", "auto"), ("plain", "off")):
        c = cfg.replace_at("parallel.pallas_mlp", policy)
        pipe = NerfPipeline(c, dev, seed=0)
        state = TrainState(c, pipe)
        draw = torch.Generator(device=dev).manual_seed(7)
        gen = torch.Generator(device=dev).manual_seed(11)

        def step():
            ro, rd, radii, rgb = sample_rays_on_device(
                store, draw, rays, c.dataset.single_image_mode)
            return train_step(c, pipe, state, {
                "origins": ro, "directions": rd, "radii": radii, "rgb": rgb},
                gen)

        for _ in range(WARMUP):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / args.steps
        print(f"[{name}] {ms:.2f} ms/step unprofiled over {args.steps} steps "
              f"({rays / ms * 1e3:,.0f} rays/s), ray draw included",
              flush=True)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                step()
            torch.cuda.synchronize()
        # Device activities only: a profiler annotation of the host side
        # (the optimizer's step) also shows on the device track, as a span
        # over the kernels it holds, and would count them twice.
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        busy = sum(e.device_time for e in kernels) / 1e3
        span = (max(e.time_range.end for e in kernels)
                - min(e.time_range.start for e in kernels)) / 1e3
        print(f"[{name}] per step under the profiler: device busy "
              f"{busy / PROFILED:.2f} ms of a {span / PROFILED:.2f} ms span "
              f"({100 * busy / span:.1f}% busy), "
              f"{len(kernels) / PROFILED:.0f} device kernels", flush=True)
        totals = {}
        for e in kernels:
            t = totals.setdefault(e.name, [0.0, 0])
            t[0] += e.device_time / 1e3
            t[1] += 1
        for kname, (total, count) in sorted(totals.items(),
                                            key=lambda kv: -kv[1][0])[:args.top]:
            print(f"[{name}]   {total / PROFILED:7.3f} ms  "
                  f"{count / PROFILED:6.1f} launches  {kname[:100]}",
                  flush=True)


if __name__ == "__main__":
    main()
