"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the repository root.  Phases, each of which fails the run:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the CUDA kernels from ``ddnerf_tpu_torch/kernels/csrc``;
3. kernel vs plain: the fused MLP kernel against its plain PyTorch version
   for DepthMipMLP and MipMLP at width 256 on one production chunk (16384
   rays x 32 samples) and on ragged shapes, with CUDA-event timings;
4. main path: ``python -m ddnerf_tpu_torch.cli.eval`` on a logdir holding
   ``configs/synthetic_smoke.yml`` and a seeded checkpoint; results.txt
   must hold finite PSNR / SSIM and the render must launch the kernel;
5. full-size frame: one 800x800 render through the kernel and through the
   plain version, compared by PSNR, with both wall times.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside this file, the run exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "synthetic_smoke.yml")

# Kernel vs plain on the raw [N, 4|6] outputs: both round operands to bf16
# and accumulate in f32, so they differ by summation order and the bf16
# re-roundings of activations that an order change can flip.
MAX_ABS_TOL = 2e-2
MEAN_ABS_TOL = 1e-3
FRAME_PSNR_MIN = 40.0  # dB between the kernel's and the plain 800x800 rgb
CHUNK_RAYS, SAMPLES = 16384, 32
FRAME = 800  # the blender lego resolution
TIMING_REPS = 10


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"[device] torch {torch.__version__} CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    return card


def phase_build():
    from ddnerf_tpu_torch.kernels import build

    info = build.build()
    state = "cached" if info.cached else "built"
    print(f"[build] {state} {info.path.name} in {info.seconds:.1f} s", flush=True)
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")
    build.load_library()


def _event_ms(torch, fn, reps=TIMING_REPS):
    """Median device time of ``fn`` over ``reps`` launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def phase_kernel(torch):
    from ddnerf_tpu_torch.kernels.fused_mlp import fused_mlp_forward
    from ddnerf_tpu_torch.kernels.reference import fused_mlp_reference
    from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP

    dev = torch.device("cuda")
    worst, timing = 0.0, {}
    for cls in (DepthMipMLP, MipMLP):
        gen = torch.Generator().manual_seed(0)
        net = cls(hidden_size=256, compute_dtype=torch.bfloat16,
                  generator=gen).to(dev)
        # (rays, samples): one production chunk, then ragged row counts
        # (not multiples of the kernel's 128-row tile) and K != 32.
        for rays, k in ((CHUNK_RAYS, SAMPLES), (333, SAMPLES), (129, 33)):
            ipe = (torch.rand(rays * k, 96, generator=gen) * 2 - 1).to(dev)
            dirs = (torch.rand(rays, 27, generator=gen) * 2 - 1).to(dev)
            out = fused_mlp_forward(net, ipe, dirs, k)
            ref = fused_mlp_reference(net, ipe, dirs, k)
            torch.cuda.synchronize()
            err = (out - ref).abs()
            max_err, mean_err = err.max().item(), err.mean().item()
            worst = max(worst, max_err)
            ok = (torch.isfinite(out).all().item() and max_err <= MAX_ABS_TOL
                  and mean_err <= MEAN_ABS_TOL)
            print(f"[kernel] {cls.__name__} N={rays * k} K={k}: max_abs "
                  f"{max_err:.3e} (tol {MAX_ABS_TOL:g}), mean_abs "
                  f"{mean_err:.3e} (tol {MEAN_ABS_TOL:g}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"fused_mlp_fwd disagrees with the plain version "
                     f"({cls.__name__}, N={rays * k}, K={k})")
            if rays == CHUNK_RAYS:
                ms = _event_ms(torch, lambda: fused_mlp_forward(net, ipe, dirs, k))
                plain = _event_ms(torch,
                                  lambda: fused_mlp_reference(net, ipe, dirs, k))
                flop = 2 * rays * k * sum(
                    p.numel() for n_, p in net.named_parameters()
                    if n_.endswith("weight"))
                print(f"[kernel] {cls.__name__} N={rays * k}: kernel "
                      f"{ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s), plain "
                      f"{plain:.3f} ms (CUDA-event medians of "
                      f"{TIMING_REPS})", flush=True)
                timing[cls.__name__] = (ms, plain)
    return worst, timing


def write_logdir(logdir):
    """``logdir/config.yml`` (configs/synthetic_smoke.yml) and a
    ``checkpoint.ckpt`` of the port's seeded initialization."""
    from ddnerf_tpu_torch.config import load_config
    from ddnerf_tpu_torch.models.nerf import NerfPipeline
    from ddnerf_tpu_torch.utils.weights import save_checkpoint

    cfg = load_config(CONFIG)
    with open(os.path.join(logdir, "config.yml"), "w") as f:
        f.write(cfg.dump())
    pipe = NerfPipeline(cfg, "cpu", seed=0)
    save_checkpoint(os.path.join(logdir, "checkpoint.ckpt"), pipe.coarse,
                    pipe.fine, step=0)


def phase_main_path():
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as logdir:
        write_logdir(logdir)
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        cmd = [sys.executable, "-m", "ddnerf_tpu_torch.cli.eval",
               "--logdir", logdir, "--max-images", "2"]
        t0 = time.perf_counter()
        # A fresh process: its kernel launch counts start at 0.
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=900)
        wall = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            print(f"[eval] {line}")
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            fail(f"eval CLI exited {proc.returncode}")
        results = os.path.join(logdir, "validation", "results.txt")
        if not os.path.isfile(results):
            fail("eval wrote no validation/results.txt")
        with open(results) as f:
            metrics = re.findall(
                r"^(?:image \d+ , )?((?:psnr|ssim)\w*):\s*(\S+)$", f.read(),
                re.M)
        if len(metrics) < 12 or not all(math.isfinite(float(v))
                                        for _, v in metrics):
            fail(f"results.txt metrics not all finite: {metrics}")
        m = re.search(r"^kernel launches: (\{.*\})$", proc.stdout, re.M)
        launches = json.loads(m.group(1)) if m else {}
    print(f"[eval] {len(metrics)} finite PSNR/SSIM values, wall {wall:.1f} s, "
          f"launches {launches}", flush=True)
    if launches.get("fused_mlp_fwd", 0) <= 0:
        fail("the eval render did not launch fused_mlp_fwd")
    return launches


def _pose(theta_deg=30.0, phi_deg=-30.0, radius=4.0):
    """Blender-convention camera on a sphere, looking at the origin."""
    th, ph = math.radians(theta_deg), math.radians(phi_deg)
    trans = np.eye(4, dtype=np.float32)
    trans[2, 3] = radius
    rot_phi = np.eye(4, dtype=np.float32)
    rot_phi[1, 1] = rot_phi[2, 2] = math.cos(ph)
    rot_phi[1, 2], rot_phi[2, 1] = -math.sin(ph), math.sin(ph)
    rot_th = np.eye(4, dtype=np.float32)
    rot_th[0, 0] = rot_th[2, 2] = math.cos(th)
    rot_th[0, 2], rot_th[2, 0] = -math.sin(th), math.sin(th)
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                    np.float32)
    return flip @ rot_th @ rot_phi @ trans


def phase_frame(torch):
    from ddnerf_tpu_torch.config import load_config
    from ddnerf_tpu_torch.kernels.fused_mlp import LAUNCHES
    from ddnerf_tpu_torch.models.nerf import NerfPipeline
    from ddnerf_tpu_torch.render.renderer import ImageRenderer

    cfg = load_config(CONFIG)
    focal = 0.5 * FRAME / math.tan(0.5 * 0.6911)  # the lego camera's FOV
    pose = _pose()
    renderers = {}
    for name, policy in (("kernel", "auto"), ("plain", "off")):
        c = cfg.replace_at("parallel.pallas_mlp", policy)
        renderers[name] = ImageRenderer(c, NerfPipeline(c, "cuda", seed=0))

    def render(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = renderers[name].render_image_from_pose(pose, FRAME, FRAME, focal)
        return out, time.perf_counter() - t0

    for name in renderers:  # warm-up at a small size
        renderers[name].render_image_from_pose(pose, 32, 32, focal * 32 / FRAME)
    walls = {"kernel": [], "plain": []}
    outs = {}
    for name in ("plain", "kernel", "kernel", "plain"):
        LAUNCHES["fused_mlp_fwd"] = 0
        outs[name], wall = render(name)
        walls[name].append(wall)
        if name == "kernel":
            chunks = -(-FRAME * FRAME // cfg.nerf.validation.chunksize)
            if LAUNCHES["fused_mlp_fwd"] != 2 * chunks:
                fail(f"800x800 kernel render launched fused_mlp_fwd "
                     f"{LAUNCHES['fused_mlp_fwd']} times, expected {2 * chunks}")
    rgb_k, rgb_p = outs["kernel"][1]["rgb"], outs["plain"][1]["rgb"]
    if rgb_k.shape != (FRAME, FRAME, 3) or not np.isfinite(rgb_k).all():
        fail(f"800x800 kernel render: shape {rgb_k.shape} or non-finite rgb")
    mse = float(np.mean((rgb_k - rgb_p) ** 2))
    frame_psnr = float("inf") if mse == 0 else -10.0 * math.log10(mse)
    print(f"[frame] 800x800 wall: kernel {walls['kernel']} s, plain "
          f"{walls['plain']} s; rgb PSNR kernel vs plain {frame_psnr:.2f} dB "
          f"(gate {FRAME_PSNR_MIN:g})", flush=True)
    if not frame_psnr >= FRAME_PSNR_MIN:
        fail("800x800 kernel frame disagrees with the plain version")
    return min(walls["kernel"]), min(walls["plain"])


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    try:
        import ddnerf_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"ddnerf_tpu_torch is not importable beside chip_smoke.py ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 matmuls exact

    t_start = time.perf_counter()
    phase_device(torch)
    phase_build()
    max_err, timing = phase_kernel(torch)
    launches = phase_main_path()
    frame_kernel_s, frame_plain_s = phase_frame(torch)
    print(f"[frame] best of two: kernel {frame_kernel_s:.3f} s, plain "
          f"{frame_plain_s:.3f} s; whole run {time.perf_counter() - t_start:.1f} s")
    if "jax" in sys.modules:
        fail("JAX was imported")

    ms, plain_ms = timing["DepthMipMLP"]
    print(json.dumps({"kernels": [{
        "name": "fused_mlp_fwd",
        "route": "cuda",
        "source": "ddnerf_tpu_torch/kernels/csrc/fused_mlp_fwd.cu",
        "replaces": "ddnerf_tpu/kernels/fused_mlp.py:464",
        "launches": launches["fused_mlp_fwd"],
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
