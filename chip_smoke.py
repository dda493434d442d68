"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the repository root.  Phases, each of which fails the run:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the CUDA kernels from ``ddnerf_tpu_torch/kernels/csrc``
   and print ptxas' registers, spill bytes and advisories for each: at
   widths 128 and 256 there must be no spill and no advisory;
3. forward kernel vs plain: the fused MLP forward (render mode) against
   its plain PyTorch version for DepthMipMLP and MipMLP at width 256 on one
   production chunk (16384 rays x 32 samples) and on ragged shapes, with
   CUDA-event timings;
3b. in-kernel-IPE forward vs plain: the forward that computes the IPE
   itself from raw means and covariances, against its plain version at the
   same shapes and bit for bit against the forward fed the torch
   direct-form IPE, with CUDA-event timings of it, its plain version and
   the forward plus the torch IPE assembly;
4. training kernels vs plain: the stash forward (outputs bit-identical to
   render mode, activation slabs within the forward tolerances) and the
   fused backward (every gradient within its norm-relative tolerance,
   bitwise repeatable) against their plain versions at the training shape
   (2048 rays x 32 samples), the NDC path's training shapes (2048 rays x 16
   and x 17 samples), a ragged one, and ragged ones at widths 128 and 64,
   with CUDA-event timings;
5. training main path: ``python -m ddnerf_tpu_torch.cli.train`` on
   ``configs/synthetic_smoke.yml`` for 200 iterations, the step a captured
   CUDA graph replayed in blocks (the CLI's default on the card; the run
   must say so): finite losses, a lower mean loss over the last 20
   iterations than over the first 20, a validation line, ``config.yml`` and
   ``checkpoint_200.ckpt``, and two launches of each training kernel per
   step, the replays' counted by what the graph holds;
5b. the captured step against the eager step: two runs from one seed for 40
   iterations, bitwise the same metrics, parameters, Adam state and
   generator state, and both ms/step (DDNeRF and mip-NeRF);
5c. host-side sampling: the training CLI with ``parallel.max_store_gb 0``
   (rays sampled on the host, one batch uploaded ahead, the eager step)
   for 40 iterations: the loss falls, two launches of each training kernel
   per step;
5d. ``--profile-steps 5``: a short captured run that must print the
   profile's digest with device activity and leave the trace file;
6. serving main path: ``python -m ddnerf_tpu_torch.cli.eval`` on the
   trained logdir; results.txt must hold finite PSNR / SSIM and the render
   must launch the forward kernel;
6b. video main path: ``python -m ddnerf_tpu_torch.cli.render_video`` for 8
   frames with ``--save_images``, on a sibling of the trained logdir whose
   config selects ``parallel.render_kernel_variant: ipe2`` (only the
   in-kernel-IPE forward may launch, twice per chunk and frame) and on the
   trained logdir itself (``mlp``: only the forward kernel); video.avi and
   the PNGs must hold the 8 frames;
7. kernel vs plain training: two pipelines from one seed, ``pallas_mlp:
   auto`` and ``off``, on the same 20 batches with identically seeded
   generators; loss trajectories within a stated gap, and both step times;
8. full-size frame: one 800x800 render through the forward kernel, the
   in-kernel-IPE forward and the plain version, each kernel render compared
   with the plain one by PSNR, with the wall times; and the 800x800 video
   frame (uint8) of the in-kernel-IPE path against the plain one;
9. mip-NeRF main path (``nerf.type GeneralMipNerfModel``: one shared
   MipMLP through both cycles): phases 5, 6 and 6b again with that
   override (the eval with ``--save_images``: the image dumps must
   decode), phase 7 on the shared net, the summed two-call gradient of
   each leaf through the backward kernel against the plain backward on
   the same forward, and an 800x800 frame through the forward kernel, the
   in-kernel-IPE forward and the plain version;
10. NDC main path: a forward-facing scene written to disk in the LLFF
   layout, ``configs/ff_dd.yml`` (NDC rays, depth analysis on a keypoint
   file written here) trained by the CLI, stopped and run again (it must
   resume at the iteration it stopped at and keep the configured number of
   step checkpoints), evaluated with ``--save_images --extract_ptc`` (every
   artifact must exist and decode), one video frame, an NDC frame
   through both forward kernels against the plain version by PSNR, and on
   that scene and config phase 7 and phase 9's per-leaf gradient check
   (both networks), so that the training kernels are held against their
   plain versions at this path's shapes and cotangents too;
11. one rank under NCCL: the training CLI launched by torchrun as one
   rank, a group of one whose two all-reduces are captured in the step's
   CUDA graph, for phase 5's 200 iterations; its records and checkpoint
   must equal phase 5's run (the same command without torchrun) bitwise;
12. two ranks sharing card 0 under gloo (the eager step): the training
   loop with host sampling, and 20 steps on batches whose halves hold
   different numbers of empty rays, each against one process on the same
   global batches (per-step loss gap, per-leaf parameter gap); the same
   steps without the dp loss's count all-reduce must fail those gates,
   ``step_mode='graph'`` under gloo must be refused, and each rank must
   launch 2 B1s + 2 B2 per step;
13. eval (with LPIPS) and video on two ranks sharing card 0: results.txt,
   the image dumps, frames of both forward kernels and an NDC frame must
   equal what one process wrote in phases 6b, 9 and 10, bitwise, rank 0
   alone writing and printing;
14. LPIPS of two rendered images on the card against the CPU's value;
15. real-360 main path (``configs/real360_dd.yml`` and, shorter,
   ``configs/real360_mipnerf.yml``): a ring of cameras written to disk in
   the LLFF layout, trained by the CLI at full width under the captured
   step (the snapshot must hold near / far after ``normalize_poses``),
   evaluated on one image, frames of the spherical video path through B1
   (``mlp``) and through B3 (``ipe2``), and a frame of each forward kernel
   against the plain version by PSNR;
16. the dress rehearsals, ``scripts/dress_rehearsal_torch.sh`` and its
   ``--llff``: the dataset writer, then 3,000 iterations of
   ``configs/blender_dd.yml`` / ``configs/ff_dd.yml`` at 400 x 400 through
   the train, eval and video CLIs; ``psnr_fine`` must reach the JAX
   package's gates (19.0 and 27.0), and the SSIMs, the loop's ms/step and
   each CLI's wall are printed.

The second-to-last line is the kernel table as JSON (each kernel's time
beside its plain version's and beside ``bound_ms``, the least time the card
could take for the same work, see :func:`_bound_ms`); the last line is
``{"ok": true, "device": {...}}``.  A kernel's ``launches`` there is the
sum over the main paths of phases 5, 5c, 5d, 6, 6b, 9, 10, 11, 12, 13, 15
and 16 (over every rank), each counted from 0.  The single-process CLI
runs of phases 5-10 and 15 are calls of each CLI's ``main`` in one worker
process, one after another, every count set to 0 before each call; the
rehearsals and the torchrun launches are processes of their own.  Every
Python process a phase starts, every rank included, lists its imports, and
none may import JAX, the JAX package, imageio or matplotlib.  Without CUDA, or
without the package beside this file, the run exits non-zero and prints no
result.
"""

from __future__ import annotations

import atexit
import importlib.util
import json
import math
import os
import pickle
import re
import select
import signal
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
VIDEO_FRAMES = 8
VIDEO_HW = (64, 64)  # the procedural synthetic scene's resolution
TIMING_REPS = 10
# Published peaks of one H100 SXM (dense, no sparsity), for the bounds.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# The training shape: 2048 rays x 32 samples per network per step.
TRAIN_RAYS = 2048
# Fused backward vs its plain version, per gradient: ||kernel - plain|| /
# ||plain|| (Frobenius).  Both take bf16 operands and accumulate in f32;
# they differ in summation order (split-K partials, tile order), and an
# order change can flip the bf16 rounding of a cotangent element, which
# then propagates down the dgrad chain, so the difference grows from the
# heads towards layer 0.  Readings at both shapes, both networks (NVIDIA
# H100 80GB HBM3, 700 W): trunk leaves <= 7.1e-4 (layers_xyz.0), the
# leaves after the trunk <= 4.1e-5.  The faults each limit must fail:
# weight gradients rounded to bf16, or biases summed after the cotangent's
# rounding, read >= 1.47e-3 on every trunk leaf and >= 4.8e-4 after it.
GRAD_NORM_REL_TOL_TRUNK = 1e-3  # layers_xyz.*
GRAD_NORM_REL_TOL_HEADS = 1.5e-4  # fc_feat, fc_alpha, layers_dir, fc_rgb, ...
# B2 accumulates the weight gradients in f32: of their nonzero elements,
# at most this share may be exactly representable in bf16 (read <= 0.8%,
# the most at width 128; weight gradients rounded to bf16 read 100%).
WEIGHT_GRAD_BF16_SHARE_MAX = 0.05
TRAIN_ITERS = 200
LOSS_WINDOW = 20  # iterations averaged at each end of the training run
PARITY_STEPS = 20
GRAPH_STEPS = 40  # captured vs eager, and the host-sampling run
PROFILE_ITERS, PROFILE_STEPS = 30, 5  # the --profile-steps run
# Kernel vs plain training, per step: |loss_kernel - loss_plain| /
# loss_plain.  The two differ in summation order and in the weight
# gradients (f32 in the kernel, rounded to bf16 by the plain path's cast).
# Read 1.26e-6.  Faults injected into B2's gradients read: the dir layer's
# zeroed 3.0e-3, every bias zeroed 1.0e-3, trunk layers 0-3 zeroed 2.4e-5,
# every gradient x0.1 2.2e-5.  Layer 0 alone zeroed (1.5e-6) and
# bf16-rounded weight gradients (5.3e-7) are invisible in 20 early steps:
# the per-gradient gates above catch those.
PARITY_GAP_TOL = 1e-5
MIPNERF = ("nerf.type", "GeneralMipNerfModel")  # the CLI override
FF_CONFIG = os.path.join(REPO, "configs", "ff_dd.yml")
# The NDC scene: 10 views of 512 x 512, which the config's
# downsample_factor 4 minifies to 128 x 128; llffhold 8 holds out 2.
NDC_SCENE_SIZE, NDC_SCENE_VIEWS, NDC_HW = 512, 10, (128, 128)
NDC_ITERS = (20, 40)  # the first run stops at 20, the rerun goes on to 40
NDC_KEEP = 2  # experiment.max_keep_ckpts of that run
# Rows per ray of that config's two training evaluations (num_coarse 16;
# the fine pass adds one).
NDC_SAMPLES = (16, 17)
# Modules that must not have been imported when the run ends: the JAX
# package and its frameworks, and the libraries not every installation has.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "ddnerf_tpu",
                     "imageio", "matplotlib")


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
    # Looked up, never imported: the port must not come to need them.
    print("[device] installed here: " + ", ".join(
        f"{m} {'yes' if importlib.util.find_spec(m) else 'no'}"
        for m in ("jax", "imageio", "matplotlib", "tensorboardX", "cv2",
                  "PIL")), flush=True)
    return card


def phase_build():
    from ddnerf_tpu_torch.kernels import build

    info = build.build()
    state = "cached" if info.cached else "built"
    print(f"[build] {state} {info.path.name} in {info.seconds:.1f} s", flush=True)
    report = build.ptxas_report(info.log)
    if not info.cached and not report:
        fail("the build log holds no ptxas report (-Xptxas -v)")
    bad = []
    for r in report:
        print(f"[build]   {r.name}: {r.registers} registers, "
              f"{r.spill_bytes} spill bytes"
              + "".join(f"; {a}" for a in r.advisories))
        # Widths 128 and 256 (a kernel's first template argument) and the
        # small kernels must neither spill nor draw an advisory: a wgmma
        # kernel that does runs its products one at a time.
        width = re.search(r"<(\d+)", r.name)
        if (not width or int(width.group(1)) >= 128) and (
                r.spill_bytes or r.advisories):
            bad.append(r.name)
    if bad:
        fail(f"ptxas reports spills or advisories for {bad}")
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


def _forward_macs(net, rows, rays):
    """Multiply-adds of one forward of ``net``: every weight once per row,
    except the dir layer's view-direction columns, once per ray."""
    per_row = sum(p.numel() for name, p in net.named_parameters()
                  if name.endswith("weight"))
    dirs_part = net.dir_hidden * 27
    return rows * (per_row - dirs_part) + rays * dirs_part


def _param_bytes(net):
    """The kernels read weights as bf16 and biases as f32."""
    return sum(p.numel() * (2 if name.endswith("weight") else 4)
               for name, p in net.named_parameters())


def _bound_ms(flop, nbytes):
    """The least time the card could take: the larger of the operations
    over the dense bf16 peak and the bytes (each input read once, each
    output written once) over the device-memory rate -> (ms, which)."""
    t_flop, t_bytes = flop / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_flop, t_bytes) * 1e3, ("operations" if t_flop >= t_bytes
                                        else "bytes")


def kernel_bounds(net, rows, rays, train_rows, train_rays):
    """``{kernel: (bound_ms, bound_by)}`` at the shapes that were timed:
    the forwards B1 / B3 on ``rows`` (``rays`` rays), the training pair B1s
    / B2 on ``train_rows``.  Forward: 2 FLOP per multiply-add; it reads the
    IPE (96 bf16 per row; B3: means and covs, 6 f32), the dirs (27 bf16
    per ray) and the parameters, and writes out_dim f32 per row; B1s also
    writes the stash, (9 H + 128) bf16 per row.  Backward: the weight
    gradients repeat the forward's multiply-adds, the cotangent chain
    repeats all but those whose input is the IPE or the dirs (layer 0, the
    skip layer's IPE columns, the dir layer's dirs columns); it reads the
    IPE, the dirs, the cotangent (out_dim f32 per row), the stash and the
    weights, and writes one f32 gradient per parameter."""
    hid, out_dim = net.hidden_size, net.out_dim
    params = _param_bytes(net)
    n_params = sum(p.numel() for p in net.parameters())
    out = {}
    fwd = 2 * _forward_macs(net, rows, rays)
    io = rays * 27 * 2 + params + rows * out_dim * 4
    out["fused_mlp_fwd"] = _bound_ms(fwd, io + rows * 96 * 2)
    out["fused_enc_mlp_fwd"] = _bound_ms(fwd, io + rows * 6 * 4)
    macs = _forward_macs(net, train_rows, train_rays)
    stash = train_rows * (9 * hid + 128) * 2
    io = train_rows * 96 * 2 + train_rays * 27 * 2 + params
    out["fused_mlp_fwd_stash"] = _bound_ms(
        2 * macs, io + train_rows * out_dim * 4 + stash)
    no_dgrad = train_rows * 2 * 96 * hid + train_rays * net.dir_hidden * 27
    out["fused_mlp_bwd"] = _bound_ms(
        2 * (2 * macs - no_dgrad),
        io + train_rows * out_dim * 4 + stash + n_params * 4)
    return out


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
    # A yardstick the port never calls: one trunk layer's product through
    # the library.  No single PyTorch call computes the fused network, so
    # the kernels' library_ms stays null.
    a = torch.randn(CHUNK_RAYS * SAMPLES, 256, device=dev,
                    dtype=torch.bfloat16)
    w = torch.randn(256, 256, device=dev, dtype=torch.bfloat16)
    print(f"[kernel] yardstick: torch.matmul [{a.shape[0]}, 256] x [256, 256] "
          f"bf16 {_event_ms(torch, lambda: a @ w.T):.3f} ms (one trunk "
          f"layer's product, activations through device memory)", flush=True)
    return worst, timing


def _gaussians(torch, gen, n, dev):
    """Section means within +-3 (2^15 x 3 engages the 100 pi wrap of the
    sin argument) and covariances over six decades, as cast_rays gives
    them."""
    means = (torch.rand(n, 3, generator=gen) * 6 - 3).to(dev)
    covs = (10.0 ** (torch.rand(n, 3, generator=gen) * 6 - 7)).to(dev)
    return means, covs


def phase_enc_kernel(torch):
    """The in-kernel-IPE forward (B3) against its plain version and against
    B1 fed the torch direct-form IPE, on the same inputs."""
    from ddnerf_tpu_torch.core.math import integrated_pos_enc
    from ddnerf_tpu_torch.kernels.fused_mlp import (
        fused_enc_mlp_forward,
        fused_mlp_forward,
    )
    from ddnerf_tpu_torch.kernels.reference import fused_enc_mlp_reference
    from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP

    dev = torch.device("cuda")
    worst, timing = 0.0, {}
    for cls in (DepthMipMLP, MipMLP):
        gen = torch.Generator().manual_seed(2)
        net = cls(hidden_size=256, compute_dtype=torch.bfloat16,
                  generator=gen).to(dev)
        for rays, k in ((CHUNK_RAYS, SAMPLES), (333, 33)):
            tag = f"{cls.__name__} N={rays * k} K={k}"
            means, covs = _gaussians(torch, gen, rays * k, dev)
            dirs = (torch.rand(rays, 27, generator=gen) * 2 - 1).to(dev)
            out = fused_enc_mlp_forward(net, means, covs, dirs, k)
            ref = fused_enc_mlp_reference(net, means, covs, dirs, k)
            b1 = fused_mlp_forward(
                net, integrated_pos_enc((means, covs), double_angle=False),
                dirs, k)
            torch.cuda.synchronize()
            err = (out - ref).abs()
            max_err, mean_err = err.max().item(), err.mean().item()
            vs_b1 = (out - b1).abs().max().item()
            same = torch.equal(out, b1)
            worst = max(worst, max_err)
            ok = (torch.isfinite(out).all().item() and max_err <= MAX_ABS_TOL
                  and mean_err <= MEAN_ABS_TOL)
            print(f"[enc-kernel] {tag}: max_abs {max_err:.3e} (tol "
                  f"{MAX_ABS_TOL:g}), mean_abs {mean_err:.3e} (tol "
                  f"{MEAN_ABS_TOL:g}) {'ok' if ok else 'FAIL'}; vs B1 fed the "
                  f"torch IPE: max_abs {vs_b1:.3e} "
                  f"({'bit-identical' if same else 'DIFFERS'})", flush=True)
            if not ok:
                fail(f"fused_enc_mlp_fwd disagrees with the plain version "
                     f"({tag})")
            if not same:
                fail(f"fused_enc_mlp_fwd is not bit-identical to "
                     f"fused_mlp_fwd fed the direct-form IPE ({tag})")
            if rays != CHUNK_RAYS:
                continue
            t = {
                "enc": _event_ms(torch, lambda: fused_enc_mlp_forward(
                    net, means, covs, dirs, k)),
                "plain": _event_ms(torch, lambda: fused_enc_mlp_reference(
                    net, means, covs, dirs, k)),
                # What the mlp variant runs: the torch IPE (the config's
                # default double-angle form), then B1.
                "b1_ipe": _event_ms(torch, lambda: fused_mlp_forward(
                    net, integrated_pos_enc((means, covs)), dirs, k)),
                "ipe": _event_ms(torch, lambda: integrated_pos_enc(
                    (means, covs))),
            }
            print(f"[enc-kernel] {tag}: B3 {t['enc']:.3f} ms, plain B3 "
                  f"{t['plain']:.3f} ms, torch IPE + B1 {t['b1_ipe']:.3f} ms "
                  f"(the IPE alone {t['ipe']:.3f} ms) (CUDA-event medians of "
                  f"{TIMING_REPS})", flush=True)
            timing[cls.__name__] = t
    return worst, timing


def _rel(a, b):
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def phase_train_kernels(torch):
    """The stash forward (B1s) and the fused backward (B2) against their
    plain versions, on the same inputs."""
    from ddnerf_tpu_torch.kernels import fused_mlp as fk
    from ddnerf_tpu_torch.kernels import reference as ref
    from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP

    dev = torch.device("cuda")
    worst = {"fused_mlp_fwd_stash": 0.0, "fused_mlp_bwd": 0.0}
    timing = {}
    for cls in (DepthMipMLP, MipMLP):
        gen = torch.Generator().manual_seed(1)
        nets = {}
        # The training shape, the NDC path's two and a ragged one at width
        # 256, then the two narrower widths (other tile widths of the
        # backward's weight gradients) at ragged row counts with K = 13
        # and 7.
        for hidden, rays, k in ((256, TRAIN_RAYS, SAMPLES),
                                *((256, TRAIN_RAYS, k) for k in NDC_SAMPLES),
                                (256, 333, 33), (128, 700, 13), (64, 517, 7)):
            if hidden not in nets:
                nets[hidden] = cls(hidden_size=hidden,
                                   compute_dtype=torch.bfloat16,
                                   generator=gen).to(dev)
            net = nets[hidden]
            n = rays * k
            tag = f"{cls.__name__} H={hidden} N={n} K={k}"
            ipe = (torch.rand(n, 96, generator=gen) * 2 - 1).to(dev)
            dirs = (torch.rand(rays, 27, generator=gen) * 2 - 1).to(dev)
            g = torch.randn(n, net.out_dim, generator=gen).to(dev)
            out_r = fk.fused_mlp_forward(net, ipe, dirs, k)
            out_s, stash = fk.fused_mlp_forward(net, ipe, dirs, k, stash=True)
            torch.cuda.synchronize()
            if not torch.equal(out_r, out_s):
                fail(f"stash-mode outputs differ from render mode ({tag})")
            ref_out, ref_stash = ref.fused_mlp_stash_reference(net, ipe, dirs,
                                                               k)
            slabs = list(stash.trunk) + [stash.h]
            ref_slabs = list(ref_stash.trunk) + [ref_stash.h]
            errs = [(a.float() - b.float()).abs() for a, b in
                    zip([out_s] + slabs, [ref_out] + ref_slabs)]
            max_err = max(e.max().item() for e in errs)
            mean_err = max(e.mean().item() for e in errs)
            ok = max_err <= MAX_ABS_TOL and mean_err <= MEAN_ABS_TOL
            print(f"[train-kernel] B1s {tag}: outputs bit-identical to render "
                  f"mode; outputs + 10 stash slabs vs plain: max_abs "
                  f"{max_err:.3e} (tol {MAX_ABS_TOL:g}), worst slab mean_abs "
                  f"{mean_err:.3e} (tol {MEAN_ABS_TOL:g}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"fused_mlp_fwd_stash disagrees with the plain version "
                     f"({tag})")
            worst["fused_mlp_fwd_stash"] = max(worst["fused_mlp_fwd_stash"],
                                               max_err)

            grads = fk.fused_mlp_backward(net, ipe, dirs, g, k, stash)
            again = fk.fused_mlp_backward(net, ipe, dirs, g, k, stash)
            torch.cuda.synchronize()
            if not all(torch.equal(grads[name], again[name]) for name in grads):
                fail(f"fused_mlp_bwd is not bitwise repeatable ({tag})")
            plain = ref.fused_mlp_backward_reference(net, ipe, dirs, g, k,
                                                     stash)
            bad = []
            for name in plain:
                rel = _rel(grads[name], plain[name])
                abs_err = (grads[name] - plain[name]).abs().max().item()
                worst["fused_mlp_bwd"] = max(worst["fused_mlp_bwd"], abs_err)
                tol = (GRAD_NORM_REL_TOL_TRUNK
                       if name.startswith("layers_xyz.")
                       else GRAD_NORM_REL_TOL_HEADS)
                ok, share = rel <= tol, ""
                if name.endswith("weight"):
                    nz = grads[name][grads[name] != 0]
                    frac = (nz == nz.bfloat16().float()).float().mean().item()
                    share = (f", bf16-exact share {frac:.4f} (max "
                             f"{WEIGHT_GRAD_BF16_SHARE_MAX:g})")
                    ok = ok and frac <= WEIGHT_GRAD_BF16_SHARE_MAX
                if not ok:
                    bad.append(name)
                print(f"[train-kernel] B2 {tag} d{name}: norm_rel {rel:.3e} "
                      f"(tol {tol:g}), max_abs {abs_err:.3e}{share}")
            print(f"[train-kernel] B2 {tag}: {len(plain)} gradients, bitwise "
                  f"repeatable, {'all within tolerance' if not bad else bad}",
                  flush=True)
            if bad:
                fail(f"fused_mlp_bwd disagrees with the plain version "
                     f"({tag}: {bad})")
            if (rays, k) != (TRAIN_RAYS, SAMPLES):
                continue
            t = {
                "fwd_stash": _event_ms(torch, lambda: fk.fused_mlp_forward(
                    net, ipe, dirs, k, stash=True)),
                "bwd": _event_ms(torch, lambda: fk.fused_mlp_backward(
                    net, ipe, dirs, g, k, stash)),
                "plain_fwd": _event_ms(torch, lambda: ref.
                                       fused_mlp_stash_reference(net, ipe,
                                                                 dirs, k)),
                "plain_bwd": _event_ms(torch, lambda: ref.
                                       fused_mlp_backward_reference(
                                           net, ipe, dirs, g, k, stash)),
            }
            weights = sum(p.numel() for n_, p in net.named_parameters()
                          if n_.endswith("weight"))
            flop = 6 * n * weights  # forward + dgrad + wgrad
            kern = t["fwd_stash"] + t["bwd"]
            print(f"[train-kernel] {tag}: B1s {t['fwd_stash']:.3f} ms + B2 "
                  f"{t['bwd']:.3f} ms = {kern:.3f} ms "
                  f"({flop / kern / 1e9:.1f} TFLOP/s); plain forward "
                  f"{t['plain_fwd']:.3f} ms + plain backward "
                  f"{t['plain_bwd']:.3f} ms = "
                  f"{t['plain_fwd'] + t['plain_bwd']:.3f} ms (CUDA-event "
                  f"medians of {TIMING_REPS})", flush=True)
            timing[cls.__name__] = t
    return worst, timing


def _sum_launches(*counts):
    """Launch counts of several runs, added per kernel."""
    total = {}
    for c in counts:
        for name, n in c.items():
            total[name] = total.get(name, 0) + n
    return total


# Every Python process a phase starts (each rank of a launch too) lists
# its imports on stderr (PYTHONPROFILEIMPORTTIME); the run fails at the end
# if one of them imported a forbidden module.
_IMPORT_LINE = re.compile(r"^import time:\s+\d+ \|\s+\d+ \|\s*(\S+)$", re.M)
IMPORTS_SEEN = {"processes": 0, "leaked": set()}


def _subprocess(cmd, tag, timeout=900, env=None):
    """Run ``cmd`` from the repository root in a fresh process (its kernel
    launch counts start at 0; ``env``: variables to add), echo its stdout,
    fail on a non-zero exit or at ``timeout``, when the process and all it
    started are killed."""
    env = dict(os.environ, PYTHONPROFILEIMPORTTIME="1", **(env or {}))
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"{tag}: {' '.join(cmd[2:4])} ran past its {timeout} s")
    wall = time.perf_counter() - t0
    _audit_imports(stderr)
    for line in stdout.splitlines():
        print(f"[{tag}] {line}")
    if proc.returncode != 0:
        errors = [ln for ln in stderr.splitlines()
                  if not ln.startswith("import time:")]
        print("\n".join(errors)[-4000:], file=sys.stderr)
        fail(f"{tag}: {' '.join(cmd[2:4])} exited {proc.returncode}")
    m = re.search(r"^kernel launches: (\{.*\})$", stdout, re.M)
    return stdout, (json.loads(m.group(1)) if m else {}), wall


def _audit_imports(stderr):
    """Add the processes and forbidden imports that ``stderr`` (written
    under PYTHONPROFILEIMPORTTIME) lists to the run's audit."""
    IMPORTS_SEEN["processes"] += stderr.count("import time: self [us]")
    IMPORTS_SEEN["leaked"].update(
        m for m in _IMPORT_LINE.findall(stderr)
        if m.split(".")[0] in FORBIDDEN_MODULES)


# The CLIs of the single-process main paths run one after another in one
# Python process, each a call of its module's ``main(argv)`` (what
# ``python -m`` runs) with every launch count set to 0 just before it: a
# process of its own for each would pay its set-up, about 12 s, each time.
# The worker answers each request with one JSON line on a copy of its
# stdout; what the CLI prints is captured, and any other write to fd 1
# goes to its stderr.
_CLI_WORKER = r"""
import contextlib, importlib, io, json, os, sys, time, traceback
replies = os.fdopen(os.dup(1), "w")
os.dup2(2, 1)
from ddnerf_tpu_torch.kernels.fused_mlp import LAUNCHES
for request in sys.stdin:
    module, argv = json.loads(request)
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    out, error, t0 = io.StringIO(), None, time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            importlib.import_module(module).main(argv)
    except BaseException:
        error = traceback.format_exc()
    replies.write(json.dumps({"out": out.getvalue(), "error": error,
                              "wall": time.perf_counter() - t0}) + "\n")
    replies.flush()
"""
CLI_WORKER = {"proc": None, "stderr": None}


def _kill_cli_worker():
    proc = CLI_WORKER["proc"]
    if proc is not None and proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def _cli(cmd, tag, timeout=900):
    """Run ``cmd``, ``[python, -m, ddnerf_tpu_torch.cli.X, *argv]``, in the
    CLI worker (started on first use) and echo what it printed; fail if it
    raised or ran past ``timeout``.  Returns (stdout, launch counts, wall
    of the call) as :func:`_subprocess` does."""
    if CLI_WORKER["proc"] is None:
        env = dict(os.environ, PYTHONPROFILEIMPORTTIME="1")
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        CLI_WORKER["stderr"] = tempfile.TemporaryFile("w+")
        CLI_WORKER["proc"] = subprocess.Popen(
            [sys.executable, "-c", _CLI_WORKER], cwd=REPO, env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=CLI_WORKER["stderr"], text=True, start_new_session=True)
        atexit.register(_kill_cli_worker)
    proc = CLI_WORKER["proc"]
    proc.stdin.write(json.dumps([cmd[2], cmd[3:]]) + "\n")
    proc.stdin.flush()
    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    line = proc.stdout.readline() if ready else ""
    if not line:
        _kill_cli_worker()
        CLI_WORKER["stderr"].seek(0)
        errors = [ln for ln in CLI_WORKER["stderr"].read().splitlines()
                  if not ln.startswith("import time:")]
        print("\n".join(errors)[-4000:], file=sys.stderr)
        fail(f"{tag}: {cmd[2]} " + ("ended the CLI worker" if ready else
                                    f"ran past its {timeout} s"))
    reply = json.loads(line)
    for out_line in reply["out"].splitlines():
        print(f"[{tag}] {out_line}")
    if reply["error"]:
        print(reply["error"][-4000:], file=sys.stderr)
        fail(f"{tag}: {' '.join(cmd[2:4])} raised")
    m = re.search(r"^kernel launches: (\{.*\})$", reply["out"], re.M)
    return reply["out"], (json.loads(m.group(1)) if m else {}), reply["wall"]


def _close_cli_worker():
    """End the CLI worker (its card memory is freed for the later phases)
    and add its imports to the audit."""
    proc = CLI_WORKER["proc"]
    if proc is None:
        return
    proc.stdin.close()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        _kill_cli_worker()
    CLI_WORKER["stderr"].seek(0)
    _audit_imports(CLI_WORKER["stderr"].read())
    CLI_WORKER["proc"] = None
    if proc.returncode != 0:
        fail(f"the CLI worker exited {proc.returncode}")


def _check_train_output(out, tag):
    """Finite ``[TRAIN]`` and ``[VAL]`` lines -> the iterations printed."""
    train_lines = re.findall(r"^\[TRAIN\] iter (\d+) loss (\S+) psnr (\S+)",
                             out, re.M)
    val_lines = re.findall(r"^\[VAL\] iter \d+ loss (\S+) psnr (\S+)", out,
                           re.M)
    if not train_lines or not all(math.isfinite(float(a)) and
                                  math.isfinite(float(b))
                                  for _, a, b in train_lines):
        fail(f"{tag}: [TRAIN] lines missing or not finite: {train_lines}")
    if not val_lines or not all(math.isfinite(float(a)) and
                                math.isfinite(float(b)) for a, b in val_lines):
        fail(f"{tag}: [VAL] lines missing or not finite: {val_lines}")
    return [int(i) for i, _, _ in train_lines]


def phase_train_main_path(logroot, tag="train", opts=(), run="synthetic_smoke"):
    """The training CLI at full width (``opts``: config overrides);
    returns (logdir, launch counts)."""
    from ddnerf_tpu_torch.train.checkpoint import load_config_snapshot

    cmd = [sys.executable, "-m", "ddnerf_tpu_torch.cli.train", "--config",
           CONFIG, "--max-iters", str(TRAIN_ITERS),
           "experiment.logdir", logroot, "experiment.id", run, *opts]
    out, launches, wall = _cli(cmd, tag)
    logdir = os.path.join(logroot, run)
    _check_train_output(out, tag)
    if not re.search(r"^step mode: graph .*blocks of up to \d+", out, re.M):
        fail(f"{tag}: the CLI did not say that it runs the captured step in "
             f"blocks")
    for name in ("config.yml", "metrics.jsonl",
                 f"checkpoint_{TRAIN_ITERS}.ckpt"):
        if not os.path.isfile(os.path.join(logdir, name)):
            fail(f"{tag}: training wrote no {name} in {logdir}")
    is_dd = load_config_snapshot(logdir).is_ddnerf()
    if is_dd != bool(re.search(r"^\[VAL\] .* dp_loss \S+$", out, re.M)):
        fail(f"{tag}: the [VAL] line must carry dp_loss for DDNeRF only")
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    records = [r for r in records if r["kind"] == "train"]
    losses = [r["loss"] for r in records]
    if len(losses) != TRAIN_ITERS or not all(map(math.isfinite, losses)):
        fail(f"{tag}: metrics.jsonl holds {len(losses)} finite train losses, "
             f"expected {TRAIN_ITERS}")
    if is_dd != ("dp_loss" in records[0]):
        fail(f"{tag}: the train records must carry dp_loss for DDNeRF only")
    first = statistics.mean(losses[:LOSS_WINDOW])
    last = statistics.mean(losses[-LOSS_WINDOW:])
    # The loop's own pace, from the time stamps of its last two block ends
    # (a block's records are written when its one copy to the host has
    # arrived, which ends the block; no validation falls between them).
    ends = [r for r in records if "rays_per_sec" in r][-2:]
    step_ms = (ends[1]["time"] - ends[0]["time"]) * 1e3 / (
        ends[1]["step"] - ends[0]["step"])
    print(f"[{tag}] mean loss of iterations 0-{LOSS_WINDOW - 1}: {first:.5f}, "
          f"of the last {LOSS_WINDOW}: {last:.5f}; {step_ms:.2f} ms/step "
          f"over iterations {ends[0]['step'] + 1}-{ends[1]['step']}; wall "
          f"{wall:.1f} s, launches {launches}", flush=True)
    if not last < first:
        fail(f"{tag}: training did not lower the mean loss")
    for name in ("fused_mlp_fwd_stash", "fused_mlp_bwd"):
        if launches.get(name) != 2 * TRAIN_ITERS:
            fail(f"{tag}: training launched {name} {launches.get(name)} "
                 f"times, expected {2 * TRAIN_ITERS} (two network "
                 f"evaluations per step)")
    return logdir, launches


def phase_graph_vs_eager(torch, tag="graph", opts=()):
    """The captured step against the eager step from one seed
    (``opts``: config overrides): every metric of every iteration, the
    parameters, Adam's state and the generator's state must be bitwise
    equal; returns both ms/step (steady state, no metric read)."""
    from ddnerf_tpu_torch.config import load_config
    from ddnerf_tpu_torch.data.datasets import load_train_store
    from ddnerf_tpu_torch.kernels.fused_mlp import LAUNCHES
    from ddnerf_tpu_torch.models.nerf import NerfPipeline
    from ddnerf_tpu_torch.train.state import TrainState
    from ddnerf_tpu_torch.train.step import CapturedTrainStep, EagerTrainStep

    dev = torch.device("cuda")
    cfg = load_config(CONFIG)
    if opts:
        cfg = cfg.merge_from_list(list(opts)).resolved()
    store, _, cfg = load_train_store(cfg, dev)
    head = 8  # the warm-up iterations and the capture lie in these
    runs, step_ms = {}, {}
    for mode in ("eager", "graph"):
        pipe = NerfPipeline(cfg, dev, seed=0)
        state = TrainState(cfg, pipe)
        gen = torch.Generator(device=dev).manual_seed(11)
        if mode == "graph":
            stepper = CapturedTrainStep(cfg, pipe, state, store, gen,
                                        max_block=GRAPH_STEPS)
        else:
            stepper = EagerTrainStep.from_store(cfg, pipe, state, store, gen)
        before = dict(LAUNCHES)
        rows = [stepper.run(head).clone()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows.append(stepper.run(GRAPH_STEPS - head).clone())
        torch.cuda.synchronize()
        step_ms[mode] = (time.perf_counter() - t0) * 1e3 / (GRAPH_STEPS - head)
        launched = {k: LAUNCHES[k] - before[k] for k in before
                    if LAUNCHES[k] != before[k]}
        if launched != {"fused_mlp_fwd_stash": 2 * GRAPH_STEPS,
                        "fused_mlp_bwd": 2 * GRAPH_STEPS}:
            fail(f"{tag}: {GRAPH_STEPS} {mode} steps counted {launched}")
        adam = [state.optimizer.state[p][key] for p in pipe.parameters()
                for key in ("exp_avg", "exp_avg_sq", "step")]
        runs[mode] = (stepper.names, torch.cat(rows),
                      [p.detach() for p in pipe.parameters()] + adam
                      + [gen.get_state(), state.lr])
    names, rows_e, tensors_e = runs["eager"]
    _, rows_g, tensors_g = runs["graph"]
    if not torch.isfinite(rows_e).all().item():
        fail(f"{tag}: the eager run's metrics are not finite")
    differ = [names[j] for j in range(len(names))
              if not torch.equal(rows_e[:, j], rows_g[:, j])]
    differ += [f"tensor {i}" for i, (a, b) in
               enumerate(zip(tensors_e, tensors_g)) if not torch.equal(a, b)]
    loss = rows_g[:, names.index("loss")]
    print(f"[{tag}] {GRAPH_STEPS} iterations, captured vs eager: "
          f"{len(names)} metrics per iteration, {len(tensors_e)} state "
          f"tensors: {'bitwise equal' if not differ else differ}; loss "
          f"{loss[0].item():.5f} -> {loss[-1].item():.5f}; eager "
          f"{step_ms['eager']:.2f} ms/step, captured {step_ms['graph']:.2f} "
          f"ms/step (iterations {head}-{GRAPH_STEPS - 1})", flush=True)
    if differ:
        fail(f"{tag}: the captured step differs from the eager step: "
             f"{differ}")
    return step_ms


def phase_host_sampling(logroot, tag="host-sampling"):
    """The training CLI with the ray store kept on the host; returns the
    run's launch counts."""
    cmd = [sys.executable, "-m", "ddnerf_tpu_torch.cli.train", "--config",
           CONFIG, "--max-iters", str(GRAPH_STEPS),
           "experiment.logdir", logroot, "experiment.id", "host_sampling",
           "parallel.max_store_gb", "0", "experiment.print_every", "10",
           # The full rate from the first step: 40 iterations must show.
           "optimizer.lr_delay_steps", "0"]
    out, launches, wall = _cli(cmd, tag)
    _check_train_output(out, tag)
    if not re.search(r"^step mode: eager, .*rays sampled on the host", out,
                     re.M):
        fail(f"{tag}: the CLI did not say that it samples on the host")
    with open(os.path.join(logroot, "host_sampling", "metrics.jsonl")) as f:
        records = [r for r in map(json.loads, f) if r["kind"] == "train"]
    losses = [r["loss"] for r in records]
    if len(losses) != GRAPH_STEPS or not all(map(math.isfinite, losses)):
        fail(f"{tag}: {len(losses)} finite train losses, expected "
             f"{GRAPH_STEPS}")
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    step_ms = (records[-1]["time"] - records[20]["time"]) * 1e3 / (
        GRAPH_STEPS - 21)
    print(f"[{tag}] mean loss of iterations 0-9: {first:.5f}, of the last 10: "
          f"{last:.5f}; {step_ms:.2f} ms/step over iterations 21-"
          f"{GRAPH_STEPS - 1} (a record read per iteration); wall {wall:.1f} "
          f"s, launches {launches}", flush=True)
    if not last < first:
        fail(f"{tag}: training did not lower the mean loss")
    for name in ("fused_mlp_fwd_stash", "fused_mlp_bwd"):
        if launches.get(name) != 2 * GRAPH_STEPS:
            fail(f"{tag}: launched {name} {launches.get(name)} times, "
                 f"expected {2 * GRAPH_STEPS}")
    return launches


def phase_profile_steps(logroot, tag="profile-steps"):
    """``--profile-steps`` through the training CLI under the captured
    step; returns the run's launch counts."""
    cmd = [sys.executable, "-m", "ddnerf_tpu_torch.cli.train", "--config",
           CONFIG, "--max-iters", str(PROFILE_ITERS), "--profile-steps",
           str(PROFILE_STEPS), "experiment.logdir", logroot,
           "experiment.id", "profiled", "experiment.print_every", "10"]
    out, launches, wall = _cli(cmd, tag)
    _check_train_output(out, tag)
    trace = re.search(r"^\[profile\] trace of \d+ steps: (\S+)$", out, re.M)
    digest = re.search(r"^\[profile\] per step: device busy (\S+) ms of a "
                       r"(\S+) ms span .* (\d+) device activities$", out,
                       re.M)
    if not trace or not os.path.isfile(trace.group(1)) or \
            os.path.getsize(trace.group(1)) == 0:
        fail(f"{tag}: no trace file ({trace.group(1) if trace else None})")
    if not digest or not float(digest.group(1)) > 0:
        fail(f"{tag}: the digest shows no device time")
    steps = PROFILE_ITERS + PROFILE_STEPS  # the profiled steps are steps too
    if not os.path.isfile(os.path.join(logroot, "profiled",
                                       f"checkpoint_{steps}.ckpt")):
        fail(f"{tag}: no checkpoint_{steps}.ckpt: the profiled steps must "
             f"advance the step counter")
    print(f"[{tag}] trace {os.path.getsize(trace.group(1))} bytes; per "
          f"replayed step device busy {digest.group(1)} ms, "
          f"{digest.group(3)} graph nodes; wall {wall:.1f} s, launches "
          f"{launches}", flush=True)
    for name in ("fused_mlp_fwd_stash", "fused_mlp_bwd"):
        if launches.get(name) != 2 * steps:
            fail(f"{tag}: launched {name} {launches.get(name)} times, "
                 f"expected {2 * steps}")
    return launches


def _decoded_pngs(folder, names):
    """Read each PNG of ``folder`` -> {name: array}; a missing or
    undecodable file fails the run."""
    from ddnerf_tpu_torch.render.media import read_png

    out = {}
    for name in names:
        path = os.path.join(folder, name)
        if not os.path.isfile(path):
            fail(f"missing artifact {path}")
        out[name] = read_png(path)
    return out


def phase_main_path(logdir, tag="eval", flags=(), images=2):
    """The eval CLI on the trained logdir; returns its launch counts."""
    cmd = [sys.executable, "-m", "ddnerf_tpu_torch.cli.eval",
           "--logdir", logdir, "--max-images", str(images), *flags]
    _, launches, wall = _cli(cmd, tag)
    results = os.path.join(logdir, "validation", "results.txt")
    if not os.path.isfile(results):
        fail(f"{tag}: eval wrote no validation/results.txt")
    with open(results) as f:
        metrics = re.findall(
            r"^(?:image \d+ , )?((?:psnr|ssim)\w*):\s*(\S+)$", f.read(),
            re.M)
    if len(metrics) < 6 * (images + 1) or not all(
            math.isfinite(float(v)) for _, v in metrics):
        fail(f"{tag}: results.txt metrics not all finite: {metrics}")
    print(f"[{tag}] {len(metrics)} finite PSNR/SSIM values, wall {wall:.1f} s, "
          f"launches {launches}", flush=True)
    if launches.get("fused_mlp_fwd", 0) <= 0:
        fail(f"{tag}: the eval render did not launch fused_mlp_fwd")
    return launches


def phase_video_main_path(logdir, tag="video", frames_wanted=VIDEO_FRAMES,
                          hw=VIDEO_HW, step=TRAIN_ITERS):
    """The video CLI on an ``ipe2`` sibling of the trained logdir and on
    the logdir itself (``mlp``), ``frames_wanted`` frames of ``hw`` from
    ``checkpoint_{step}.ckpt``; returns both runs' launch counts summed."""
    from ddnerf_tpu_torch.config import Config
    from ddnerf_tpu_torch.render.media import read_avi, read_png

    cfg = Config.from_yaml(os.path.join(logdir, "config.yml"))
    if cfg.parallel.render_kernel_variant != "mlp":
        fail(f"the trained logdir renders with "
             f"{cfg.parallel.render_kernel_variant!r}, expected 'mlp'")
    sibling = logdir + "_ipe2"
    os.makedirs(sibling)
    with open(os.path.join(sibling, "config.yml"), "w") as f:
        f.write(cfg.replace_at("parallel.render_kernel_variant",
                               "ipe2").dump())
    newest = f"checkpoint_{step}.ckpt"
    os.symlink(os.path.join(logdir, newest), os.path.join(sibling, newest))
    h, w = hw
    chunks = -(-h * w // cfg.nerf.validation.chunksize)
    expected = 2 * chunks * frames_wanted  # two networks per chunk
    runs = {}
    for variant, path, kernel, other in (
            ("ipe2", sibling, "fused_enc_mlp_fwd", "fused_mlp_fwd"),
            ("mlp", logdir, "fused_mlp_fwd", "fused_enc_mlp_fwd")):
        cmd = [sys.executable, "-m", "ddnerf_tpu_torch.cli.render_video",
               "--logdir", path, "--max-frames", str(frames_wanted),
               "--save_images"]
        out, launches, wall = _cli(cmd, f"{tag}-{variant}")
        avi = os.path.join(path, "video", "video.avi")
        if not os.path.isfile(avi) or os.path.getsize(avi) == 0:
            fail(f"video ({variant}) wrote no video.avi")
        frames, fps = read_avi(avi)
        if frames.shape != (frames_wanted, h, 2 * w, 3) or fps != 24:
            fail(f"video.avi ({variant}) holds {frames.shape} at {fps} fps, "
                 f"expected {(frames_wanted, h, 2 * w, 3)} at 24")
        for i in range(frames_wanted):
            png = read_png(os.path.join(path, "video", f"frame_{i:04d}.png"))
            if not np.array_equal(png, frames[i]):
                fail(f"frame_{i:04d}.png ({variant}) differs from the video")
        if frames.std() == 0:
            fail(f"video ({variant}) frames are constant")
        avg = re.search(r"^avg render time per frame: (\S+)s", out, re.M)
        print(f"[{tag}-{variant}] {frames_wanted} frames of "
              f"{frames.shape[1:]} in video.avi ({os.path.getsize(avi)} "
              f"bytes) and as PNGs; avg frame {avg.group(1) if avg else '?'} "
              f"s, wall {wall:.1f} s, launches {launches}", flush=True)
        if launches.get(kernel) != expected or launches.get(other) != 0:
            fail(f"video ({variant}) launched {kernel} "
                 f"{launches.get(kernel)} and {other} {launches.get(other)} "
                 f"times, expected {expected} and 0")
        runs[variant] = (frames, launches)
    diff = np.abs(runs["ipe2"][0].astype(int) - runs["mlp"][0].astype(int))
    print(f"[{tag}] ipe2 vs mlp frames: max {diff.max()} uint8 levels, "
          f"{(diff.max(-1) > 0).mean():.2e} of the pixels differ", flush=True)
    return _sum_launches(runs["ipe2"][1], runs["mlp"][1])


def phase_train_parity(torch, tag="parity", opts=(), config=CONFIG):
    """Kernel vs plain training from one seed on the same batches
    (``opts``: overrides of ``config``)."""
    from ddnerf_tpu_torch.config import load_config
    from ddnerf_tpu_torch.data.datasets import (
        load_train_store,
        sample_rays_on_device,
    )
    from ddnerf_tpu_torch.models.nerf import NerfPipeline
    from ddnerf_tpu_torch.train.state import TrainState
    from ddnerf_tpu_torch.train.step import train_step

    dev = torch.device("cuda")
    cfg = load_config(config)
    if opts:
        cfg = cfg.merge_from_list(list(opts)).resolved()
    store, _, cfg = load_train_store(cfg, dev)
    draw = torch.Generator(device=dev).manual_seed(7)
    batches = []
    for _ in range(PARITY_STEPS):
        ro, rd, radii, rgb = sample_rays_on_device(
            store, draw, cfg.nerf.train.num_random_rays,
            cfg.dataset.single_image_mode)
        batches.append({"origins": ro, "directions": rd, "radii": radii,
                        "rgb": rgb})
    losses, step_ms = {}, {}
    for name, policy in (("kernel", "auto"), ("plain", "off")):
        c = cfg.replace_at("parallel.pallas_mlp", policy)
        pipe = NerfPipeline(c, dev, seed=0)
        state = TrainState(c, pipe)
        gen = torch.Generator(device=dev).manual_seed(11)
        traj, marks = [], {}
        for i, batch in enumerate(batches):
            if i == 5:  # steady state: after the first steps' set-up
                torch.cuda.synchronize()
                marks["t0"] = time.perf_counter()
            traj.append(train_step(c, pipe, state, batch, gen)["loss"])
        torch.cuda.synchronize()
        step_ms[name] = (time.perf_counter() - marks["t0"]) * 1e3 / (
            PARITY_STEPS - 5)
        losses[name] = [float(v) for v in traj]
    gap = max(abs(a - b) / abs(b)
              for a, b in zip(losses["kernel"], losses["plain"]))
    rays = cfg.nerf.train.num_random_rays
    for name in losses:
        print(f"[{tag}] {name} losses: "
              + " ".join(f"{v:.5f}" for v in losses[name]))
        print(f"[{tag}] {name}: {step_ms[name]:.2f} ms/step steady state "
              f"(steps 5-{PARITY_STEPS - 1}), "
              f"{rays / step_ms[name] * 1e3:,.0f} rays/s", flush=True)
    print(f"[{tag}] largest relative loss gap kernel vs plain {gap:.3e} "
          f"(gate {PARITY_GAP_TOL:g})", flush=True)
    if not gap <= PARITY_GAP_TOL or not all(
            math.isfinite(v) for v in losses["kernel"] + losses["plain"]):
        fail(f"{tag}: kernel and plain training trajectories disagree")
    return step_ms


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


def phase_frame(torch, tag="frame", opts=()):
    """800x800 renders of seeded weights, each path twice (``opts``: config
    overrides); returns each path's best wall time."""
    from ddnerf_tpu_torch.config import load_config
    from ddnerf_tpu_torch.kernels.fused_mlp import LAUNCHES
    from ddnerf_tpu_torch.models.nerf import NerfPipeline
    from ddnerf_tpu_torch.render.renderer import ImageRenderer

    cfg = load_config(CONFIG)
    if opts:
        cfg = cfg.merge_from_list(list(opts)).resolved()
    focal = 0.5 * FRAME / math.tan(0.5 * 0.6911)  # the lego camera's FOV
    pose = _pose()
    chunks = -(-FRAME * FRAME // cfg.nerf.validation.chunksize)
    # name -> (pallas_mlp, render_kernel_variant, the kernel it launches)
    paths = {"kernel": ("auto", "mlp", "fused_mlp_fwd"),
             "ipe2": ("auto", "ipe2", "fused_enc_mlp_fwd"),
             "plain": ("off", "mlp", None)}
    renderers = {}
    for name, (policy, variant, _) in paths.items():
        c = cfg.replace_at("parallel.pallas_mlp", policy).replace_at(
            "parallel.render_kernel_variant", variant)
        renderers[name] = ImageRenderer(c, NerfPipeline(c, "cuda", seed=0))

    def render(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = renderers[name].render_image_from_pose(pose, FRAME, FRAME, focal)
        return out, time.perf_counter() - t0

    for name in renderers:  # warm-up at a small size
        renderers[name].render_image_from_pose(pose, 32, 32, focal * 32 / FRAME)
    walls = {name: [] for name in renderers}
    outs = {}
    for name in ("plain", "kernel", "ipe2", "ipe2", "kernel", "plain"):
        for key in LAUNCHES:
            LAUNCHES[key] = 0
        outs[name], wall = render(name)
        walls[name].append(wall)
        kernel = paths[name][2]
        launched = {k: v for k, v in LAUNCHES.items() if v}
        want = {kernel: 2 * chunks} if kernel else {}
        if launched != want:
            fail(f"{tag}: 800x800 {name} render launched {launched}, "
                 f"expected {want}")
    rgb_p = outs["plain"][1]["rgb"]
    for name in ("kernel", "ipe2"):
        rgb = outs[name][1]["rgb"]
        if rgb.shape != (FRAME, FRAME, 3) or not np.isfinite(rgb).all():
            fail(f"{tag}: 800x800 {name} render: shape {rgb.shape} or "
                 f"non-finite rgb")
        mse = float(np.mean((rgb - rgb_p) ** 2))
        frame_psnr = float("inf") if mse == 0 else -10.0 * math.log10(mse)
        print(f"[{tag}] 800x800 rgb PSNR {name} vs plain {frame_psnr:.2f} dB "
              f"(gate {FRAME_PSNR_MIN:g})", flush=True)
        if not frame_psnr >= FRAME_PSNR_MIN:
            fail(f"{tag}: 800x800 {name} frame disagrees with the plain "
                 f"version")
    print(f"[{tag}] 800x800 walls: " + "; ".join(
        f"{name} {walls[name]} s" for name in walls), flush=True)
    video = {name: renderers[name].render_video_frame_from_pose(
        pose, FRAME, FRAME, focal) for name in ("ipe2", "plain")}
    for i, part in enumerate(("rgb", "disp")):
        diff = np.abs(video["ipe2"][i].astype(int)
                      - video["plain"][i].astype(int))
        if diff.ndim == 3:
            diff = diff.max(-1)
        print(f"[{tag}] 800x800 video frame {part}, ipe2 vs plain: max "
              f"{diff.max()} uint8 levels, {(diff > 0).mean():.3e} of the "
              f"pixels differ", flush=True)
    return {name: min(v) for name, v in walls.items()}


def phase_step_gradients(torch, tag, opts, config=CONFIG):
    """One train loss of ``config`` (``opts``: overrides) at its training
    shape, backward through the kernel, and the same step again with the
    plain backward in the kernel's place (the forward stays the kernel, so
    the stash and the cotangents are the same): every leaf of every network
    under the limits of phase 4.  Under mip-NeRF the one net appears twice
    in the autograd graph, and each leaf's gradient is the sum of two
    backward-kernel results."""
    from ddnerf_tpu_torch.config import load_config
    from ddnerf_tpu_torch.data.datasets import (
        load_train_store,
        sample_rays_on_device,
    )
    from ddnerf_tpu_torch.kernels import fused_mlp as fk
    from ddnerf_tpu_torch.kernels import reference as ref
    from ddnerf_tpu_torch.models.nerf import NerfPipeline, RayBatch
    from ddnerf_tpu_torch.train.step import compute_loss, schedule_values

    dev = torch.device("cuda")
    cfg = load_config(config).merge_from_list(list(opts)).resolved()
    store, _, cfg = load_train_store(cfg, dev)
    ro, rd, radii, rgb = sample_rays_on_device(
        store, torch.Generator(device=dev).manual_seed(3),
        cfg.nerf.train.num_random_rays, cfg.dataset.single_image_mode)
    rays = RayBatch.create(ro, rd, radii, cfg.dataset.near, cfg.dataset.far)

    def gradients(backward):
        pipe = NerfPipeline(cfg, dev, seed=0)
        kernel_backward = fk.fused_mlp_backward
        fk.fused_mlp_backward = backward or kernel_backward
        before = dict(fk.LAUNCHES)
        try:
            loss, _ = compute_loss(cfg, pipe, rays, rgb,
                                   schedule_values(cfg, 0),
                                   torch.Generator(device=dev).manual_seed(5))
            loss.backward()
            torch.cuda.synchronize()
        finally:
            fk.fused_mlp_backward = kernel_backward
        launched = {k: fk.LAUNCHES[k] - before[k] for k in before
                    if fk.LAUNCHES[k] != before[k]}
        nets = {"coarse": pipe.coarse, "fine": pipe.fine}
        return (loss.item(), launched,
                {f"{net}.{n}": p.grad for net, module in nets.items()
                 if module is not None
                 for n, p in module.named_parameters()})

    loss_k, launched_k, kernel = gradients(None)
    loss_p, launched_p, plain = gradients(ref.fused_mlp_backward_reference)
    if launched_k != {"fused_mlp_fwd_stash": 2, "fused_mlp_bwd": 2} or \
            launched_p != {"fused_mlp_fwd_stash": 2}:
        fail(f"{tag}: the step launched {launched_k} (kernel backward) and "
             f"{launched_p} (plain backward)")
    if loss_k != loss_p:
        fail(f"{tag}: the same forward gave two losses: {loss_k} and "
             f"{loss_p}")
    bad = []
    for name in plain:
        rel = _rel(kernel[name], plain[name])
        tol = (GRAD_NORM_REL_TOL_TRUNK if ".layers_xyz." in name
               else GRAD_NORM_REL_TOL_HEADS)
        if not rel <= tol:
            bad.append(name)
        print(f"[{tag}] d{name}: norm_rel {rel:.3e} (tol {tol:g})")
    print(f"[{tag}] {len(plain)} leaves, two backward calls per step, loss "
          f"{loss_k:.5f}: {'all within tolerance' if not bad else bad}",
          flush=True)
    if bad:
        fail(f"{tag}: the step's gradient through the backward kernel "
             f"disagrees with the plain backward: {bad}")


def _frame_vs_plain(cfg, tag, what):
    """A frame of the path's first render pose (its validation image's
    size) from seeded weights, through both forward kernels and the plain
    version: each kernel frame within ``FRAME_PSNR_MIN`` of the plain one,
    and each render launching its kernel alone, twice."""
    from ddnerf_tpu_torch.data.assembly import get_datasets
    from ddnerf_tpu_torch.kernels.fused_mlp import LAUNCHES
    from ddnerf_tpu_torch.models.nerf import NerfPipeline
    from ddnerf_tpu_torch.render.renderer import ImageRenderer

    _, val_ds, cfg = get_datasets(cfg)
    pose = val_ds.render_poses[0]
    rgbs = {}
    for name, policy, variant, kernel in (
            ("plain", "off", "mlp", None), ("kernel", "auto", "mlp",
                                            "fused_mlp_fwd"),
            ("ipe2", "auto", "ipe2", "fused_enc_mlp_fwd")):
        c = cfg.replace_at("parallel.pallas_mlp", policy).replace_at(
            "parallel.render_kernel_variant", variant)
        renderer = ImageRenderer(c, NerfPipeline(c, "cuda", seed=0))
        for key in LAUNCHES:
            LAUNCHES[key] = 0
        rgbs[name] = renderer.render_image_from_pose(
            pose, val_ds.H, val_ds.W, val_ds.focal)[1]["rgb"]
        launched = {k: v for k, v in LAUNCHES.items() if v}
        if launched != ({kernel: 2} if kernel else {}):
            fail(f"{tag}: the {name} frame launched {launched}")
    for name in ("kernel", "ipe2"):
        mse = float(np.mean((rgbs[name] - rgbs["plain"]) ** 2))
        frame_psnr = float("inf") if mse == 0 else -10.0 * math.log10(mse)
        print(f"[{tag}] {val_ds.H} x {val_ds.W} {what} rgb PSNR {name} vs "
              f"plain {frame_psnr:.2f} dB (gate {FRAME_PSNR_MIN:g})",
              flush=True)
        if not (frame_psnr >= FRAME_PSNR_MIN
                and np.isfinite(rgbs[name]).all()):
            fail(f"{tag}: the {name} frame disagrees with the plain version")


def phase_ndc_main_path(logroot):
    """The NDC path through the CLIs on an on-disk LLFF scene, with a stop
    and a rerun; returns the launch counts of its runs, summed, and the
    config overrides that name the scene."""
    from ddnerf_tpu_torch.config import load_config
    from ddnerf_tpu_torch.data.synthetic import write_synthetic_llff
    from ddnerf_tpu_torch.render.media import read_avi
    from ddnerf_tpu_torch.train.checkpoint import all_steps

    t0 = time.perf_counter()
    scene = os.path.join(logroot, "ndc_scene")
    write_synthetic_llff(scene, size=NDC_SCENE_SIZE, n=NDC_SCENE_VIEWS, seed=0)
    keypoints = os.path.join(logroot, "keypoints.yml")
    with open(keypoints, "w") as f:  # pixels of the minified validation image
        f.write("img_idx: 0\nresized_by: 4\npixels_and_depth:\n"
                "  0: [40, 50, 3.2]\n  1: [64, 64, 4.0]\n  2: [90, 30, 3.6]\n")
    print(f"[ndc] wrote {NDC_SCENE_VIEWS} views of {NDC_SCENE_SIZE}^2 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    opts = ["experiment.logdir", logroot, "experiment.id", "ndc_smoke",
            "dataset.basedir", scene,
            "train_params.depth_analysis_path", keypoints,
            "experiment.validate_every", "20", "experiment.save_every", "10",
            "experiment.print_every", "10",
            "experiment.max_keep_ckpts", str(NDC_KEEP)]
    logdir = os.path.join(logroot, "ndc_smoke")
    runs = []
    for attempt, (iters, first_iter, steps) in enumerate((
            (NDC_ITERS[0], 0, [11, 20]), (NDC_ITERS[1], 20, [31, 40]))):
        # The same command again, run further: it must go on from the
        # logdir's checkpoint, not start over.
        cmd = [sys.executable, "-m", "ddnerf_tpu_torch.cli.train", "--config",
               FF_CONFIG, "--max-iters", str(iters), *opts]
        out, launches, wall = _cli(cmd, f"ndc-train-{attempt}")
        printed = _check_train_output(out, f"ndc-train-{attempt}")
        resumed = re.search(r"^resumed from .* at iteration (\d+)$", out, re.M)
        at = int(resumed.group(1)) if resumed else None
        done = iters - first_iter
        print(f"[ndc] run {attempt}: [TRAIN] iterations {printed}, resumed at "
              f"{at}, step checkpoints {all_steps(logdir)}, wall {wall:.1f} s, "
              f"launches {launches}", flush=True)
        if printed[0] != first_iter or at != (first_iter or None):
            fail(f"ndc run {attempt} started at iteration {printed[0]} "
                 f"(resumed at {at}), expected {first_iter}")
        if all_steps(logdir) != steps:
            fail(f"ndc run {attempt} kept step checkpoints "
                 f"{all_steps(logdir)}, expected {steps}")
        for name in ("fused_mlp_fwd_stash", "fused_mlp_bwd"):
            if launches.get(name) != 2 * done:
                fail(f"ndc run {attempt} launched {name} "
                     f"{launches.get(name)} times, expected {2 * done}")
        if launches.get("fused_mlp_fwd", 0) <= 0:
            fail(f"ndc run {attempt}: validation did not launch "
                 f"fused_mlp_fwd")
        runs.append(launches)
    if not os.path.isdir(os.path.join(scene, "images_4")):
        fail("the LLFF loader wrote no images_4 cache")

    runs.append(phase_main_path(logdir, "ndc-eval",
                                ("--save_images", "--extract_ptc"), images=1))
    h, w = NDC_HW
    val = os.path.join(logdir, "validation")
    maps = _decoded_pngs(os.path.join(val, "0"), [
        "rgb_coarse.png", "rgb_fine.png", "coarse.png", "fine.png",
        "depth_coarse.png", "depth_fine.png", "mus.png", "gt.png"])
    for name, img in maps.items():
        if img.shape[:2] != (h, w):
            fail(f"validation/0/{name} is {img.shape}, expected {h} x {w}")
    figures = _decoded_pngs(os.path.join(val, "rays"),
                            [f"ray_{j}.png" for j in range(3)])
    if any(img.std() == 0 for img in (*figures.values(), maps["gt.png"])):
        fail("a depth-analysis figure or gt.png is constant")
    ptc = np.load(os.path.join(val, "ptc_0.npy"))
    with open(os.path.join(val, "ray_dict.pkl"), "rb") as f:
        ray_dict = pickle.load(f)
    want_keys = {"uniform_incell_pdf", "gaussian_incell_pdf",
                 "smoothed_gaussian_incell_pdf", "t_vals", "weights"}
    if ptc.shape != (h * w, 6) or not np.isfinite(ptc).all() or \
            not want_keys <= set(ray_dict[1]) or \
            ray_dict[1]["gaussian_incell_pdf"].shape != (3, 1000):
        fail(f"ptc_0.npy {ptc.shape} or ray_dict.pkl {sorted(ray_dict[1])} "
             f"is not what eval should write")
    print(f"[ndc] eval artifacts decode: {len(maps)} maps of {h} x {w}, "
          f"{len(figures)} ray figures of {figures['ray_0.png'].shape}, "
          f"ptc_0.npy {ptc.shape}, ray_dict.pkl {sorted(ray_dict[1])}",
          flush=True)

    cmd = [sys.executable, "-m", "ddnerf_tpu_torch.cli.render_video",
           "--logdir", logdir, "--max-frames", "1", "--save_images",
           "--checkpoint", str(NDC_ITERS[1])]
    out, launches, wall = _cli(cmd, "ndc-video")
    frames, _ = read_avi(os.path.join(logdir, "video", "video.avi"))
    _decoded_pngs(os.path.join(logdir, "video"), ["frame_0000.png"])
    avg = re.search(r"^avg render time per frame: (\S+)s", out, re.M)
    print(f"[ndc-video] {frames.shape} in video.avi, frame "
          f"{avg.group(1) if avg else '?'} s, wall {wall:.1f} s, launches "
          f"{launches}", flush=True)
    if frames.shape != (1, h, 2 * w, 3) or frames.std() == 0:
        fail(f"ndc video.avi holds {frames.shape}")
    cfg = load_config(FF_CONFIG).merge_from_list(
        ["dataset.basedir", scene]).resolved()
    chunks = -(-h * w // cfg.nerf.validation.chunksize)
    if launches.get("fused_mlp_fwd") != 2 * chunks or \
            launches.get("fused_enc_mlp_fwd") != 0:
        fail(f"ndc video launched {launches}, expected {2 * chunks} of "
             f"fused_mlp_fwd only")
    runs.append(launches)

    # An NDC frame of seeded weights through both forward kernels against
    # the plain version: the rays are projected on the card.
    _frame_vs_plain(cfg, "ndc-frame", "NDC")
    return _sum_launches(*runs), ("dataset.basedir", scene)


# ------------------------------------------------------------------------
# The real-360 path (phase 15) and the dress rehearsals (phase 16).
REAL360_CONFIGS = {"dd": os.path.join(REPO, "configs", "real360_dd.yml"),
                   "mipnerf": os.path.join(REPO, "configs",
                                           "real360_mipnerf.yml")}
# The ring scene: 10 views of 200 x 200, which the configs'
# downsample_factor 4 minifies to 50 x 50; llffhold 8 holds out 2.
REAL360_SCENE_SIZE, REAL360_SCENE_VIEWS = 200, 10
REAL360_HW = (50, 50)
# (training iterations, video frames per kernel) of each family's run.
REAL360_RUNS = {"dd": (40, 2), "mipnerf": (20, 1)}
# The configs' near 1 / far 14 after normalize_factor 5.
REAL360_NEAR_FAR = (0.2, 2.8)
# psnr_fine gates of scripts/dress_rehearsal_torch.sh at its default shape
# (400 x 400, 12 views, 3,000 iterations), the JAX package's own gates.
REHEARSALS = {"rehearsal-blender": ((), 19.0, 3000),
              "rehearsal-llff": (("--llff",), 27.0, 3000)}


def phase_real360_main_path(logroot):
    """The real-360 path of both families through the CLIs on a ring of
    cameras written to disk: the captured step for each run's iterations
    at full width, the config's near / far after ``normalize_poses`` in
    the snapshot, eval of one image, frames of the spherical path through
    B1 (``mlp``) and B3 (``ipe2``), and a frame kernel vs plain; returns
    the launch counts of the runs, summed."""
    from ddnerf_tpu_torch.config import load_config
    from ddnerf_tpu_torch.data.synthetic import write_synthetic_real360
    from ddnerf_tpu_torch.train.checkpoint import load_config_snapshot

    t0 = time.perf_counter()
    scene = os.path.join(logroot, "real360_scene")
    write_synthetic_real360(scene, size=REAL360_SCENE_SIZE,
                            n=REAL360_SCENE_VIEWS, seed=0)
    print(f"[real360] wrote {REAL360_SCENE_VIEWS} views of "
          f"{REAL360_SCENE_SIZE}^2 on a ring in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    runs = []
    for family, config in REAL360_CONFIGS.items():
        iters, frames = REAL360_RUNS[family]
        tag, run = f"real360-{family}", f"real360_{family}"
        cmd = [sys.executable, "-m", "ddnerf_tpu_torch.cli.train", "--config",
               config, "--max-iters", str(iters), "dataset.basedir", scene,
               "experiment.logdir", logroot, "experiment.id", run,
               "experiment.validate_every", str(iters // 2),
               "experiment.save_every", str(iters),
               "experiment.print_every", "10"]
        out, launches, wall = _cli(cmd, f"{tag}-train")
        _check_train_output(out, f"{tag}-train")
        if not re.search(r"^step mode: graph ", out, re.M):
            fail(f"{tag}: the CLI did not run the captured step")
        logdir = os.path.join(logroot, run)
        snap = load_config_snapshot(logdir).dataset
        near_far = (snap.near, snap.far)
        print(f"[{tag}] {iters} iterations, wall {wall:.1f} s, near / far "
              f"{near_far}, launches {launches}", flush=True)
        if not np.allclose(near_far, REAL360_NEAR_FAR):
            fail(f"{tag}: the snapshot holds near / far {near_far}, "
                 f"expected {REAL360_NEAR_FAR} (normalize_poses)")
        for name in ("fused_mlp_fwd_stash", "fused_mlp_bwd"):
            if launches.get(name) != 2 * iters:
                fail(f"{tag}: training launched {name} {launches.get(name)} "
                     f"times, expected {2 * iters}")
        if launches.get("fused_mlp_fwd", 0) <= 0:
            fail(f"{tag}: validation did not launch fused_mlp_fwd")
        runs += [launches,
                 phase_main_path(logdir, f"{tag}-eval", images=1),
                 phase_video_main_path(logdir, f"{tag}-video", frames,
                                       REAL360_HW, iters)]
        cfg = load_config(config).merge_from_list(
            ["dataset.basedir", scene]).resolved()
        _frame_vs_plain(cfg, f"{tag}-frame", "spherical-path")
    return _sum_launches(*runs)


def phase_rehearsal(logroot, tag):
    """``scripts/dress_rehearsal_torch.sh`` at its default shape: the
    dataset writer, the three CLIs and the script's own PSNR gate, held
    here too; returns the launch counts of its CLIs, summed."""
    flags, gate, iters = REHEARSALS[tag]
    out, _, wall = _subprocess(
        ["bash", os.path.join(REPO, "scripts", "dress_rehearsal_torch.sh"),
         *flags], tag, timeout=600,
        env={"DRESS_WORKDIR": os.path.join(logroot, tag)})
    launches = _sum_launches(*map(json.loads, re.findall(
        r"^kernel launches: (\{.*\})$", out, re.M)))
    summary = re.search(r"^eval psnr_fine=(\S+) ssim_v1_fine=(\S+) "
                        r"ssim_v2_fine=(\S+) .* loop (\S+) ms/step; wall "
                        r"train (\S+) s, eval (\S+) s, video (\S+) s$",
                        out, re.M)
    if not summary or "DRESS REHEARSAL PASSED" not in out:
        fail(f"{tag}: the rehearsal printed no summary or did not pass")
    psnr = float(summary.group(1))
    print(f"[{tag}] psnr_fine {psnr} (gate {gate}), ssim_v1_fine "
          f"{summary.group(2)}, ssim_v2_fine {summary.group(3)}; loop "
          f"{summary.group(4)} ms/step; CLI walls train {summary.group(5)} "
          f"s, eval {summary.group(6)} s, video {summary.group(7)} s; whole "
          f"script {wall:.1f} s; launches {launches}", flush=True)
    if not psnr >= gate:
        fail(f"{tag}: psnr_fine {psnr} below the gate {gate}")
    for name in ("fused_mlp_fwd_stash", "fused_mlp_bwd"):
        if launches.get(name) != 2 * iters:
            fail(f"{tag}: launched {name} {launches.get(name)} times, "
                 f"expected {2 * iters}")
    return launches


# ------------------------------------------------------------------------
# Data parallelism (phases 11-14): torchrun launches, one card.

TORCHRUN = [sys.executable, "-m", "torch.distributed.run", "--standalone"]
GLOO_ITERS = 20  # phase 12's runs
# Phase 12's own batches: the first EMPTY_RAYS[0] rays of a batch (rank
# 0's half) and EMPTY_RAYS[1] of the second half are shrunk to 1e-12 of
# their length, so they cross no density and the dp loss's mask drops
# them: the ranks keep different numbers of rays, which is where a mean
# of per-rank masked means leaves the global masked mean.
EMPTY_RAYS = (300, 100)
# Two ranks against one process on the same batches, per step:
# |loss_2 - loss_1| / loss_1.  The two differ by the all-reduce's summation
# order of the two halves' gradients and by the backward kernel's row tiles
# (1024 rows a rank against 2048), and Adam turns the sign of a gradient
# element near zero into a whole step: at the config's learning rate
# (5e-6 at first) that stays small, at 5e-4 it read 9.5e-5 after 20 steps
# and hid the fault below.  Read 1.7e-7 (the loop: 7.8e-8).
GLOO_LOSS_GAP_TOL = 1e-5
# Per leaf, the first step's gradient, ||g_2 - g_1|| / ||g_1||, and the
# parameters after GLOO_ITERS steps, ||p_2 - p_1|| / ||p_1 - p_0|| (the gap
# over how far one process moved the leaf).  Read (NVIDIA H100 80GB HBM3,
# 700 W): at most 1.8e-5 and 3.6e-5; without the count all-reduce 5.3e-4
# and 1.4e-3, which both limits fail (the loss gap reads 4.0e-7 then: the
# loss alone cannot see the fault).
GLOO_GRAD_GAP_TOL = 1e-4
GLOO_LEAF_GAP_TOL = 3e-4
GLOO_OPTS = ["nerf.train.perturb", "false",
             "nerf.train.radiance_field_noise_std", "0"]
LPIPS_TOL = 1e-5  # the card's LPIPS against the CPU's, float32 both
LPIPS_SHAPES = [(64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3),
                (256, 384, 3, 3), (256, 256, 3, 3)]


def _records(logdir, kind="train"):
    """``metrics.jsonl``'s records of ``kind``, without their clock."""
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [{k: v for k, v in r.items()
                 if k not in ("time", "rays_per_sec")}
                for r in map(json.loads, f) if r["kind"] == kind]


def _same_tree(a, b, path=""):
    """The leaves of two nested checkpoints where they differ (bitwise)."""
    import torch

    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{path} keys"]
        return [d for k in a for d in _same_tree(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _same_tree(x, y, f"{path}/{i}")]
    if isinstance(a, torch.Tensor):
        return [] if torch.equal(a, b) else [path]
    return [] if a == b else [path]


def _block_ms(records):
    ends = [r for r in records if "rays_per_sec" in r][-2:]
    return (ends[1]["time"] - ends[0]["time"]) * 1e3 / (
        ends[1]["step"] - ends[0]["step"])


def phase_nccl_one_rank(logroot, single_logdir, tag="nccl-1"):
    """The training CLI launched by torchrun as one rank: a group of one
    on NCCL whose two all-reduces (the dp loss's kept count, the flat
    gradients and metrics) are captured in the step's CUDA graph, against
    the same command without torchrun, phase 5's run in ``single_logdir``;
    returns the run's launch counts."""
    import torch

    logdir = os.path.join(logroot, "one_nccl")
    out, launches, wall = _subprocess(
        TORCHRUN + ["--nproc_per_node", "1", "-m",
                    "ddnerf_tpu_torch.cli.train", "--config", CONFIG,
                    "--max-iters", str(TRAIN_ITERS), "experiment.logdir",
                    logroot, "experiment.id", "one_nccl"], f"{tag}-nccl")
    runs = {"single": single_logdir, "nccl": logdir}
    if not re.search(r"^1 rank, backend nccl, cuda:0", out,
                     re.M):
        fail(f"{tag}: the run did not say that it formed a group of one on "
             f"NCCL")
    if not re.search(r"^step mode: graph ", out, re.M):
        fail(f"{tag}: the step was not captured")
    held = re.search(r"^\[graph\] each captured step holds (\d+) "
                     r"all-reduce", out, re.M)
    if not held or int(held.group(1)) != 2:
        fail(f"{tag}: the captured step holds "
             f"{held.group(1) if held else 'no'} all-reduces, expected 2")
    records = {name: _records(path) for name, path in runs.items()}
    if len(records["nccl"]) != TRAIN_ITERS or \
            records["nccl"] != records["single"]:
        fail(f"{tag}: metrics.jsonl under torchrun differs from the single "
             f"process's")
    ckpts = {name: torch.load(os.path.join(
        path, f"checkpoint_{TRAIN_ITERS}.ckpt"), weights_only=True)
        for name, path in runs.items()}
    differ = _same_tree(ckpts["nccl"], ckpts["single"])
    ms = {name: _block_ms([json.loads(line) for line in
                           open(os.path.join(path, "metrics.jsonl"))])
          for name, path in runs.items()}
    print(f"[{tag}] {TRAIN_ITERS} iterations, one rank on NCCL vs one "
          f"process (phase 5): {len(records['nccl'])} records and "
          f"checkpoint_{TRAIN_ITERS}.ckpt "
          f"{'bitwise equal' if not differ else differ}; "
          f"{held.group(1) if held else 'no'} all-reduces per captured "
          f"step; loop pace "
          f"{ms['nccl']:.2f} vs {ms['single']:.2f} ms/step; wall "
          f"{wall:.1f} s", flush=True)
    if differ:
        fail(f"{tag}: the checkpoints differ at {differ[:5]}")
    for name in ("fused_mlp_fwd_stash", "fused_mlp_bwd"):
        if launches.get(name) != 2 * TRAIN_ITERS:
            fail(f"{tag}: launched {name} {launches.get(name)} times, "
                 f"expected {2 * TRAIN_ITERS}")
    return launches, ms


_GLOO_PROGRAM = r'''
"""Phase 12 of chip_smoke.py, on each of two ranks sharing card 0."""
import json, sys, time
import numpy as np
import torch
from ddnerf_tpu_torch.config import load_config
from ddnerf_tpu_torch.kernels.fused_mlp import LAUNCHES
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.parallel import distributed as pdist
from ddnerf_tpu_torch.parallel import mesh as pmesh
from ddnerf_tpu_torch.train.loop import train
from ddnerf_tpu_torch.train.state import TrainState
from ddnerf_tpu_torch.train.step import train_step

config, root, iters = sys.argv[1], sys.argv[2], int(sys.argv[3])
opts = json.loads(sys.argv[4])
mesh = pmesh.init_group("cuda:0")
cfg = load_config(config).merge_from_list(
    opts + ["experiment.logdir", root]).resolved()
res = {"rank": mesh.rank, "describe": mesh.describe()}
try:  # a graph cannot hold gloo's collectives
    train(cfg.replace_at("experiment.id", "gloo_graph"), max_iters=1,
          device="cuda:0", step_mode="graph", verbose=False)
    res["graph"] = None
except ValueError as e:
    res["graph"] = str(e)


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def counted(fn):
    before = dict(LAUNCHES)
    fn()
    sync()
    return {k: LAUNCHES[k] - before[k] for k in before
            if LAUNCHES[k] != before[k]}


# The loop, host sampling: the global batches of the seeded generator.
res["loop"] = counted(lambda: train(
    cfg.replace_at("experiment.id", "gloo_loop"), max_iters=iters,
    device="cuda:0", verbose=mesh.primary))
batches = np.load(f"{root}/gloo_batches.npy")
mine = pdist.process_ray_slice(batches.shape[1])
dev = mesh.device
for fault in (False, True):
    mesh.global_dp_count = not fault
    pipe = NerfPipeline(cfg, dev, seed=0, mesh=mesh)
    state = TrainState(cfg, pipe)
    losses = []

    grads = []

    def run():
        for b in batches:
            rows = torch.from_numpy(np.ascontiguousarray(b[mine])).to(dev)
            batch = {"origins": rows[:, 0:3], "directions": rows[:, 3:6],
                     "radii": rows[:, 6:7], "rgb": rows[:, 7:10]}
            losses.append(train_step(cfg, pipe, state, batch)["loss"])
            if not grads:
                grads.extend(p.grad.detach().cpu() for p in
                             pipe.parameters())

    sync()
    t0 = time.perf_counter()
    launched = counted(run)
    res[f"steps_{fault}"] = {
        "launches": launched,
        "ms": (time.perf_counter() - t0) * 1e3 / len(batches),
        "losses": torch.stack(losses).tolist()}
    if mesh.primary:
        torch.save({"params": [p.detach().cpu() for p in pipe.parameters()],
                    "grads": grads}, f"{root}/gloo_params_{fault}.pt")
import sys as _sys
res["forbidden"] = sorted(m for m in _sys.modules if m.split(".")[0] in
                          {FORBIDDEN!r})
with open(f"{root}/gloo_rank{mesh.rank}.json", "w") as f:
    json.dump(res, f)
pmesh.destroy_group()
'''


def phase_gloo_two_ranks(torch, logroot, tag="gloo-2"):
    """Two ranks sharing card 0 under gloo (the eager step): the training
    loop with host sampling, and GLOO_ITERS steps on batches whose halves
    hold different numbers of empty rays, each against one process on the
    same global batches; the same steps without the dp loss's count
    all-reduce must fail the gate; a captured step under gloo must be
    refused.  Returns both ranks' launch counts summed, and ms/step."""
    from ddnerf_tpu_torch.config import load_config
    from ddnerf_tpu_torch.data.assembly import get_datasets
    from ddnerf_tpu_torch.models.nerf import NerfPipeline
    from ddnerf_tpu_torch.train.loop import train
    from ddnerf_tpu_torch.train.state import TrainState
    from ddnerf_tpu_torch.train.step import train_step

    opts = GLOO_OPTS + ["parallel.max_store_gb", "0",
                        "experiment.print_every", "10"]
    cfg = load_config(CONFIG).merge_from_list(
        opts + ["experiment.logdir", logroot]).resolved()
    train_ds, _, cfg = get_datasets(cfg)
    rng = np.random.default_rng(7)
    half = TRAIN_RAYS // 2
    batches = []
    for _ in range(GLOO_ITERS):
        b = np.concatenate(train_ds.sample_batch(rng, TRAIN_RAYS), axis=-1)
        b[:EMPTY_RAYS[0], 3:6] *= 1e-12
        b[half:half + EMPTY_RAYS[1], 3:6] *= 1e-12
        batches.append(b)
    np.save(os.path.join(logroot, "gloo_batches.npy"), np.stack(batches))
    script = os.path.join(logroot, "gloo_ranks.py")
    with open(script, "w") as f:
        f.write(_GLOO_PROGRAM.replace("{FORBIDDEN!r}",
                                      repr(set(FORBIDDEN_MODULES))))
    out, _, wall = _subprocess(
        TORCHRUN + ["--nproc_per_node", "2", script, CONFIG, logroot,
                    str(GLOO_ITERS), json.dumps(opts)], tag, timeout=600)
    ranks = []
    for r in range(2):
        with open(os.path.join(logroot, f"gloo_rank{r}.json")) as f:
            ranks.append(json.load(f))
    if not ranks[0]["describe"].startswith(
            "2 ranks, backend gloo, cuda:0 shared"):
        fail(f"{tag}: the group is {ranks[0]['describe']!r}")
    for r, res in enumerate(ranks):
        if not (res["graph"] and "gloo" in res["graph"]):
            fail(f"{tag}: rank {r}: step_mode='graph' under gloo was not "
                 f"refused ({res['graph']!r})")
        if res["forbidden"]:
            fail(f"{tag}: rank {r} imported {res['forbidden']}")
        want = {"fused_mlp_fwd_stash": 2 * GLOO_ITERS,
                "fused_mlp_bwd": 2 * GLOO_ITERS}
        for what in ("steps_False", "steps_True"):
            if res[what]["launches"] != want:
                fail(f"{tag}: rank {r} launched {res[what]['launches']} in "
                     f"{GLOO_ITERS} steps ({what}), expected {want}")
        if {k: v for k, v in res["loop"].items()
                if k != "fused_mlp_fwd"} != want:
            fail(f"{tag}: rank {r}'s loop launched {res['loop']}")

    # One process on the same global batches.
    t0 = time.perf_counter()
    train(cfg.replace_at("experiment.id", "gloo_loop_one"),
          max_iters=GLOO_ITERS, device="cuda", verbose=False)
    two, one = (_records(os.path.join(logroot, name)) for name in
                ("gloo_loop", "gloo_loop_one"))
    loop_gap = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(two, one))
    dev = torch.device("cuda")
    pipe = NerfPipeline(cfg, dev, seed=0)
    start = [p.detach().clone() for p in pipe.parameters()]
    state = TrainState(cfg, pipe)
    losses, one_grads = [], None
    for b in batches:
        rows = torch.from_numpy(b).to(dev)
        losses.append(train_step(cfg, pipe, state, {
            "origins": rows[:, 0:3], "directions": rows[:, 3:6],
            "radii": rows[:, 6:7], "rgb": rows[:, 7:10]})["loss"])
        if one_grads is None:
            one_grads = [p.grad.detach().clone() for p in pipe.parameters()]
    losses = torch.stack(losses).tolist()
    one_params = [p.detach() for p in pipe.parameters()]
    names = [f"{net}.{n}" for net, m in (("coarse", pipe.coarse),
                                         ("fine", pipe.fine))
             if m is not None for n, _ in m.named_parameters()]

    def largest(gaps):
        return " ".join(f"{n}={gaps[n]:.1e}"
                        for n in sorted(gaps, key=gaps.get)[-4:])

    readings = {}
    for fault in (False, True):
        got = ranks[0][f"steps_{fault}"]["losses"]
        gap = max(abs(a - b) / abs(b) for a, b in zip(got, losses))
        saved = torch.load(os.path.join(logroot, f"gloo_params_{fault}.pt"))
        grad = {n: float((g.to(dev) - h).norm() / h.norm())
                for n, g, h in zip(names, saved["grads"], one_grads)
                if h.norm() > 0}
        leaf = {n: float((p.to(dev) - q).norm() / (q - p0).norm())
                for n, p, q, p0 in zip(names, saved["params"], one_params,
                                       start) if (q - p0).norm() > 0}
        readings[fault] = (gap, max(grad.values()), max(leaf.values()))
        print(f"[{tag}] {'fault: no count all-reduce' if fault else 'the step'}"
              f": largest loss gap {gap:.3e} (gate {GLOO_LOSS_GAP_TOL:g}); "
              f"first step's gradient, largest leaf gap "
              f"{readings[fault][1]:.3e} (gate {GLOO_GRAD_GAP_TOL:g}): "
              f"{largest(grad)}; parameters after {GLOO_ITERS} steps, "
              f"largest leaf gap {readings[fault][2]:.3e} (gate "
              f"{GLOO_LEAF_GAP_TOL:g}): {largest(leaf)}", flush=True)
    ms = ranks[0]["steps_False"]["ms"]
    print(f"[{tag}] loop with host sampling, 2 ranks vs 1: largest loss gap "
          f"{loop_gap:.3e} over {len(two)} iterations; the step on 2 ranks "
          f"{ms:.2f} ms (rank 0's clock over {GLOO_ITERS} synchronized "
          f"steps, the first included), empty rays {EMPTY_RAYS}; "
          f"one-process run {time.perf_counter() - t0:.1f} s; wall "
          f"{wall:.1f} s", flush=True)
    tols = (GLOO_LOSS_GAP_TOL, GLOO_GRAD_GAP_TOL, GLOO_LEAF_GAP_TOL)
    ok = readings[False]
    if not (len(two) == GLOO_ITERS and loop_gap <= GLOO_LOSS_GAP_TOL
            and all(r <= t for r, t in zip(ok, tols))):
        fail(f"{tag}: two ranks disagree with one process: loop gap "
             f"{loop_gap:.3e}, step {ok}")
    if all(r <= t for r, t in zip(readings[True], tols)):
        fail(f"{tag}: the gates do not see the dropped count all-reduce "
             f"{readings[True]}")
    total = _sum_launches(*(r[k] for r in ranks
                            for k in ("loop",)),
                          *(r[k]["launches"] for r in ranks
                            for k in ("steps_False",)))
    return total, ms


_RENDER_PROGRAM = r'''
"""Phase 13 of chip_smoke.py, on each of two ranks sharing card 0."""
import contextlib, io, json, sys
import torch
from ddnerf_tpu_torch.eval.evaluate import eval_model
from ddnerf_tpu_torch.kernels.fused_mlp import LAUNCHES
from ddnerf_tpu_torch.parallel import mesh as pmesh
from ddnerf_tpu_torch.render.video import render_model_video

root = sys.argv[1]
jobs = json.loads(sys.argv[2])
mesh = pmesh.init_group("cuda:0")
res = {"launches": {}, "printed": {}}
for name, kind, kwargs in jobs:
    before = dict(LAUNCHES)
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        fn = eval_model if kind == "eval" else render_model_video
        fn(device="cuda:0", **kwargs)
    res["launches"][name] = {k: LAUNCHES[k] - before[k] for k in before}
    res["printed"][name] = said.getvalue()
res["forbidden"] = sorted(m for m in sys.modules if m.split(".")[0] in
                          {FORBIDDEN!r})
with open(f"{root}/render_rank{mesh.rank}.json", "w") as f:
    json.dump(res, f)
pmesh.destroy_group()
'''


def _sibling(src, dst, ckpt):
    """A logdir of ``src``'s config snapshot and checkpoint file ``ckpt``."""
    os.makedirs(dst)
    for name in ("config.yml", ckpt):
        os.symlink(os.path.realpath(os.path.join(src, name)),
                   os.path.join(dst, name))
    return dst


def _write_lpips_weights(path):
    """A seeded ``.npz`` of AlexNet-LPIPS weights in the schema
    ``scripts/convert_lpips_weights.py`` writes."""
    rng = np.random.default_rng(0)
    w = {}
    for i, shape in enumerate(LPIPS_SHAPES):
        fan_in = shape[1] * shape[2] * shape[3]
        w[f"conv{i}_w"] = (rng.standard_normal(shape)
                           * math.sqrt(2.0 / fan_in)).astype(np.float32)
        w[f"conv{i}_b"] = (0.01 * rng.standard_normal(shape[0])
                           ).astype(np.float32)
        w[f"lin{i}_w"] = rng.random(shape[0]).astype(np.float32)
    np.savez(path, **w)


def phase_render_two_ranks(logroot, logdir, mip_logdir, ndc_logdir,
                           tag="render-2"):
    """Eval (with LPIPS) and video frames on two ranks sharing card 0:
    each rank renders its share of every chunk, rank 0 writes.  Every
    artifact must equal what one process wrote in phases 6b, 9 and 10
    bitwise: results.txt (but for the timings and the LPIPS lines, which
    one process did not write), the decoded image dumps, the frames of
    both forward kernels and an NDC frame.  Returns both ranks' launch
    counts summed, and the LPIPS weights' path."""
    from ddnerf_tpu_torch.render.media import read_avi, read_png

    weights = os.path.join(logroot, "lpips_alex.npz")
    _write_lpips_weights(weights)
    ckpt = f"checkpoint_{TRAIN_ITERS}.ckpt"
    dirs = {
        "eval": _sibling(mip_logdir, os.path.join(logroot, "two_eval"), ckpt),
        "mlp": _sibling(logdir, os.path.join(logroot, "two_mlp"), ckpt),
        "ipe2": _sibling(logdir + "_ipe2", os.path.join(logroot, "two_ipe2"),
                         ckpt),
        "ndc": _sibling(ndc_logdir, os.path.join(logroot, "two_ndc"),
                        f"checkpoint_{NDC_ITERS[1]}.ckpt"),
    }
    frames = 2
    jobs = [("eval", "eval", {"basedir": dirs["eval"], "max_images": 2,
                              "save_images": True, "lpips_weights": weights}),
            ("mlp", "video", {"basedir": dirs["mlp"], "max_frames": frames,
                              "save_images": True}),
            ("ipe2", "video", {"basedir": dirs["ipe2"], "max_frames": frames}),
            ("ndc", "video", {"basedir": dirs["ndc"], "max_frames": 1,
                              "checkpoint_step": NDC_ITERS[1]})]
    script = os.path.join(logroot, "render_ranks.py")
    with open(script, "w") as f:
        f.write(_RENDER_PROGRAM.replace("{FORBIDDEN!r}",
                                        repr(set(FORBIDDEN_MODULES))))
    _, _, wall = _subprocess(TORCHRUN + ["--nproc_per_node", "2", script,
                                         logroot, json.dumps(jobs)], tag,
                             timeout=600)
    ranks = []
    for r in range(2):
        with open(os.path.join(logroot, f"render_rank{r}.json")) as f:
            ranks.append(json.load(f))
    differ = []
    for r, res in enumerate(ranks):
        if res["forbidden"]:
            fail(f"{tag}: rank {r} imported {res['forbidden']}")
        if r and any(res["printed"].values()):
            fail(f"{tag}: rank {r} printed {res['printed']}")

    def results(path, skip=("model_time", "lpips")):
        with open(os.path.join(path, "validation", "results.txt")) as f:
            return [ln for ln in f if not any(k in ln for k in skip)]

    if results(dirs["eval"]) != results(mip_logdir):
        differ.append("results.txt")
    with open(os.path.join(dirs["eval"], "validation", "results.txt")) as f:
        lpips = re.findall(r"^(?:image \d+ , )?(lpips_(?:coarse|fine)):"
                           r"\s*(\S+)$", f.read(), re.M)
    if len(lpips) != 2 * 3 or not all(math.isfinite(float(v))
                                      for _, v in lpips):
        fail(f"{tag}: results.txt holds the LPIPS lines {lpips}")
    pngs = 0
    for i in ("0", "1"):
        names = sorted(os.listdir(os.path.join(mip_logdir, "validation", i)))
        if sorted(os.listdir(os.path.join(dirs["eval"], "validation",
                                          i))) != names:
            differ.append(f"validation/{i} files")
        for name in names:
            pngs += 1
            if not np.array_equal(
                    read_png(os.path.join(dirs["eval"], "validation", i,
                                          name)),
                    read_png(os.path.join(mip_logdir, "validation", i,
                                          name))):
                differ.append(f"validation/{i}/{name}")
    for name, one, n in (("mlp", logdir, frames),
                         ("ipe2", logdir + "_ipe2", frames),
                         ("ndc", ndc_logdir, 1)):
        got, _ = read_avi(os.path.join(dirs[name], "video", "video.avi"))
        want, _ = read_avi(os.path.join(one, "video", "video.avi"))
        if got.shape[0] != n or not np.array_equal(got, want[:n]):
            differ.append(f"{name} frames")
    for i in range(frames):
        png = read_png(os.path.join(dirs["mlp"], "video",
                                    f"frame_{i:04d}.png"))
        if not np.array_equal(png, read_png(os.path.join(
                logdir, "video", f"frame_{i:04d}.png"))):
            differ.append(f"frame_{i:04d}.png")
    launches = [res["launches"] for res in ranks]
    nonzero = [{job: {k: v for k, v in c.items() if v}
                for job, c in per.items()} for per in launches]
    print(f"[{tag}] two ranks vs one process: results.txt, {pngs} image "
          f"dumps, {frames} frames of each forward kernel and an NDC frame "
          f"{'bitwise equal' if not differ else differ}; LPIPS lines "
          f"{lpips}; launches per rank {nonzero}; wall {wall:.1f} s",
          flush=True)
    if differ:
        fail(f"{tag}: two ranks rendered other artifacts than one process: "
             f"{differ}")
    # Each rank renders its half of every chunk: as many launches as one
    # process, two per chunk (two networks, or the shared one twice).
    from ddnerf_tpu_torch.config import Config

    def chunks(path, hw):
        size = Config.from_yaml(os.path.join(path, "config.yml")
                                ).nerf.validation.chunksize
        return -(-hw[0] * hw[1] // size)

    c_mlp, c_mip = chunks(logdir, VIDEO_HW), chunks(mip_logdir, VIDEO_HW)
    c_ndc = chunks(ndc_logdir, NDC_HW)
    want = {"eval": {"fused_mlp_fwd": 2 * c_mip * 2},
            "mlp": {"fused_mlp_fwd": 2 * c_mlp * frames},
            "ipe2": {"fused_enc_mlp_fwd": 2 * c_mlp * frames},
            "ndc": {"fused_mlp_fwd": 2 * c_ndc}}
    for r, got in enumerate(nonzero):
        if got != want:
            fail(f"{tag}: rank {r} launched {got}, expected {want}")
    return _sum_launches(*(c for per in launches for c in per.values())), \
        weights, dirs["eval"]


def phase_lpips_on_card(torch, weights, eval_dir, tag="lpips"):
    """LPIPS of two rendered images (the fine rgb and the ground truth that
    phase 13 wrote) on the card, with cuDNN's TF32 off for the metric,
    against the CPU's value."""
    from ddnerf_tpu_torch.eval.metrics import Lpips
    from ddnerf_tpu_torch.render.media import read_png

    folder = os.path.join(eval_dir, "validation", "0")
    image = read_png(os.path.join(folder, "rgb_fine.png")) / 255.0
    target = read_png(os.path.join(folder, "gt.png")) / 255.0
    values = {dev: Lpips(weights, dev)(image[..., :3], target[..., :3])
              for dev in ("cuda", "cpu")}
    gap = abs(values["cuda"] - values["cpu"])
    print(f"[{tag}] {image.shape[:2]} images: card {values['cuda']:.7f}, "
          f"CPU {values['cpu']:.7f}, gap {gap:.2e} (gate {LPIPS_TOL:g}); "
          f"cudnn.allow_tf32 is {torch.backends.cudnn.allow_tf32} outside "
          f"the metric", flush=True)
    if not (math.isfinite(values["cuda"]) and values["cuda"] > 0
            and gap <= LPIPS_TOL):
        fail(f"{tag}: the card's LPIPS {values['cuda']} disagrees with the "
             f"CPU's {values['cpu']}")


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
    enc_err, enc_timing = phase_enc_kernel(torch)
    train_err, train_timing = phase_train_kernels(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as logroot:
        logdir, train_launches = phase_train_main_path(logroot)
        host_launches = phase_host_sampling(logroot)
        profile_launches = phase_profile_steps(logroot)
        launches = phase_main_path(logdir)
        video_launches = phase_video_main_path(logdir)
        # The mip-NeRF path: the same three entry points on one shared net.
        mip_logdir, mip_train = phase_train_main_path(
            logroot, "mip-train", MIPNERF, run="mipnerf_smoke")
        mip_eval = phase_main_path(mip_logdir, "mip-eval", ("--save_images",))
        _decoded_pngs(os.path.join(mip_logdir, "validation", "1"), [
            "rgb_coarse.png", "rgb_fine.png", "coarse.png", "fine.png",
            "depth_coarse.png", "depth_fine.png", "gt.png"])
        with open(os.path.join(mip_logdir, "config.yml")) as f:
            chunksize = int(re.search(r"validation:.*?chunksize: (\d+)",
                                      f.read(), re.S).group(1))
        chunks = -(-VIDEO_HW[0] * VIDEO_HW[1] // chunksize)
        if mip_eval != {"fused_mlp_fwd": 2 * chunks * 2,
                        "fused_mlp_fwd_stash": 0, "fused_mlp_bwd": 0,
                        "fused_enc_mlp_fwd": 0}:
            fail(f"mip-NeRF eval launched {mip_eval}, expected "
                 f"{2 * chunks * 2} of fused_mlp_fwd only")
        mip_video = phase_video_main_path(mip_logdir, "mip-video")
        ndc_launches, ndc_scene = phase_ndc_main_path(logroot)
        # The training kernels against plain on that path's own batches.
        ndc_step_ms = phase_train_parity(torch, "ndc-parity", ndc_scene,
                                         FF_CONFIG)
        phase_step_gradients(torch, "ndc-grads", ndc_scene, FF_CONFIG)
        real360_launches = phase_real360_main_path(logroot)
        _close_cli_worker()
        rehearsal_launches = {tag: phase_rehearsal(logroot, tag)
                              for tag in REHEARSALS}
        # Data parallelism: torchrun launches on this one card.
        nccl_launches, nccl_ms = phase_nccl_one_rank(logroot, logdir)
        render_launches, lpips_weights, eval_dir = phase_render_two_ranks(
            logroot, logdir, mip_logdir, os.path.join(logroot, "ndc_smoke"))
        phase_lpips_on_card(torch, lpips_weights, eval_dir)
        gloo_launches, gloo_ms = phase_gloo_two_ranks(torch, logroot)
    graph_ms = phase_graph_vs_eager(torch)
    mip_graph_ms = phase_graph_vs_eager(torch, "mip-graph", MIPNERF)
    step_ms = phase_train_parity(torch)
    frame_s = phase_frame(torch)
    mip_step_ms = phase_train_parity(torch, "mip-parity", MIPNERF)
    phase_step_gradients(torch, "mip-grads", MIPNERF)
    mip_frame_s = phase_frame(torch, "mip-frame", MIPNERF)
    print(f"[frame] 800x800 best of two: kernel (B1) {frame_s['kernel']:.3f} "
          f"s, ipe2 (B3) {frame_s['ipe2']:.3f} s, plain "
          f"{frame_s['plain']:.3f} s; train step kernel "
          f"{step_ms['kernel']:.2f} ms, plain {step_ms['plain']:.2f} ms")
    print(f"[mip-frame] 800x800 best of two: kernel (B1) "
          f"{mip_frame_s['kernel']:.3f} s, ipe2 (B3) "
          f"{mip_frame_s['ipe2']:.3f} s, plain {mip_frame_s['plain']:.3f} s; "
          f"mip-NeRF train step kernel {mip_step_ms['kernel']:.2f} ms, plain "
          f"{mip_step_ms['plain']:.2f} ms; NDC train step kernel "
          f"{ndc_step_ms['kernel']:.2f} ms, plain "
          f"{ndc_step_ms['plain']:.2f} ms; captured vs eager step "
          f"{graph_ms['graph']:.2f} vs {graph_ms['eager']:.2f} ms (DDNeRF), "
          f"{mip_graph_ms['graph']:.2f} vs {mip_graph_ms['eager']:.2f} ms "
          f"(mip-NeRF); torchrun one rank on NCCL {nccl_ms['nccl']:.2f} vs "
          f"one process {nccl_ms['single']:.2f} ms/step, two ranks on one "
          f"card under gloo {gloo_ms:.2f} ms/step; whole run "
          f"{time.perf_counter() - t_start:.1f} s")
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in FORBIDDEN_MODULES)
    if leaked:
        fail(f"imported {leaked}")
    print(f"[modules] {IMPORTS_SEEN['processes']} Python processes started "
          f"(every rank included) imported "
          f"{sorted(IMPORTS_SEEN['leaked']) or 'nothing forbidden'}")
    if IMPORTS_SEEN["leaked"] or not IMPORTS_SEEN["processes"]:
        fail(f"a subprocess imported {sorted(IMPORTS_SEEN['leaked'])}")

    # Each kernel's launches: the sum over the main paths, and per path.
    by_path = {"ddnerf": _sum_launches(train_launches, host_launches,
                                       profile_launches, launches,
                                       video_launches),
               "mipnerf": _sum_launches(mip_train, mip_eval, mip_video),
               "ndc": ndc_launches,
               "parallel": _sum_launches(nccl_launches, gloo_launches,
                                         render_launches),
               "real360": real360_launches, **rehearsal_launches}
    total = _sum_launches(*by_path.values())
    print("[launches] per main path: " + json.dumps(by_path, sort_keys=True))
    for path, counts in by_path.items():
        # The NDC path and the rehearsals film through B1 alone (their
        # configs' variant).
        b1_only = path == "ndc" or path in REHEARSALS
        expected = [k for k in total if not (b1_only
                                             and k == "fused_enc_mlp_fwd")]
        idle = [k for k in expected if counts.get(k, 0) <= 0]
        if idle:
            fail(f"the {path} main path never launched {idle}")

    from ddnerf_tpu_torch.models.mlp import DepthMipMLP

    ms, plain_ms = timing["DepthMipMLP"]
    coarse = train_timing["DepthMipMLP"]
    enc = enc_timing["DepthMipMLP"]
    bounds = kernel_bounds(
        DepthMipMLP(hidden_size=256, compute_dtype=torch.bfloat16),
        CHUNK_RAYS * SAMPLES, CHUNK_RAYS, TRAIN_RAYS * SAMPLES, TRAIN_RAYS)
    fwd_cu = "ddnerf_tpu_torch/kernels/csrc/fused_mlp_fwd.cu"
    # name, source, the TPU kernel, main-path launches, error, ms, plain ms
    rows = [
        ("fused_mlp_fwd", fwd_cu, "ddnerf_tpu/kernels/fused_mlp.py:464",
         total["fused_mlp_fwd"], max_err, ms, plain_ms),
        ("fused_mlp_fwd_stash", fwd_cu, "ddnerf_tpu/kernels/fused_mlp.py:464",
         total["fused_mlp_fwd_stash"],
         train_err["fused_mlp_fwd_stash"], coarse["fwd_stash"],
         coarse["plain_fwd"]),
        ("fused_mlp_bwd", "ddnerf_tpu_torch/kernels/csrc/fused_mlp_bwd.cu",
         "ddnerf_tpu/kernels/fused_mlp_bwd.py:299",
         total["fused_mlp_bwd"], train_err["fused_mlp_bwd"],
         coarse["bwd"], coarse["plain_bwd"]),
        ("fused_enc_mlp_fwd", fwd_cu, "ddnerf_tpu/kernels/fused_mlp.py:309",
         total["fused_enc_mlp_fwd"], enc_err, enc["enc"],
         enc["plain"]),
    ]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": count, "max_abs_err": err, "ms": t, "plain_ms": plain_t,
        "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        # No single PyTorch call computes a fused 11-layer MLP (or its
        # backward), so there is no library time to put beside these.
        "library_ms": None,
    } for name, source, replaces, count, err, t, plain_t in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
