"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the repository root.  Phases, each of which fails the run:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the CUDA kernels from ``ddnerf_tpu_torch/kernels/csrc``
   and print ptxas' registers, spill bytes and advisories for each: at
   every width from 128 up (128, 192, 256, 384, 512) and in the small
   kernels there must be no spill and no advisory;
3. forward kernel vs plain: the fused MLP forward (render mode) against
   its plain PyTorch version for DepthMipMLP and MipMLP at width 256 on one
   production chunk (16384 rays x 32 samples) and on ragged shapes, with
   CUDA-event timings;
3b. in-kernel-IPE forward vs plain: the forward that computes the IPE
   itself from raw means and covariances, against its plain version at the
   same shapes and bit for bit against the forward fed the torch
   direct-form IPE, with CUDA-event timings of it, its plain version and
   the forward plus the torch IPE assembly;
3c. the library yardstick of the fused plans' four kernels in both dtypes
   at width 256 on the main paths' shapes: one PyTorch matrix product per
   product of the network (:func:`library_ms`), summed per kernel;
3d. the encode kernel vs plain: ``kernels.encode.ipe_encode`` against its
   plain version (``ipe_encode_reference``) on the same card tensors at the
   main path's shapes, one render chunk (16384 rays x 32 sections) and
   one training cycle (2048 x 32), as the main path runs it (cone, double
   angle, bf16 rows): at least :data:`ENCODE_EQUAL_SHARE` of the IPE and
   dirs elements equal and every one within 1 bf16 ulp, with CUDA-event
   timings of both in graph replays;
4. training kernels vs plain: the stash forward (outputs bit-identical to
   render mode, activation slabs within the forward tolerances) and the
   fused backward (every gradient within its norm-relative tolerance and
   every stage within its limits, :func:`b2_stage_readings`, bitwise
   repeatable) against their plain versions at the training shape
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
   plain versions at this path's shapes and cotangents too; then mip-NeRF
   under NDC on the same scene (``configs/ff_mipnerf.yml``): trained by
   the CLI under the captured step (B1s and B2 twice an iteration on the
   one net), one image evaluated, a video frame through B1 and one
   through B3, and an NDC mip-NeRF frame of seeded weights through both
   forward kernels against the plain version by PSNR;
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
   each CLI's wall are printed;
17. network widths: B1, B3, B1s and B2 at widths 96 and 320 (run
   zero-padded at 128 and 384), 192 and 512 (the N-split plan), both heads,
   on a ragged row count, against their plain versions under the gates of
   phases 3, 3b and 4 (B2 in both ``kernel_per_ray_dirs`` settings, stage
   by stage at every width, its end result on the random data against the
   plain version at 96, 192 and 320 and against the plain version
   accumulating in float64 at 512, see :data:`B2_FLOAT64_WIDTHS`, and on
   exact-integer data at every width), and each width's kernel times
   beside their bounds; then the smoke config
   with ``nerf.coarse_hidden_size 192 nerf.fine_hidden_size 512``: 100
   iterations of the training CLI under the captured step (2 B1s + 2 B2 per
   iteration), eval of one image, one video frame through B1 and one
   through B3, that run's eval image and video frame through B1 and B3
   against the plain version by PSNR, 20 captured iterations against 20
   eager ones bit for bit, and 20 steps kernel vs plain;
18. float32 compute (:func:`phase_f32_kernels` and the float32 CLI path);
19. widths above 512 and the microbatched step: (a) the wide plan's B1,
   B3, B1s and B2 (``csrc/fused_mlp_wide.cu``, counted ``wide_*``) at 600,
   768 and 1024 in bf16 and float32 against their plain versions under
   the gates of phases 17 and 18 on a ragged row count and, at 1024, on
   the main paths' shapes, each bitwise repeatable, the float32 chain's
   transposed TF32 planes bit for bit the plain split, two faults at 1024
   outside B2's stage limits, three outside the float32 limits, the times
   at 1024 beside the bounds and the library yardstick (one PyTorch matrix
   product per GEMM of the wide plan);
   (b) a coarse-600 / fine-1024 run through the three CLIs in both dtypes,
   its frames against the plain version, 20 captured iterations against 20
   eager ones and 20 steps kernel vs plain, and the same at bf16 for a
   coarse-256 / fine-1024 pair, whose one step runs both plans' kernels;
   (c) 8192 rays a step in 4 microbatches of 2048,
   captured against eager bit for bit (8 B1s + 8 B2 a step) in both
   dtypes, its peak device memory below the monolithic 8192-ray step's;
20. quality at other widths, kernel against plain: phase 16's blender
   rehearsal (its scene, 3,000 iterations on the config's schedule, the
   captured step) with the kernels and with ``--plain`` (``pallas_mlp:
   off``, no kernel may launch) at coarse-192 / fine-512, and with the
   kernels at coarse-600 / fine-1024 (the wide plan): every run must
   reach the blender gate, each kernel run launch
   B1s and B2 2 x iterations under its networks' plans, and each kernel
   run read ``psnr_fine`` within 0.5 dB of the plain run at its widths
   (at 256 / 256 and 600 / 1024 the plain runs' recorded readings,
   :data:`PLAIN_PSNR_RECORDED`);
21. quality where no card run held it, kernel against plain: the
   rehearsal with ``--f32`` (blender, the fused float32 kernels, gate
   19.0), ``--llff --mipnerf`` (``configs/ff_mipnerf.yml``) and
   ``--real360`` (``configs/real360_dd.yml`` on a ring scene), one after
   another, each at its gate, launching B1s and B2 2 x iterations, and
   within 0.5 dB of its plain run's recorded reading
   (:data:`QUALITY_REHEARSALS`).

The second-to-last line is the kernel table as JSON (each kernel's time
beside its plain version's and beside ``bound_ms``, the least time the card
could take for the same work, see :func:`_bound_ms`, and ``library_ms``,
the time of one PyTorch matrix product per product of the network,
:func:`library_ms`, null for the encode kernel, whose work is no matrix
product); the last line is
``{"ok": true, "device": {...}}``.  A kernel's ``launches`` there is the
sum over the main paths of phases 5, 5c, 5d, 6, 6b, 9, 10, 11, 12, 13, 15,
16, 17, 18, 19, 20 and 21's kernel runs (over every rank), each counted
from 0; on every path ``chain_mask_bits`` (the B2 launches whose chain read
B1s's relu-mask words) must equal ``fused_mlp_bwd`` (the bf16 fused plan's
B2; the float32 and wide plans count neither).  The
single-process CLI runs of phases 5-10, 15 and 17-19 are calls of each
CLI's ``main`` in one worker
process, one after another, every count set to 0 before each call; the
rehearsals and the torchrun launches are processes of their own.  Every
Python process a phase starts, every rank included, lists its imports, and
none may import JAX, the JAX package, imageio or matplotlib.  Without CUDA, or
without the package beside this file, the run exits non-zero and prints no
result.
"""

from __future__ import annotations

import atexit
import contextlib
import glob
import importlib.util
import json
import math
import os
import pickle
import re
import select
import signal
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
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
# Operations at float32 precision: 3xTF32 on the tensor cores, a third of
# the dense TF32 peak (495e12), the least time f32 products could take.
PEAK_F32_FLOPS = 495e12 / 3
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
# B2 stage by stage (:func:`b2_stage_readings`: each stage against float64
# fed the kernel's own cotangents, so that no flip carries down the chain).
# Readings on phase 17's data, five seeds per width
# (scripts/b2_rounding_floor.py; NVIDIA H100 80GB HBM3, 700 W): flip_share
# <= 4.2e-5 / 7.1e-5 / 1.02e-4 / 1.30e-4 at widths 128 / 256 / 384 / 512
# (the share of bf16 tensor-core products through cuBLAS, to the digit;
# float32 FMA sums read 2.1e-5 .. 4.2e-5), g_h <= 1.1e-8, weights <= 2.8e-6,
# biases <= 4.7e-7, dirs <= 1.1e-7.  Faults injected at 256 and 512:
# cotangents rounded toward zero read flip_share 0.4995; biases summed after
# the rounding, biases >= 1.74e-3; weight gradients rounded to bf16, weights
# >= 1.67e-3; the last split of every weight gradient dropped, weights >=
# 0.35; the per-sample dirs cotangent summed unrounded, dirs >= 1.80e-3.
B2_STAGE_LIMITS = {"entry": 0, "flip_share": 1e-3, "far": 0, "g_h": 1e-6,
                   "weights": 1e-4, "biases": 1e-4, "dirs": 1e-4}
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
# mip-NeRF under NDC (configs/ff_mipnerf.yml) on the same scene: training
# iterations, then eval of one image and one video frame through B1 and
# one through B3.
FF_MIP_CONFIG = os.path.join(REPO, "configs", "ff_mipnerf.yml")
NDC_MIP_ITERS = 30
# Phase 17, the network widths: kernels at widths no kernel was built for
# (96 runs at 128, 320 at 384, zero-padded) and at the new plans (192; 512,
# the N-split plan), and the smoke config with a coarse-192 / fine-512 pair:
# its captured vs eager and kernel vs plain steps run the config's schedule,
# as the other paths' do; its 100-iteration CLI run starts at the full rate
# (no lr delay), so that its loss must fall.  At the full rate from step 0
# no PARITY_GAP_TOL separates kernels from trajectories: over 20 steps
# kernel vs plain reads 8.97e-4 at 192 / 512 (3.15e-5 at 256 / 256), and
# the plain backward accumulating in float32 vs in float64, the kernel
# forward under both, alone reads 1.08e-3 (4.66e-5)
# (scripts/parity_full_rate.py).
WIDTHS = (96, 192, 320, 512)
# At 512 B2's trunk leaves read 1.30-1.37e-3 against the plain version
# (five seeds, scripts/b2_rounding_floor.py), over GRAD_NORM_REL_TOL_TRUNK:
# its bf16 cotangents are those of tensor-core products (float32
# accumulation that drifts from float64 about linearly in K, where float32
# FMA sums drift about as sqrt(K)), and a flip carries down the chain; the
# plain version sits 8.5-9.2e-4 from float64 accumulation.  So at 512 the
# end result is held against the plain version with float64 accumulation:
# the trunk to B2_FLOAT64_TRUNK_TOL (sound 1.29-1.33e-3; the faults that
# move it least, biases summed after the rounding and weight gradients
# rounded to bf16, read 1.96e-3 and 2.13e-3), the rest to
# GRAD_NORM_REL_TOL_HEADS (sound <= 3.1e-5, faults >= 1.71e-3); and every
# stage to B2_STAGE_LIMITS, as at every width.  On exact-integer data
# (:func:`_exact_case`) B2 is held at every width to EXACT_GRAD_TOL.
B2_FLOAT64_WIDTHS = (512,)
B2_FLOAT64_TRUNK_TOL = 1.6e-3
EXACT_GRAD_TOL = 1e-6
WIDE_OPTS = ("nerf.coarse_hidden_size", "192", "nerf.fine_hidden_size", "512")
WIDE_TRAIN_OPTS = (*WIDE_OPTS, "optimizer.lr_delay_steps", "0")
WIDE_ITERS, WIDE_GRAPH_STEPS = 100, 20
# Modules that must not have been imported when the run ends: the JAX
# package and its frameworks, and the libraries not every installation has.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "ddnerf_tpu",
                     "imageio", "matplotlib", "tensorboardX", "tensorboard")


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
        # Widths from 128 up (a kernel's first template argument), the
        # small kernels and every float32 kernel (float_*, tf32_*) must
        # neither spill nor draw an advisory: a wgmma kernel that does runs
        # its products one at a time.  Width 64 of the bf16 forward is known
        # to draw C7520.
        width = re.search(r"<(\d+)", r.name)
        f32 = r.name.startswith(("float_", "tf32_"))
        if (f32 or not width or int(width.group(1)) >= 128) and (
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


DIRS_MACS = 128 * 27  # the dir layer's view-direction columns, per ray


def _row_macs(hidden, depth_head):
    """Multiply-adds per row of one forward of a network of width ``hidden``
    (its own width, not a kernel's padded one): every weight once, except
    the dir layer's view-direction columns (:data:`DIRS_MACS`, once per
    ray): trunk 96 w + 6 w^2 + (96 + w) w, fc_feat w^2, the dir layer
    128 w, alpha w, rgb 3 x 128, mu / sigma 2 x 128 = 8 w^2 + 321 w + 640
    for the depth head (607,104 at 256, 2,262,144 at 512)."""
    return 8 * hidden ** 2 + 321 * hidden + 384 + (256 if depth_head else 0)


def _param_counts(hidden, depth_head):
    """(weights, biases) of a network of width ``hidden``."""
    return (_row_macs(hidden, depth_head) + DIRS_MACS,
            9 * hidden + 128 + 1 + 3 + (2 if depth_head else 0))


def _bound_ms(flop, nbytes, peak=PEAK_BF16_FLOPS):
    """The least time the card could take: the larger of the operations
    over the dense peak of their type (bf16 by default) and the bytes
    (each input read once, each output written once) over the device-memory
    rate -> (ms, which)."""
    t_flop, t_bytes = flop / peak, nbytes / PEAK_HBM_BYTES
    return max(t_flop, t_bytes) * 1e3, ("operations" if t_flop >= t_bytes
                                        else "bytes")


def kernel_bounds(hidden, rows, rays, train_rows, train_rays,
                  depth_head=True, f32=False):
    """``{kernel: (bound_ms, bound_by)}`` for a network of width ``hidden``
    at the shapes that were timed: the forwards B1 / B3 on ``rows``
    (``rays`` rays), the training pair B1s / B2 on ``train_rows``.  The
    work is the network's own width's: a width the kernels run zero-padded
    counts no padded unit.  Forward: 2 FLOP per multiply-add; it reads the
    IPE (96 bf16 per row; B3: means and covs, 6 f32), the dirs (27 bf16
    per ray) and the parameters, and writes out_dim f32 per row; B1s also
    writes the stash, (9 H + 128) bf16 per row.  Backward: the weight
    gradients repeat the forward's multiply-adds, the cotangent chain
    repeats all but those whose input is the IPE or the dirs (layer 0, the
    skip layer's IPE columns, the dir layer's dirs columns); it reads the
    IPE, the dirs, the cotangent (out_dim f32 per row), the stash and the
    weights, and writes one f32 gradient per parameter.  With ``f32``, the
    float32 kernels (``{kernel}_f32``): every IPE, dirs, weight and stash
    element is 4 bytes, and the operations run at f32 precision, whose
    least time is 3xTF32's: :data:`PEAK_F32_FLOPS`."""
    out_dim = 6 if depth_head else 4
    e = 4 if f32 else 2  # bytes of a compute-dtype element
    peak = PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS
    weights, biases = _param_counts(hidden, depth_head)
    params = e * weights + 4 * biases  # weights in the compute dtype
    row_macs = _row_macs(hidden, depth_head)
    out = {}
    fwd = 2 * (rows * row_macs + rays * DIRS_MACS)
    io = rays * 27 * e + params + rows * out_dim * 4
    out["fused_mlp_fwd"] = _bound_ms(fwd, io + rows * 96 * e, peak)
    out["fused_enc_mlp_fwd"] = _bound_ms(fwd, io + rows * 6 * 4, peak)
    macs = train_rows * row_macs + train_rays * DIRS_MACS
    stash = train_rows * (9 * hidden + 128) * e
    io = train_rows * 96 * e + train_rays * 27 * e + params
    out["fused_mlp_fwd_stash"] = _bound_ms(
        2 * macs, io + train_rows * out_dim * 4 + stash, peak)
    no_dgrad = train_rows * 2 * 96 * hidden + train_rays * DIRS_MACS
    out["fused_mlp_bwd"] = _bound_ms(
        2 * (2 * macs - no_dgrad),
        io + train_rows * out_dim * 4 + stash + (weights + biases) * 4, peak)
    return {name + ("_f32" if f32 else ""): v for name, v in out.items()}


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


def phase_fused_library(torch):
    """Phase 3c: the library yardstick of the fused plans' kernels (the
    kernels line's ``library_ms``, :func:`library_ms`) at width 256 on the
    main paths' shapes, bf16 and float32 -> ``{kernel: ms}``."""
    out = {}
    for f32 in (False, True):
        lib = library_ms(torch, 256, f32, "fused")
        print(f"[library] DepthMipMLP H=256 {'float32' if f32 else 'bf16'}: "
              + "; ".join(f"{name} {t:.3f} ms" for name, t in lib.items())
              + f" (one torch.mm per product of the network; B1, B3 on "
              f"{CHUNK_RAYS * SAMPLES} rows, B1s, B2 on "
              f"{TRAIN_RAYS * SAMPLES}; CUDA-event medians of "
              f"{TIMING_REPS})", flush=True)
        out.update(lib)
    return out


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


# The encode kernel against its plain version (phase 3d): the share of
# bf16 elements that must be equal, the rest within 1 ulp (the card tests'
# limits, tests/test_torch_port_encode.py).
ENCODE_EQUAL_SHARE = 0.999


def _encode_rays(torch, gen, n, s, dev):
    """``n`` blender rays of ``s`` sections as the pipeline holds them:
    cameras on a sphere of radius 4 looking in, origins / directions /
    radii as column views of one [n, 10] store row, unit view directions,
    sorted jittered fenceposts in [2, 6]."""
    o = torch.randn(n, 3, generator=gen)
    o = 4.0 * o / o.norm(dim=-1, keepdim=True)
    d = -o / 4.0 + 0.35 * torch.randn(n, 3, generator=gen)
    radii = 4e-4 + 4e-4 * torch.rand(n, 1, generator=gen)
    store = torch.cat([o, d, radii, torch.rand(n, 3, generator=gen)], 1).to(dev)
    directions = store[:, 3:6]
    viewdirs = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    base = torch.linspace(2.0, 6.0, s + 1)
    jitter = (torch.rand(n, s + 1, generator=gen) - 0.5) * 4.0 / s
    t_vals = torch.sort(base + jitter, dim=-1).values.to(dev)
    return t_vals, store[:, 0:3], directions, store[:, 6:7], viewdirs


def _bf16_ulps(torch, a, b):
    """|a - b| in bf16 units in the last place, through the floats'
    order-preserving integer keys (-0 and +0 one apart)."""
    def key(x):
        i = x.contiguous().view(torch.int16).long()
        return torch.where(i < 0, -(i & 0x7FFF) - 1, i)

    return (key(a) - key(b)).abs()


def encode_bound_ms(rays, s):
    """The encode kernel's least time: the bytes it reads (``t_vals``
    [rays, s + 1] and 10 floats a ray, f32) and writes (96 bf16 a row, 27
    a ray) once, over the device-memory rate."""
    nbytes = rays * ((s + 1) * 4 + 10 * 4) + rays * s * 96 * 2 + rays * 27 * 2
    return _bound_ms(0, nbytes)


def _replayed_ms(torch, fn, reps=TIMING_REPS, per=10):
    """Median device time of ``fn`` over ``reps`` replays of a CUDA graph
    that holds ``per`` calls of it, per call (CUDA events).  For work of
    tens of microseconds, whose eager launch the host paces."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # allocations and the library load outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per):
            fn()
    return _event_ms(torch, graph.replay, reps) / per


def phase_encode_kernel(torch):
    """Phase 3d -> ``(max |kernel - plain|, {rows: (ms, plain ms)})``, the
    times of graph replays (:func:`_replayed_ms`): eagerly the event pair
    would time the wrapper's host work, not the kernel."""
    from ddnerf_tpu_torch.kernels.encode import (
        ipe_encode,
        ipe_encode_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    worst, timing = 0.0, {}
    for rays in (CHUNK_RAYS, TRAIN_RAYS):
        args = _encode_rays(torch, gen, rays, SAMPLES, dev)
        got = ipe_encode(*args)
        want = ipe_encode_reference(*args, "cone", True, torch.bfloat16)
        torch.cuda.synchronize()
        for part, g, w in zip(("ipe", "dirs"), got, want):
            tag = f"{part} {rays} rays x {SAMPLES}"
            if g.shape != w.shape or g.dtype != torch.bfloat16:
                fail(f"ipe_encode's {tag}: {tuple(g.shape)} {g.dtype}, "
                     f"expected {tuple(w.shape)} bfloat16")
            ulps = _bf16_ulps(torch, g, w)
            share = (ulps == 0).double().mean().item()
            most = ulps.max().item()
            worst = max(worst, (g.float() - w.float()).abs().max().item())
            ok = (torch.isfinite(g).all().item()
                  and share >= ENCODE_EQUAL_SHARE and most <= 1)
            print(f"[encode] {tag}: equal {share:.6f} (gate "
                  f"{ENCODE_EQUAL_SHARE}), max {most} bf16 ulp (gate 1) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"ipe_encode disagrees with its plain version ({tag})")
        ms = _replayed_ms(torch, lambda: ipe_encode(*args))
        plain = _replayed_ms(torch, lambda: ipe_encode_reference(
            *args, "cone", True, torch.bfloat16))
        bound = encode_bound_ms(rays, SAMPLES)[0]
        print(f"[encode] {rays * SAMPLES} rows: kernel {ms:.4f} ms (bound "
              f"{bound:.4f} ms by bytes), plain {plain:.3f} ms (graph "
              f"replays of 10 calls, CUDA-event medians of {TIMING_REPS})",
              flush=True)
        timing[rays * SAMPLES] = (ms, plain)
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

            worst["fused_mlp_bwd"] = max(
                worst["fused_mlp_bwd"],
                _check_backward(torch, "train-kernel", tag, net, ipe, dirs, g,
                                k, stash))
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


def _check_backward(torch, phase, tag, net, ipe, dirs, g, k, stash,
                    verbose=True, limits=(GRAD_NORM_REL_TOL_TRUNK,
                                          GRAD_NORM_REL_TOL_HEADS),
                    bf16_share=True, accumulate=None):
    """B2 against its plain version in both settings of ``per_ray_dirs``
    (per sample, the default, and per ray), each bitwise repeatable, every
    stage within :data:`B2_STAGE_LIMITS`, every gradient within its
    norm-relative limit (``limits``: trunk, the rest) of the plain version
    (accumulating in ``accumulate``, float32 by default) and, with
    ``bf16_share``, its weight gradients not rounded to bf16; returns the
    largest |kernel - plain|."""
    from ddnerf_tpu_torch.kernels import fused_mlp as fk
    from ddnerf_tpu_torch.kernels import reference as ref

    worst = 0.0
    for per_ray in (False, True):
        mode = f"{tag} {'per-ray' if per_ray else 'per-sample'} dirs"
        grads = fk.fused_mlp_backward(net, ipe, dirs, g, k, stash, per_ray)
        again = fk.fused_mlp_backward(net, ipe, dirs, g, k, stash, per_ray)
        torch.cuda.synchronize()
        if not all(torch.equal(grads[name], again[name]) for name in grads):
            fail(f"fused_mlp_bwd is not bitwise repeatable ({mode})")
        plain = ref.fused_mlp_backward_reference(
            net, ipe, dirs, g, k, stash, per_ray,
            accumulate=accumulate or torch.float32)
        stages, staged = b2_stage_readings(torch, net, ipe, dirs, g, k, stash,
                                           per_ray)
        if not all(torch.equal(grads[name], staged[name]) for name in grads):
            fail(f"fused_mlp_bwd through its C entry point differs from the "
                 f"wrapper's ({mode})")
        over = [key for key, limit in B2_STAGE_LIMITS.items()
                if not stages[key] <= limit]
        print(f"[{phase}] B2 {mode}, stage by stage against float64 fed its "
              f"own cotangents: " + ", ".join(
                  f"{key} {stages[key]:.3e}" if isinstance(stages[key], float)
                  else f"{key} {stages[key]}" for key in B2_STAGE_LIMITS)
              + f" ({'within' if not over else 'OVER'} the limits)",
              flush=True)
        if over:
            fail(f"fused_mlp_bwd fails its stage-by-stage check ({mode}: "
                 f"{over})")
        bad = []
        for name in plain:
            rel = _rel(grads[name], plain[name])
            abs_err = (grads[name] - plain[name]).abs().max().item()
            worst = max(worst, abs_err)
            tol = limits[0] if name.startswith("layers_xyz.") else limits[1]
            ok, share = rel <= tol, ""
            if bf16_share and name.endswith("weight"):
                nz = grads[name][grads[name] != 0]
                frac = (nz == nz.bfloat16().float()).float().mean().item()
                share = (f", bf16-exact share {frac:.4f} (max "
                         f"{WEIGHT_GRAD_BF16_SHARE_MAX:g})")
                ok = ok and frac <= WEIGHT_GRAD_BF16_SHARE_MAX
            if not ok:
                bad.append(name)
            if verbose or not ok:
                print(f"[{phase}] B2 {mode} d{name}: norm_rel {rel:.3e} "
                      f"(tol {tol:g}), max_abs {abs_err:.3e}{share}")
        against = ("" if accumulate is None else
                   f" against the plain version accumulating in {accumulate}")
        print(f"[{phase}] B2 {mode}: {len(plain)} gradients, bitwise "
              f"repeatable{against}, "
              f"{'all within tolerance' if not bad else bad}", flush=True)
        if bad:
            fail(f"fused_mlp_bwd disagrees with the plain version ({mode}: "
                 f"{bad})")
    return worst


def _b2_launch(torch, net, ipe, dirs, g, k, stash, per_ray, lib=None):
    """B2 through its C entry point (on ``lib``, by default the built
    library) with a workspace made here, which the wrapper would drop:
    ``(gw, gb, ws, kw)``, the packed gradients, the workspace with the
    cotangent slabs and the packed weights.  A check's launch: not counted."""
    from ddnerf_tpu_torch.kernels import build
    from ddnerf_tpu_torch.kernels import fused_mlp as fk

    lib = lib or build.load_library()
    dev, n = ipe.device, ipe.shape[0]
    hid = fk.kernel_width(net.hidden_size)
    kw = fk.pack_weights(net)
    ipe_b = ipe.to(torch.bfloat16).contiguous()
    dirs_p = torch.zeros((n // k, fk.DIRS_LD), dtype=torch.bfloat16,
                         device=dev)
    dirs_p[:, :dirs.shape[1]] = dirs
    g32 = g.float().contiguous()
    gw = torch.empty(kw.w.numel(), dtype=torch.float32, device=dev)
    gb = torch.empty(kw.b.numel(), dtype=torch.float32, device=dev)
    wide = fk.is_wide(hid)
    ws_bytes = (lib.ddnerf_wide_bwd_workspace(n, k, hid, 0) if wide
                else lib.ddnerf_fused_mlp_bwd_workspace(n, k, hid))
    ws = torch.zeros(ws_bytes, dtype=torch.uint8, device=dev)
    trunk, h = stash.trunk.contiguous(), stash.h.contiguous()
    # The bf16 fused plan's chain reads the relu masks' words.
    bits = () if wide else (stash.bits.contiguous().data_ptr(),)
    args = (ipe_b.data_ptr(), dirs_p.data_ptr(), g32.data_ptr(),
            trunk.data_ptr(), h.data_ptr(), *bits, kw.w.data_ptr(),
            gw.data_ptr(), gb.data_ptr(), ws.data_ptr(), ws_bytes, n, k, hid,
            int(net.depth_head), int(per_ray))
    tail = (*fk._offsets(kw), torch.cuda.current_stream(dev).cuda_stream)
    err = (lib.ddnerf_wide_bwd(*args, 0, *tail) if wide
           else lib.ddnerf_fused_mlp_bwd(*args, *tail))
    build.check(lib, err, "fused_mlp_bwd")
    torch.cuda.synchronize()
    return gw, gb, ws, kw


def _b2_slabs(torch, ws, n, hid):
    """The cotangents B2 left in its workspace, where ``layout()`` in
    csrc/fused_mlp_bwd.cu (and ``bwd_layout()`` in csrc/fused_mlp_wide.cu)
    puts them (regions 256-byte aligned): ``gs [n,
    64]`` bf16 (g_heads | 0 | g_alpha at column 16), ``gd [n, 128]`` bf16
    (bf16(g_h)), ``ghf [n, 128]`` f32 (g_h), ``gt [9, n, H]`` bf16
    (bf16(g_0) .. bf16(g_7), bf16(g_feat))."""
    regions = (("gs", torch.bfloat16, (n, 64)), ("gd", torch.bfloat16, (n, 128)),
               ("ghf", torch.float32, (n, 128)),
               ("gt", torch.bfloat16, (9, n, hid)))
    out, off = {}, 0
    for name, dtype, shape in regions:
        nbytes = math.prod(shape) * (4 if dtype == torch.float32 else 2)
        out[name] = ws[off:off + nbytes].view(dtype).view(shape)
        off += -(-nbytes // 256) * 256
    return out


def _packed_mats(kw, t, hid):
    """The 12 matrices of the packed layout (``pack_weights``) in ``t`` (the
    weights or the weight gradients), as float64 ``[rows, cols]``."""
    from ddnerf_tpu_torch.kernels import fused_mlp as fk

    rows = fk.packed_rows(hid)
    ends = (*kw.w_off[1:], t.numel())
    return [t[o:e].double().view(r, -1)
            for o, e, r in zip(kw.w_off, ends, rows)]


def b2_stage_readings(torch, net, ipe, dirs, g, k, stash, per_ray, lib=None,
                      fault=None):
    """B2 held stage by stage against float64 arithmetic fed the kernel's
    own cotangent slabs, so that a bf16 rounding flipped upstream (which a
    comparison of the end results carries down the chain) cannot mask or
    mimic a fault.  Readings:

    * ``entry``: elements of the bf16 cotangent tile that differ from
      bf16(g) (0);
    * ``flip_share``: over the 10 rounded cotangents the kernel wrote
      (bf16(g_h), bf16(g_feat), bf16(g_7) .. bf16(g_0)), the largest share
      of elements that differ from the bf16 rounding of the float64
      product of the kernel's previous cotangent (relu-masked from the
      stash): float32 and float64 sums that round to the two bf16
      neighbours of the exact value; ``far``: elements farther from that
      value than one bf16 step plus the error bound of any float32 sum of
      its K products, 2 K 2^-24 sum |products| (0);
    * ``g_h``: the float32 g_h against float64, ||d|| / ||ref||;
    * ``weights`` / ``biases`` / ``dirs``: the largest ||d|| / ||ref|| of
      the weight gradients (the kernel's slabs times the stash), the bias
      gradients (float64 sums of the float64 cotangents before rounding)
      and the dirs weight gradient (g_dproj summed in float32 from the
      kernel's g_h, in row order, as ``per_ray`` says, times the dirs).

    ``fault``: a function ``(gw, gb, slabs, kw, hid) -> (gw, gb)`` applied
    to the kernel's packed gradients before they are read (a fault
    injected into its results, to show that the readings see it).

    Also returns the kernel's gradients by name, through ``unpack_grads``.
    """
    from ddnerf_tpu_torch.kernels import fused_mlp as fk

    n = ipe.shape[0]
    hid = fk.kernel_width(net.hidden_size)
    gw, gb, ws, kw = _b2_launch(torch, net, ipe, dirs, g, k, stash, per_ray,
                                lib)
    sl = _b2_slabs(torch, ws, n, hid)
    if fault is not None:
        gw, gb = fault(gw, gb, sl, kw, hid)
    w = _packed_mats(kw, kw.w, hid)
    grad_w = _packed_mats(kw, gw, hid)
    x = stash.trunk.double()  # x0..x7, feat
    hh = stash.h.double()
    gs, gd = sl["gs"].double(), sl["gd"].double()
    gt = sl["gt"]

    want_gs = torch.zeros(n, 64, device=ipe.device)
    want_gs[:, 0:3] = g[:, 0:3]
    if net.depth_head:
        want_gs[:, 3:5] = g[:, 4:6]
    want_gs[:, 16] = g[:, 3]
    r = {"entry": int((sl["gs"] != want_gs.bfloat16()).sum().item())}

    shares, far = [], 0

    def product(kernel, a, wm, mask=None):
        """The float64 product ``a @ wm`` (masked), held against the bf16
        ``kernel`` the kernel wrote for it; returns the product."""
        nonlocal far
        ref = a @ wm
        bound = 2 * a.shape[1] * 2.0 ** -24 * (a.abs() @ wm.abs())
        if mask is not None:
            ref = torch.where(mask, ref, 0.0)
        shares.append((kernel != ref.to(torch.bfloat16)).double().mean()
                      .item())
        step = torch.ldexp(torch.ones_like(ref), torch.frexp(ref)[1] - 8)
        far += int(((kernel.double() - ref).abs() > step + bound).sum()
                   .item())
        return ref

    g_h = product(sl["gd"], gs[:, :16], w[10], hh > 0)
    g_feat = product(gt[8], torch.cat([gd, gs[:, 16:17]], 1), w[9][:129])
    g_trunk = [None] * 8
    for layer, out in [(8, 7)] + [(i, i - 1) for i in range(7, 0, -1)]:
        wm = w[layer][:, 96:] if layer == 5 else w[layer]
        g_trunk[out] = product(gt[out], gt[layer].double(), wm, x[out] > 0)
    r["flip_share"], r["far"] = max(shares), far
    r["g_h"] = _rel(sl["ghf"].double(), g_h)

    ipe_b = ipe.to(torch.bfloat16).double()
    want_w = {}
    for i in range(8):
        act = (ipe_b if i == 0 else torch.cat([ipe_b, x[4]], 1) if i == 5
               else x[i - 1])
        want_w[i] = gt[i].double().T @ act
    want_w[8] = gt[8].double().T @ x[7]
    wd = torch.zeros_like(w[9])
    wd[:128] = gd.T @ x[8]
    wd[128] = gs[:, 16] @ x[8]
    want_w[9] = wd
    want_w[10] = gs[:, :16].T @ hh
    grad_w[9], want_w[9] = grad_w[9][:129], want_w[9][:129]  # rows B2 writes
    r["weights"] = max(_rel(grad_w[i], want_w[i]) for i in want_w)

    ghf = sl["ghf"].view(n // k, k, 128)
    g_dproj = torch.zeros_like(ghf[:, 0])
    for j in range(k):  # the kernel's order: row after row, in float32
        v = ghf[:, j]
        g_dproj += v if per_ray else v.bfloat16().float()
    if per_ray:
        g_dproj = g_dproj.bfloat16().float()
    dirs_b = dirs.to(torch.bfloat16).double()
    r["dirs"] = _rel(grad_w[11][:, :dirs.shape[1]], g_dproj.double().T @ dirs_b)

    b_ends = (*kw.b_off[1:], gb.numel())
    b = [gb[o:e].double() for o, e in zip(kw.b_off, b_ends)]
    want_dir = torch.zeros_like(b[2])
    want_dir[:128] = g_h.sum(0)
    want_dir[128] = gs[:, 16].sum()
    r["biases"] = max(
        max(_rel(b[0].view(8, hid)[i], g_trunk[i].sum(0)) for i in range(8)),
        _rel(b[1], g_feat.sum(0)), _rel(b[2], want_dir),
        _rel(b[3], gs[:, :16].sum(0)))
    return r, fk.unpack_grads(net, kw, gw, gb)


def _exact_case(torch, cls, hidden, rays, k, dev, seed):
    """A network and inputs of small integers: weights of +-1 with four
    nonzeros per row, zero biases, IPE, dirs and cotangent in {-1, 0, 1}.
    The forward's and the cotangent chain's sums are then integers (below
    2^24 on these seeds), exact in float32 in any order, and bf16 rounds an
    integer the same way everywhere: a sound B2 equals its plain version up
    to the last weight-gradient sums, and a fault shows in full."""
    gen = torch.Generator().manual_seed(seed)
    net = cls(hidden_size=hidden, compute_dtype=torch.bfloat16, generator=gen)
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.zero_()
            if name.endswith("weight"):
                cols = torch.rand(p.shape, generator=gen).argsort(1)[:, :4]
                signs = torch.randint(0, 2, (p.shape[0], 4), generator=gen)
                p.scatter_(1, cols, signs.float() * 2 - 1)
    n = rays * k
    ints = [torch.randint(-1, 2, shape, generator=gen).float().to(dev)
            for shape in ((n, 96), (rays, 27), (n, net.out_dim))]
    return (net.to(dev), *ints)


def _hold_forwards(phase, tag, errs, worst, f32=False):
    """Each forward kernel's |kernel - plain| (``errs``: name -> tensors)
    within MAX_ABS_TOL / MEAN_ABS_TOL (``f32``: max within F32_OUT_TOL),
    the largest kept in ``worst``."""
    for name, e in errs.items():
        max_err = max(x.max().item() for x in e)
        mean_err = max(x.mean().item() for x in e)
        worst[name] = max(worst[name], max_err)
        ok = (max_err <= F32_OUT_TOL if f32 else
              max_err <= MAX_ABS_TOL and mean_err <= MEAN_ABS_TOL)
        print(f"[{phase}] {name} {tag}: max_abs {max_err:.3e} (tol "
              f"{F32_OUT_TOL if f32 else MAX_ABS_TOL:g}), mean_abs "
              f"{mean_err:.3e}" + ("" if f32 else f" (tol {MEAN_ABS_TOL:g})")
              + f" {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{name} disagrees with the plain version ({tag})")


def phase_widths(torch):
    """B1, B3, B1s and B2 at each of :data:`WIDTHS`, both heads, on a
    ragged row count, against their plain versions under the gates of
    phases 3, 3b and 4 (B1s and B3 bit for bit B1, the padded stash
    columns zero, B2 in both dirs settings, stage by stage, its end result
    on random data against the plain version, accumulating in float64 at
    :data:`B2_FLOAT64_WIDTHS`, and on exact-integer data); then each
    width's kernel times at the main paths' shapes (DepthMipMLP) beside
    their bounds.  Returns the largest |kernel - plain| of each kernel
    (B2's on the random data)."""
    from ddnerf_tpu_torch.core.math import integrated_pos_enc
    from ddnerf_tpu_torch.kernels import fused_mlp as fk
    from ddnerf_tpu_torch.kernels import reference as ref
    from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP

    dev = torch.device("cuda")
    worst = dict.fromkeys(fk.LAUNCHES, 0.0)
    rays, k = 333, 33  # 10,989 rows: no whole number of 64- or 128-row tiles
    n = rays * k
    for hidden in WIDTHS:
        for cls in (DepthMipMLP, MipMLP):
            gen = torch.Generator().manual_seed(hidden)
            net = cls(hidden_size=hidden, compute_dtype=torch.bfloat16,
                      generator=gen).to(dev)
            tag = (f"{cls.__name__} H={hidden} (kernel width "
                   f"{fk.kernel_width(hidden)}) N={n} K={k}")
            means, covs = _gaussians(torch, gen, n, dev)
            ipe = integrated_pos_enc((means, covs), double_angle=False)
            dirs = (torch.rand(rays, 27, generator=gen) * 2 - 1).to(dev)
            g = torch.randn(n, net.out_dim, generator=gen).to(dev)
            b1 = fk.fused_mlp_forward(net, ipe, dirs, k)
            b1s, stash = fk.fused_mlp_forward(net, ipe, dirs, k, stash=True)
            b3 = fk.fused_enc_mlp_forward(net, means, covs, dirs, k)
            torch.cuda.synchronize()
            if not (torch.equal(b1, b1s) and torch.equal(b1, b3)):
                fail(f"B1s or B3 is not bit for bit B1 ({tag})")
            if stash.trunk[..., hidden:].any():
                fail(f"the stash's padded columns are not zero ({tag})")
            want, want_stash = ref.fused_mlp_stash_reference(net, ipe, dirs, k)
            errs = {"fused_mlp_fwd": [(b1 - want).abs()]}
            errs["fused_enc_mlp_fwd"] = [(b3 - ref.fused_enc_mlp_reference(
                net, means, covs, dirs, k)).abs()]
            errs["fused_mlp_fwd_stash"] = [
                (a.float() - b.float()).abs() for a, b in
                zip([b1s, *stash.trunk[..., :hidden], stash.h],
                    [want, *want_stash.trunk, want_stash.h])]
            _hold_forwards("widths", tag, errs, worst)
            f64 = hidden in B2_FLOAT64_WIDTHS
            err = _check_backward(
                torch, "widths", tag, net, ipe, dirs, g, k, stash,
                verbose=f64, limits=(
                    B2_FLOAT64_TRUNK_TOL if f64 else GRAD_NORM_REL_TOL_TRUNK,
                    GRAD_NORM_REL_TOL_HEADS),
                accumulate=torch.float64 if f64 else None)
            worst["fused_mlp_bwd"] = max(worst["fused_mlp_bwd"], err)
            net, ipe, dirs, g = _exact_case(torch, cls, hidden, rays, k, dev,
                                            hidden + 1)
            _, stash = fk.fused_mlp_forward(net, ipe, dirs, k, stash=True)
            _check_backward(torch, "widths", f"{tag} exact-integer data", net,
                            ipe, dirs, g, k, stash, verbose=False,
                            limits=(EXACT_GRAD_TOL, EXACT_GRAD_TOL),
                            bf16_share=False)
    # Each width's times at the main paths' shapes, beside the bounds.
    for hidden in WIDTHS:
        net = DepthMipMLP(hidden_size=hidden, compute_dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(0)).to(dev)
        gen = torch.Generator().manual_seed(1)
        means, covs = _gaussians(torch, gen, CHUNK_RAYS * SAMPLES, dev)
        ipe = integrated_pos_enc((means, covs), double_angle=False)
        dirs = (torch.rand(CHUNK_RAYS, 27, generator=gen) * 2 - 1).to(dev)
        t_ipe = ipe[:TRAIN_RAYS * SAMPLES]
        t_dirs = dirs[:TRAIN_RAYS]
        g = torch.randn(TRAIN_RAYS * SAMPLES, 6, generator=gen).to(dev)
        _, stash = fk.fused_mlp_forward(net, t_ipe, t_dirs, SAMPLES,
                                        stash=True)
        ms = {
            "fused_mlp_fwd": _event_ms(torch, lambda: fk.fused_mlp_forward(
                net, ipe, dirs, SAMPLES)),
            "fused_enc_mlp_fwd": _event_ms(
                torch, lambda: fk.fused_enc_mlp_forward(net, means, covs,
                                                        dirs, SAMPLES)),
            "fused_mlp_fwd_stash": _event_ms(
                torch, lambda: fk.fused_mlp_forward(net, t_ipe, t_dirs,
                                                    SAMPLES, stash=True)),
            "fused_mlp_bwd": _event_ms(torch, lambda: fk.fused_mlp_backward(
                net, t_ipe, t_dirs, g, SAMPLES, stash)),
        }
        bounds = kernel_bounds(hidden, CHUNK_RAYS * SAMPLES, CHUNK_RAYS,
                               TRAIN_RAYS * SAMPLES, TRAIN_RAYS)
        print(f"[widths] DepthMipMLP H={hidden} (kernel width "
              f"{fk.kernel_width(hidden)}): " + "; ".join(
                  f"{name} {ms[name]:.3f} ms (bound {bounds[name][0]:.3f} ms, "
                  f"{bounds[name][1]})" for name in ms)
              + f" (B1, B3 on {CHUNK_RAYS * SAMPLES} rows; B1s, B2 on "
              f"{TRAIN_RAYS * SAMPLES}; CUDA-event medians of "
              f"{TIMING_REPS})", flush=True)
    return worst


# Phase 18, the float32 kernels (csrc/fused_mlp_f32.cu, counted as
# ``{kernel}_f32``) against their plain versions at float32 with TF32 off.
# Both compute in f32 and differ in summation order only (the kernels'
# 3xTF32 products keep about f32's precision): B1, B3 and B1s within
# F32_OUT_TOL of the plain version (max |kernel - plain|), B1s bit for bit
# B1; B2 per gradient within F32_GRAD_TOL of the plain version's norm (the
# port's f32 limit, tests/test_torch_port_backward.py), bitwise repeatable,
# in both dirs settings.  Each limit must sit between the sound readings
# and three faults injected at width 256: the kernels built single-pass
# TF32 (F32_ONE_PASS), the weight pack rounded to bf16, the dirs rounded to
# bf16 (phase 18 fails if a fault reads inside a limit); first the TF32
# split of the weight pack, bit for bit its plain version.  Readings
# (scripts/f32_kernels.py; NVIDIA H100 80GB HBM3, 700 W; the wgmma
# kernels): B1 and B3 <= 6.6e-7, B1s <= 6.3e-6, B2 <= 7.8e-6 (fc_alpha.bias,
# a sum of 67,584 random cotangents that nearly cancel; the plain version
# sits 1.5e-6 from float64 there), every other leaf <= 4.5e-6; single-pass
# TF32 reads 1.0e-4 on B1's outputs (8.5e-5 with the mma.sync kernels that
# came before), about
# the JAX package's f32 kernel tolerance of 1e-4 (tests/test_fused_mlp.py),
# so the forward limit here is 1e-5.
F32_OUT_TOL = 1e-5
F32_GRAD_TOL = 1e-5
F32_ONE_PASS = ("-DDDNERF_F32_ONE_PASS",)
F32_WIDTHS = (256, 64, 192, 512)
F32_OPTS = ("parallel.compute_dtype", "float32")
# The float32 CLI run starts at the full rate (no lr delay), as the wide
# run does, so that its loss must fall in F32_ITERS iterations.
F32_TRAIN_OPTS = (*F32_OPTS, "optimizer.lr_delay_steps", "0")
F32_ITERS, F32_GRAPH_STEPS = 100, 20
F32_NAMES = ("fused_mlp_fwd_f32", "fused_enc_mlp_fwd_f32",
             "fused_mlp_fwd_stash_f32", "fused_mlp_bwd_f32")
# The single-pass TF32 build, started beside the main build (phase 1).
FAULT_BUILD = {}


def start_fault_build():
    """Compile the library with :data:`F32_ONE_PASS` in a thread, so that
    its nvcc runs beside the main build's."""
    from ddnerf_tpu_torch.kernels import build

    def run():
        try:
            FAULT_BUILD["info"] = build.build(F32_ONE_PASS)
        except (RuntimeError, OSError) as e:  # raised where it is needed
            FAULT_BUILD["error"] = e

    FAULT_BUILD["thread"] = threading.Thread(target=run, daemon=True)
    FAULT_BUILD["thread"].start()
    # A run that fails before phase 18 still leaves no nvcc behind.
    atexit.register(FAULT_BUILD["thread"].join)


@contextlib.contextmanager
def _f32_fault(fault, nets=()):
    """Inside: the wrappers compute with ``fault`` ("one-pass": the
    single-pass TF32 library; "bf16-weights": the weight pack rounded to
    bf16; anything else: none, the caller rounds the dirs itself)."""
    from ddnerf_tpu_torch.kernels import build
    from ddnerf_tpu_torch.kernels import fused_mlp as fk

    saved = build.load_library, fk.pack_weights
    if fault == "one-pass":
        FAULT_BUILD["thread"].join()
        if "error" in FAULT_BUILD:
            fail(f"the single-pass TF32 build failed: {FAULT_BUILD['error']}")
        lib = build.load_library(F32_ONE_PASS)
        build.load_library = lambda flags=(): lib
    elif fault == "bf16-weights":
        def rounded(net):  # the pack rounded, then split into its planes
            kw = saved[1](net)
            return fk.with_tf32_planes(
                kw._replace(w=kw.w.bfloat16().float(), planes=None))
        fk.pack_weights = rounded
    for net in nets:
        fk.forget_packed(net)
    try:
        yield
    finally:
        build.load_library, fk.pack_weights = saved
        for net in nets:
            fk.forget_packed(net)


def _f32_readings(torch, net, fwd, train, dirs_fault=False):
    """B1, B3 and B1s (outputs and stash, max |kernel - plain|) and B2 (the
    largest per-gradient norm-relative gap, per-sample dirs) of ``net`` on
    ``fwd`` = (means, covs, ipe, dirs, k, plain B1, plain B3) and ``train``
    = (ipe, dirs, k, g, plain out, plain stash, kernel stash, plain B2);
    ``dirs_fault``: the kernels get the dirs rounded to bf16."""
    from ddnerf_tpu_torch.kernels import fused_mlp as fk

    def rd(d):
        return d.bfloat16().float() if dirs_fault else d

    means, covs, ipe, dirs, k, p1, p3 = fwd
    out = {"fused_mlp_fwd_f32":
           (fk.fused_mlp_forward(net, ipe, rd(dirs), k) - p1).abs().max(),
           "fused_enc_mlp_fwd_f32":
           (fk.fused_enc_mlp_forward(net, means, covs, rd(dirs), k)
            - p3).abs().max()}
    t_ipe, t_dirs, t_k, g, p_out, p_stash, stash, p_grads = train
    hid = net.hidden_size
    b1s, s = fk.fused_mlp_forward(net, t_ipe, rd(t_dirs), t_k, stash=True)
    out["fused_mlp_fwd_stash_f32"] = max(
        (a - b).abs().max() for a, b in
        zip([b1s, *s.trunk[..., :hid], s.h], [p_out, *p_stash.trunk,
                                              p_stash.h]))
    grads = fk.fused_mlp_backward(net, t_ipe, rd(t_dirs), g, t_k, stash)
    out["fused_mlp_bwd_f32"] = max(_rel(grads[n], p_grads[n])
                                   for n in p_grads)
    return {name: float(v) for name, v in out.items()}


def _f32_split_check(torch):
    """The TF32 split of the float32 weight pack (``csrc/fused_mlp_f32.cu::
    tf32_split_kernel``, :func:`~ddnerf_tpu_torch.kernels.fused_mlp.
    with_tf32_planes`) against its plain version (``kernels/reference.py::
    tf32_split_pack_reference``), bit for bit: the pack of a network at
    each of :data:`F32_WIDTHS` and, at 256, a pack-sized buffer of special
    values (ties of the rounding, subnormals, values that round past the
    largest TF32 to infinity, random bit patterns of both signs).  Prints
    the split's time at 256."""
    import numpy as np

    from ddnerf_tpu_torch.kernels import fused_mlp as fk
    from ddnerf_tpu_torch.models.mlp import DepthMipMLP

    for hidden in F32_WIDTHS:
        net = DepthMipMLP(hidden_size=hidden, compute_dtype=torch.float32,
                          generator=torch.Generator().manual_seed(hidden))
        kw = fk.pack_weights(net.to("cuda"))
        cases = [("pack", kw)]
        if hidden == 256:
            rng = np.random.default_rng(12)
            size = kw.w.numel()
            bits = rng.integers(0, 0x7F800000, size, dtype=np.int64)
            x = bits.astype(np.uint32).view(np.float32).copy()
            units = np.ldexp(1.0, rng.integers(-126, 118, 4096) - 10)
            x[:4096] = (rng.integers(1024, 2048, 4096) + 0.5) * units  # ties
            x[4096:8192] = rng.integers(1, 1 << 23, 4096).astype(
                np.uint32).view(np.float32)  # subnormals
            x[8192:8256] = np.float32(np.finfo(np.float32).max)
            x *= np.where(rng.random(size) < 0.5, -1, 1).astype(np.float32)
            cases.append(("special values", kw._replace(
                w=torch.from_numpy(x).to("cuda"), planes=None)))
        for what, k in cases:
            got = fk.with_tf32_planes(k._replace(planes=None)).planes
            want = fk.with_tf32_planes(fk.KernelWeights(
                k.w.cpu(), k.b.cpu(), k.w_off, k.b_off)).planes
            equal = torch.equal(got.cpu(), want)
            print(f"[f32] tf32_split H={hidden} {what}: {k.w.numel()} "
                  f"weights into {len(fk.TF32_PLANES) - 1} planes, bit for "
                  f"bit the plain split: {equal}", flush=True)
            if not equal:
                fail(f"the TF32 split kernel differs from its plain version "
                     f"(H={hidden}, {what})")
        if hidden == 256:
            ms = _event_ms(torch, lambda: fk.with_tf32_planes(kw._replace(
                planes=None)))
            print(f"[f32] tf32_split H=256: {ms:.4f} ms per pack "
                  f"(CUDA-event median of {TIMING_REPS})", flush=True)


def phase_f32_kernels(torch):
    """Phase 18: the TF32 split of the weight pack bit for bit its plain
    version (:func:`_f32_split_check`); B1, B3, B1s and B2 at float32 (see
    :data:`F32_OUT_TOL`) at each of :data:`F32_WIDTHS`, both heads, on the
    main paths' shapes
    (B1 and B3 on a render chunk, B1s and B2 on a training batch, K = 32
    and, at 256, 33) and on a ragged 333 x 33; then each width's times
    beside their bounds and the three faults' readings at 256.  Returns
    (the largest |kernel - plain| of each kernel, {width: times})."""
    from ddnerf_tpu_torch.core.math import integrated_pos_enc
    from ddnerf_tpu_torch.kernels import fused_mlp as fk
    from ddnerf_tpu_torch.kernels import reference as ref
    from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP

    dev = torch.device("cuda")
    _f32_split_check(torch)
    worst = dict.fromkeys(F32_NAMES, 0.0)
    times, main = {}, {}
    for hidden in F32_WIDTHS:
        for cls in (DepthMipMLP, MipMLP):
            gen = torch.Generator().manual_seed(hidden + 18)
            net = cls(hidden_size=hidden, compute_dtype=torch.float32,
                      generator=gen).to(dev)
            fwd_cases = [(CHUNK_RAYS, SAMPLES), (333, 33)]
            train_cases = [(TRAIN_RAYS, SAMPLES), (333, 33)]
            if hidden == 256:
                train_cases.insert(1, (TRAIN_RAYS, 33))
            for rays, k in fwd_cases:
                tag = f"{cls.__name__} H={hidden} N={rays * k} K={k}"
                means, covs = _gaussians(torch, gen, rays * k, dev)
                ipe = integrated_pos_enc((means, covs), double_angle=False)
                dirs = (torch.rand(rays, 27, generator=gen) * 2 - 1).to(dev)
                b1 = fk.fused_mlp_forward(net, ipe, dirs, k)
                b3 = fk.fused_enc_mlp_forward(net, means, covs, dirs, k)
                p1 = ref.fused_mlp_reference(net, ipe, dirs, k)
                p3 = ref.fused_enc_mlp_reference(net, means, covs, dirs, k)
                torch.cuda.synchronize()
                for name, a, b in (("fused_mlp_fwd_f32", b1, p1),
                                   ("fused_enc_mlp_fwd_f32", b3, p3)):
                    err = (a - b).abs().max().item()
                    ok = bool(torch.isfinite(a).all()) and err <= F32_OUT_TOL
                    worst[name] = max(worst[name], err)
                    print(f"[f32] {name} {tag}: max_abs {err:.3e} (tol "
                          f"{F32_OUT_TOL:g}) {'ok' if ok else 'FAIL'}",
                          flush=True)
                    if not ok:
                        fail(f"{name} disagrees with the plain version "
                             f"({tag})")
                if (rays, k) == (CHUNK_RAYS, SAMPLES) and cls is DepthMipMLP:
                    main[hidden] = {"net": net,
                                    "fwd": (means, covs, ipe, dirs, k, p1, p3)}
            for rays, k in train_cases:
                n = rays * k
                tag = f"{cls.__name__} H={hidden} N={n} K={k}"
                ipe = (torch.rand(n, 96, generator=gen) * 2 - 1).to(dev)
                dirs = (torch.rand(rays, 27, generator=gen) * 2 - 1).to(dev)
                g = torch.randn(n, net.out_dim, generator=gen).to(dev)
                b1 = fk.fused_mlp_forward(net, ipe, dirs, k)
                b1s, stash = fk.fused_mlp_forward(net, ipe, dirs, k,
                                                  stash=True)
                p_out, p_stash = ref.fused_mlp_stash_reference(net, ipe, dirs,
                                                               k)
                torch.cuda.synchronize()
                if not torch.equal(b1, b1s):
                    fail(f"B1s-f32 is not bit for bit B1-f32 ({tag})")
                if stash.trunk[..., hidden:].any():
                    fail(f"the f32 stash's padded columns are not zero "
                         f"({tag})")
                err = max((a - b).abs().max().item() for a, b in zip(
                    [b1s, *stash.trunk[..., :hidden], stash.h],
                    [p_out, *p_stash.trunk, p_stash.h]))
                worst["fused_mlp_fwd_stash_f32"] = max(
                    worst["fused_mlp_fwd_stash_f32"], err)
                ok = err <= F32_OUT_TOL
                print(f"[f32] fused_mlp_fwd_stash_f32 {tag}: outputs bit for "
                      f"bit B1-f32's; outputs + 10 stash slabs vs plain: "
                      f"max_abs {err:.3e} (tol {F32_OUT_TOL:g}) "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"fused_mlp_fwd_stash_f32 disagrees with the plain "
                         f"version ({tag})")
                err, plain = _check_backward_f32(
                    torch, "f32", "fused_mlp_bwd_f32", tag, net, ipe, dirs, g,
                    k, stash)
                worst["fused_mlp_bwd_f32"] = max(worst["fused_mlp_bwd_f32"],
                                                 err)
                if (rays, k) == (TRAIN_RAYS, SAMPLES) and cls is DepthMipMLP:
                    main[hidden]["train"] = (ipe, dirs, k, g, p_out, p_stash,
                                             stash, plain[False])
        # Times at the main paths' shapes (DepthMipMLP), beside the bounds.
        m = main[hidden]
        net = m["net"]
        means, covs, ipe, dirs, k, _, _ = m["fwd"]
        t_ipe, t_dirs, t_k, g, _, _, stash, _ = m["train"]
        t = {
            "fused_mlp_fwd_f32": (
                lambda: fk.fused_mlp_forward(net, ipe, dirs, k),
                lambda: ref.fused_mlp_reference(net, ipe, dirs, k)),
            "fused_enc_mlp_fwd_f32": (
                lambda: fk.fused_enc_mlp_forward(net, means, covs, dirs, k),
                lambda: ref.fused_enc_mlp_reference(net, means, covs, dirs,
                                                    k)),
            "fused_mlp_fwd_stash_f32": (
                lambda: fk.fused_mlp_forward(net, t_ipe, t_dirs, t_k,
                                             stash=True),
                lambda: ref.fused_mlp_stash_reference(net, t_ipe, t_dirs,
                                                      t_k)),
            "fused_mlp_bwd_f32": (
                lambda: fk.fused_mlp_backward(net, t_ipe, t_dirs, g, t_k,
                                              stash),
                lambda: ref.fused_mlp_backward_reference(
                    net, t_ipe, t_dirs, g, t_k, stash)),
        }
        times[hidden] = {name: (_event_ms(torch, kern), _event_ms(torch, pl))
                         for name, (kern, pl) in t.items()}
        bounds = kernel_bounds(hidden, CHUNK_RAYS * SAMPLES, CHUNK_RAYS,
                               TRAIN_RAYS * SAMPLES, TRAIN_RAYS, f32=True)
        print(f"[f32] DepthMipMLP H={hidden}: " + "; ".join(
            f"{name} {kt:.3f} ms, plain {pt:.3f} ms (bound "
            f"{bounds[name][0]:.3f} ms, {bounds[name][1]})"
            for name, (kt, pt) in times[hidden].items())
            + f" (B1, B3 on {CHUNK_RAYS * SAMPLES} rows; B1s, B2 on "
            f"{TRAIN_RAYS * SAMPLES}; CUDA-event medians of {TIMING_REPS})",
            flush=True)
        if hidden != 256:
            del main[hidden]
    # The faults, at 256: each reading must fall outside its limit.
    m = main[256]
    inside = []
    for fault in ("one-pass", "bf16-weights", "bf16-dirs"):
        with _f32_fault(fault, [m["net"]]), torch.no_grad():
            r = _f32_readings(torch, m["net"], m["fwd"], m["train"],
                              dirs_fault=fault == "bf16-dirs")
        limits = {name: F32_GRAD_TOL if name == "fused_mlp_bwd_f32"
                  else F32_OUT_TOL for name in r}
        inside += [f"{fault} {name}" for name in r
                   if not r[name] > limits[name]]
        print(f"[f32] fault {fault} at H=256: " + "; ".join(
            f"{name} {r[name]:.3e} (limit {limits[name]:g})" for name in r),
            flush=True)
    if inside:
        fail(f"phase 18's limits do not separate these faults: {inside}")
    return worst, times


def phase_cli_path(logroot, tag, opts, iters, what):
    """A config's run (``opts``: overrides) through the CLIs in the worker:
    ``iters`` iterations of training under the captured step (2 B1s + 2 B2
    per iteration, of the plan and dtype the config takes), eval of one
    image, one video frame through B1 (``mlp``) and one through B3
    (``ipe2``); then that run's eval image and video frame through B1 and
    B3 against the plain version.  Phases 17 (coarse-192 / fine-512), 18
    (float32) and 19 (coarse-600 / fine-1024, both dtypes; coarse-256 /
    fine-1024, both plans).  Returns the
    runs' launch counts, summed."""
    from ddnerf_tpu_torch.train.checkpoint import load_config_snapshot

    logdir, train = phase_train_main_path(logroot, f"{tag}-train", opts,
                                          run=f"{tag}_smoke", iters=iters)
    evals = phase_main_path(logdir, f"{tag}-eval", images=1)
    video = phase_video_main_path(logdir, f"{tag}-video", 1, VIDEO_HW, iters)
    _frame_vs_plain(load_config_snapshot(logdir), f"{tag}-frames", what,
                    logdir=logdir)
    return _sum_launches(train, evals, video)


# Phase 19, the wide plan (csrc/fused_mlp_wide.cu, counted as ``wide_*``):
# every width above the fused plans' 512, one GEMM launch per layer, in
# both compute dtypes.  (a) B1, B3, B1s and B2 at widths 600 (run at 640),
# 768 and 1024, both heads, on the ragged 333 x 33, under the gates of
# phases 17 and 18: bf16 outputs within MAX_ABS_TOL / MEAN_ABS_TOL, B1s and
# B3 bit for bit B1, B2 stage by stage (B2_STAGE_LIMITS) in both dirs
# settings and on exact-integer data, its end result held, as at 512,
# against the plain version accumulating in float64 to B2_FLOAT64_TRUNK_TOL
# (against the float32 plain version the trunk leaves read 1.0e-3 at 600
# and 1.4-1.6e-3 at 1024, where the float32 plain version itself moves
# away from float64: the ``[wide] B2 ... trunk`` lines print all three);
# float32 within F32_OUT_TOL / F32_GRAD_TOL, B1s bit for bit B1, bitwise
# repeatable, the pack's TF32 planes bit for bit the plain split, and the
# transposed TF32 planes the float32 chain writes for its weight gradients
# bit for bit ``reference.tf32_planes_t_reference``; every forward is
# launched twice and held bitwise to itself (B2 already is).  Two
# faults applied to the bf16 kernel's own results at 1024 must read outside
# the stage limits: the weight gradients rounded to bf16, and the bias
# gradients summed from the rounded cotangent slabs.  Then, at 1024 on the
# main paths' shapes (B1 and B3 on a render chunk, B1s and B2 on a training
# batch), the same gates in both dtypes, phase 18's three float32 faults
# (the single-pass TF32 build, the pack and the dirs rounded to bf16), each
# of which must read outside F32_OUT_TOL / F32_GRAD_TOL, and each kernel's
# time beside its bound, its plain version's time and the library
# yardstick's (:func:`library_ms`).
WIDE_PLAN_WIDTHS = (600, 768, 1024)
WIDE_NAMES = tuple(f"wide_{base}{sfx}" for sfx in ("", "_f32")
                   for base in ("mlp_fwd", "enc_mlp_fwd", "mlp_fwd_stash",
                                "mlp_bwd"))
WIDE_TIMING_WIDTH, WIDE_TIMING_REPS = 1024, 5
# (b) the coarse-600 / fine-1024 pair: the three CLIs at bf16 and at
# float32 under the captured step, frames against the plain version,
# captured vs eager, and kernel vs plain on the config's schedule.  The CLI
# runs start without the lr delay, so that the loss must fall in BIG_ITERS
# iterations, but at lr_init 1e-4: at the config's 5e-4 from step 0 the
# fine network's density dies within 40 iterations at every width tried
# (256 / 256, 192 / 512, 600 / 1024; the plain path's the same), its
# render is black and the eval's ssim_v2 (data range max - min) is NaN.
BIG_OPTS = ("nerf.coarse_hidden_size", "600", "nerf.fine_hidden_size",
            "1024")
BIG_TRAIN_OPTS = (*BIG_OPTS, "optimizer.lr_delay_steps", "0",
                  "optimizer.lr_init", "1e-4")
BIG_ITERS, BIG_GRAPH_STEPS = 40, 20
# A pair whose networks take different plans (coarse on the fused plan,
# fine on the wide one): one captured step launches both plans' kernels.
# Its CLI run keeps the config's schedule (the lr delay): from step 0 at
# lr_init 1e-4 both MSEs fall but the dp loss rises, on the plain path as
# with the kernels, so the summed loss does not fall in BIG_ITERS
# iterations, and at 2e-4 (as at 5e-4) this run's fine render goes black
# and the eval's ssim_v2 is NaN.
MIXED_OPTS = ("nerf.coarse_hidden_size", "256", "nerf.fine_hidden_size",
              "1024")
# (c) the microbatched step: 8192 rays a step in chunks of 2048 (k = 4)
# captured against eager, and against the captured monolithic 8192-ray
# step's peak device memory.
MB_OPTS = ("nerf.train.num_random_rays", "8192",
           "parallel.microbatch_rays", "2048")
MB_WHOLE_OPTS = ("nerf.train.num_random_rays", "8192")
MB_GRAPH_STEPS = 20


def _wide_b2_faults():
    """The two faults of phase 19 as :func:`b2_stage_readings` hooks."""
    def weights_bf16(gw, gb, sl, kw, hid):
        return gw.bfloat16().float(), gb

    def biases_rounded(gw, gb, sl, kw, hid):
        gb = gb.clone()
        trunk = sl["gt"].float().sum(1)  # [9, hid]: bf16(g_0..g_7), g_feat
        o0, o1 = kw.b_off[0], kw.b_off[1]
        gb[o0:o0 + 8 * hid] = trunk[:8].reshape(-1)
        gb[o1:o1 + hid] = trunk[8]
        return gw, gb

    return {"weight gradients rounded to bf16": weights_bf16,
            "biases summed from the rounded cotangents": biases_rounded}


def _check_backward_f32(torch, phase, name, tag, net, ipe, dirs, g, k,
                        stash):
    """B2 at float32 (kernel ``name``) against its plain version in both
    dirs settings: bitwise repeatable, every gradient within F32_GRAD_TOL
    of the plain version's norm.  Returns (the largest |kernel - plain|,
    {per_ray: the plain gradients})."""
    from ddnerf_tpu_torch.kernels import fused_mlp as fk
    from ddnerf_tpu_torch.kernels import reference as ref

    worst, plains = 0.0, {}
    for per_ray in (False, True):
        mode = f"{tag} {'per-ray' if per_ray else 'per-sample'}"
        grads = fk.fused_mlp_backward(net, ipe, dirs, g, k, stash, per_ray)
        again = fk.fused_mlp_backward(net, ipe, dirs, g, k, stash, per_ray)
        torch.cuda.synchronize()
        if not all(torch.equal(grads[x], again[x]) for x in grads):
            fail(f"{name} is not bitwise repeatable ({mode})")
        plain = ref.fused_mlp_backward_reference(net, ipe, dirs, g, k, stash,
                                                 per_ray)
        f64 = ref.fused_mlp_backward_reference(net, ipe, dirs, g, k, stash,
                                               per_ray,
                                               accumulate=torch.float64)
        plains[per_ray] = plain
        rel = {x: _rel(grads[x], plain[x]) for x in plain}
        rel64 = max(_rel(grads[x], f64[x]) for x in plain)
        plain64 = max(_rel(plain[x], f64[x]) for x in plain)
        worst = max(worst, max((grads[x] - plain[x]).abs().max().item()
                               for x in plain))
        top = max(rel, key=rel.get)
        bad = [x for x in rel if not rel[x] <= F32_GRAD_TOL]
        print(f"[{phase}] {name} {mode} dirs: {len(rel)} gradients bitwise "
              f"repeatable, largest norm_rel {rel[top]:.3e} (d{top}; tol "
              f"{F32_GRAD_TOL:g}); against float64 accumulation "
              f"{rel64:.3e} (the plain version's own {plain64:.3e}) "
              f"{'ok' if not bad else bad}", flush=True)
        if bad:
            fail(f"{name} disagrees with the plain version ({mode}: {bad})")
    return worst, plains


def _check_wide_planes(torch, net, ipe, dirs, g, k, stash, tag):
    """B2 at float32 through the wide plan's C entry point with a workspace
    kept here: the transposed TF32 planes its chain wrote for the weight
    gradients (the last, of g_0, where ``bwd_layout()`` in
    csrc/fused_mlp_wide.cu puts them after the slabs) bit for bit
    ``reference.tf32_planes_t_reference`` of the g_0 slab it wrote.  A
    check's launch: not counted."""
    from ddnerf_tpu_torch.kernels import build
    from ddnerf_tpu_torch.kernels import fused_mlp as fk
    from ddnerf_tpu_torch.kernels import reference as ref

    lib = build.load_library()
    dev, n = ipe.device, ipe.shape[0]
    hid = fk.kernel_width(net.hidden_size)
    kw = fk.pack_weights(net)
    ipe_c, dirs_c = ipe.float().contiguous(), dirs.float().contiguous()
    g32 = g.float().contiguous()
    gw = torch.empty(kw.w.numel(), dtype=torch.float32, device=dev)
    gb = torch.empty(kw.b.numel(), dtype=torch.float32, device=dev)
    ws_bytes = lib.ddnerf_wide_bwd_workspace(n, k, hid, 1)
    ws = torch.zeros(ws_bytes, dtype=torch.uint8, device=dev)
    trunk, h = stash.trunk.contiguous(), stash.h.contiguous()
    err = lib.ddnerf_wide_bwd(
        ipe_c.data_ptr(), dirs_c.data_ptr(), g32.data_ptr(), trunk.data_ptr(),
        h.data_ptr(), kw.planes.data_ptr(), gw.data_ptr(), gb.data_ptr(),
        ws.data_ptr(), ws_bytes, n, k, hid, int(net.depth_head), 0, 1,
        *fk._offsets(kw), torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "fused_mlp_bwd")
    torch.cuda.synchronize()
    ldt = -(-n // 32) * 32
    off = 0
    for count in (n * 64, n * 128, n * 128):  # gs, gd, ghf
        off += -(-count * 4 // 256) * 256
    g0 = ws[off:off + n * hid * 4].view(torch.float32).view(n, hid)
    off += -(-9 * n * hid * 4 // 256) * 256
    planes = ws[off:off + 2 * hid * ldt * 4].view(torch.float32).view(
        2, hid, ldt)
    want = ref.tf32_planes_t_reference(g0)
    if not torch.equal(planes[..., :n], want[..., :n]):
        fail(f"the wide float32 backward's transposed TF32 planes differ "
             f"from the plain split ({tag})")
    print(f"[wide] B2 {tag}: the chain's transposed TF32 planes of g_0 "
          f"({2 * hid * n} elements) bit for bit the plain split", flush=True)
    del ws


def _hold_wide(torch, net, fwd, train, tag, worst):
    """B1 and B3 of the wide plan on ``fwd`` = (means, covs, ipe, dirs, k),
    B1s and B2 on ``train`` = (ipe, dirs, k, g) (the same rows, or a
    training batch), each launched once and held against its plain version
    under phase 19's gates; the largest |kernel - plain| of each kernel is
    kept in ``worst``.  Returns, at bf16, the kernel's stash; at float32
    (fwd, train) with the plain results, as :func:`_f32_readings` takes
    them."""
    from ddnerf_tpu_torch.kernels import fused_mlp as fk
    from ddnerf_tpu_torch.kernels import reference as ref

    f32 = net.compute_dtype == torch.float32
    sfx = "_f32" if f32 else ""
    hidden = net.hidden_size
    means, covs, ipe, dirs, k = fwd
    t_ipe, t_dirs, t_k, g = train
    before = dict(fk.LAUNCHES)
    b1 = fk.fused_mlp_forward(net, ipe, dirs, k)
    b3 = fk.fused_enc_mlp_forward(net, means, covs, dirs, k)
    b1s, stash = fk.fused_mlp_forward(net, t_ipe, t_dirs, t_k, stash=True)
    torch.cuda.synchronize()
    launched = {x: fk.LAUNCHES[x] - before[x] for x in before
                if fk.LAUNCHES[x] != before[x]}
    if launched != {f"wide_mlp_fwd{sfx}": 1, f"wide_mlp_fwd_stash{sfx}": 1,
                    f"wide_enc_mlp_fwd{sfx}": 1}:
        fail(f"the forwards at {tag} launched {launched}, not the wide "
             f"plan's kernels once each")
    b1_t = b1 if t_ipe is ipe else fk.fused_mlp_forward(net, t_ipe, t_dirs,
                                                         t_k)
    if not torch.equal(b1_t, b1s) or (not f32 and not torch.equal(b1, b3)):
        fail(f"B1s or B3 is not bit for bit B1 ({tag})")
    # Each forward launched again on the same inputs: bitwise the same (B2
    # is held to it below).
    again_s, again_stash = fk.fused_mlp_forward(net, t_ipe, t_dirs, t_k,
                                                stash=True)
    if not (torch.equal(b1, fk.fused_mlp_forward(net, ipe, dirs, k))
            and torch.equal(b3, fk.fused_enc_mlp_forward(net, means, covs,
                                                         dirs, k))
            and torch.equal(b1s, again_s)
            and torch.equal(stash.trunk, again_stash.trunk)
            and torch.equal(stash.h, again_stash.h)):
        fail(f"a wide forward is not bitwise repeatable ({tag})")
    del again_s, again_stash
    print(f"[wide] {tag}: B1, B3 and B1s (its stash too) bitwise repeatable",
          flush=True)
    if stash.trunk[..., hidden:].any():
        fail(f"the stash's padded columns are not zero ({tag})")
    p1 = ref.fused_mlp_reference(net, ipe, dirs, k)
    p3 = ref.fused_enc_mlp_reference(net, means, covs, dirs, k)
    p_out, p_stash = ref.fused_mlp_stash_reference(net, t_ipe, t_dirs, t_k)
    _hold_forwards("wide", tag, {
        f"wide_mlp_fwd{sfx}": [(b1 - p1).abs()],
        f"wide_enc_mlp_fwd{sfx}": [(b3 - p3).abs()],
        f"wide_mlp_fwd_stash{sfx}": [
            (a.float() - b.float()).abs() for a, b in
            zip([b1s, *stash.trunk[..., :hidden], stash.h],
                [p_out, *p_stash.trunk, p_stash.h])]}, worst, f32)
    if f32:
        err, plains = _check_backward_f32(torch, "wide", "wide_mlp_bwd_f32",
                                          tag, net, t_ipe, t_dirs, g, t_k,
                                          stash)
        _check_wide_planes(torch, net, t_ipe, t_dirs, g, t_k, stash, tag)
        worst["wide_mlp_bwd_f32"] = max(worst["wide_mlp_bwd_f32"], err)
        return ((means, covs, ipe, dirs, k, p1, p3),
                (t_ipe, t_dirs, t_k, g, p_out, p_stash, stash, plains[False]))
    err = _check_backward(
        torch, "wide", tag, net, t_ipe, t_dirs, g, t_k, stash, verbose=False,
        limits=(B2_FLOAT64_TRUNK_TOL, GRAD_NORM_REL_TOL_HEADS),
        accumulate=torch.float64)
    worst["wide_mlp_bwd"] = max(worst["wide_mlp_bwd"], err)
    # The cause of the trunk readings: float32 accumulation.
    kern = fk.fused_mlp_backward(net, t_ipe, t_dirs, g, t_k, stash)
    p32 = ref.fused_mlp_backward_reference(net, t_ipe, t_dirs, g, t_k, stash)
    p64 = ref.fused_mlp_backward_reference(net, t_ipe, t_dirs, g, t_k, stash,
                                           accumulate=torch.float64)
    trunk = [x for x in p32 if x.startswith("layers_xyz.")]
    print(f"[wide] B2 {tag}: trunk leaves, largest norm_rel: kernel vs the "
          f"float32 plain version "
          f"{max(_rel(kern[x], p32[x]) for x in trunk):.3e}, kernel vs "
          f"float64 accumulation "
          f"{max(_rel(kern[x], p64[x]) for x in trunk):.3e}, the float32 "
          f"plain version vs float64 "
          f"{max(_rel(p32[x], p64[x]) for x in trunk):.3e}", flush=True)
    return stash


def phase_wide_plan(torch):
    """Phase 19 (a), see :data:`WIDE_PLAN_WIDTHS`.  Returns (the largest
    |kernel - plain| of each wide kernel, over the ragged and the main
    paths' shapes, {kernel: (ms, plain ms, library ms)} at width
    :data:`WIDE_TIMING_WIDTH`)."""
    from ddnerf_tpu_torch.core.math import integrated_pos_enc
    from ddnerf_tpu_torch.kernels import fused_mlp as fk
    from ddnerf_tpu_torch.kernels import reference as ref
    from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP

    dev = torch.device("cuda")
    worst = dict.fromkeys(WIDE_NAMES, 0.0)
    rays, k = 333, 33
    n = rays * k
    for hidden in WIDE_PLAN_WIDTHS:
        width = fk.kernel_width(hidden)
        for cls in (DepthMipMLP, MipMLP):
            for cdt in (torch.bfloat16, torch.float32):
                f32 = cdt == torch.float32
                gen = torch.Generator().manual_seed(hidden + 19 + f32)
                net = cls(hidden_size=hidden, compute_dtype=cdt,
                          generator=gen).to(dev)
                tag = (f"{cls.__name__} H={hidden} (kernel width {width}) "
                       f"{'float32' if f32 else 'bf16'} N={n} K={k}")
                means, covs = _gaussians(torch, gen, n, dev)
                ipe = integrated_pos_enc((means, covs), double_angle=False)
                dirs = (torch.rand(rays, 27, generator=gen) * 2 - 1).to(dev)
                g = torch.randn(n, net.out_dim, generator=gen).to(dev)
                with torch.no_grad():
                    stash = _hold_wide(torch, net,
                                       (means, covs, ipe, dirs, k),
                                       (ipe, dirs, k, g), tag, worst)
                if f32:
                    if cls is DepthMipMLP:  # the pack's planes
                        kw = fk.pack_weights(net)
                        buf = kw.planes.cpu().clone()
                        ref.tf32_split_pack_reference(buf, kw.w_off,
                                                      fk.packed_rows(width))
                        if not torch.equal(buf, kw.planes.cpu()):
                            fail(f"the wide TF32 split differs from the "
                                 f"plain split ({tag})")
                        print(f"[wide] tf32_split {tag}: the pack's "
                              f"{buf.numel()} plane elements bit for bit the "
                              f"plain split", flush=True)
                    continue
                if hidden == max(WIDE_PLAN_WIDTHS) and cls is DepthMipMLP:
                    for fault, fn in _wide_b2_faults().items():
                        r, _ = b2_stage_readings(torch, net, ipe, dirs, g, k,
                                                 stash, False, fault=fn)
                        over = [x for x, lim in B2_STAGE_LIMITS.items()
                                if not r[x] <= lim]
                        print(f"[wide] fault at {tag}, {fault}: "
                              + ", ".join(f"{x} {r[x]:.3e}"
                                          if isinstance(r[x], float)
                                          else f"{x} {r[x]}"
                                          for x in B2_STAGE_LIMITS)
                              + f" (outside the limits: {over})", flush=True)
                        if not over:
                            fail(f"phase 19's B2 limits do not see the "
                                 f"fault '{fault}'")
                enet, eipe, edirs, eg = _exact_case(torch, cls, hidden, rays,
                                                    k, dev, hidden + 1)
                _, estash = fk.fused_mlp_forward(enet, eipe, edirs, k,
                                                 stash=True)
                _check_backward(torch, "wide", f"{tag} exact-integer data",
                                enet, eipe, edirs, eg, k, estash,
                                verbose=False,
                                limits=(EXACT_GRAD_TOL, EXACT_GRAD_TOL),
                                bf16_share=False)
    # At width WIDE_TIMING_WIDTH on the main paths' shapes (DepthMipMLP):
    # the same gates, the float32 faults (each must read outside its
    # limit, as in phase 18), then the times beside the bounds.
    times, inside = {}, []
    hidden = WIDE_TIMING_WIDTH
    for cdt in (torch.bfloat16, torch.float32):
        f32 = cdt == torch.float32
        sfx = "_f32" if f32 else ""
        net = DepthMipMLP(hidden_size=hidden, compute_dtype=cdt,
                          generator=torch.Generator().manual_seed(0)).to(dev)
        gen = torch.Generator().manual_seed(1)
        means, covs = _gaussians(torch, gen, CHUNK_RAYS * SAMPLES, dev)
        ipe = integrated_pos_enc((means, covs), double_angle=False)
        dirs = (torch.rand(CHUNK_RAYS, 27, generator=gen) * 2 - 1).to(dev)
        t_ipe, t_dirs = ipe[:TRAIN_RAYS * SAMPLES], dirs[:TRAIN_RAYS]
        g = torch.randn(TRAIN_RAYS * SAMPLES, 6, generator=gen).to(dev)
        tag = (f"DepthMipMLP H={hidden} {'float32' if f32 else 'bf16'} main "
               f"paths' shapes (B1, B3 N={CHUNK_RAYS * SAMPLES}; B1s, B2 "
               f"N={TRAIN_RAYS * SAMPLES}) K={SAMPLES}")
        with torch.no_grad():  # the plain forward's graph would not fit
            got = _hold_wide(torch, net, (means, covs, ipe, dirs, SAMPLES),
                             (t_ipe, t_dirs, SAMPLES, g), tag, worst)
        stash = got[1][6] if f32 else got
        for fault in ("one-pass", "bf16-weights", "bf16-dirs") if f32 else ():
            with _f32_fault(fault, [net]), torch.no_grad():
                r = _f32_readings(torch, net, *got,
                                  dirs_fault=fault == "bf16-dirs")
            r = {"wide_" + name[len("fused_"):]: v for name, v in r.items()}
            limits = {name: F32_GRAD_TOL if "bwd" in name else F32_OUT_TOL
                      for name in r}
            inside += [f"{fault} {name}" for name in r
                       if not r[name] > limits[name]]
            print(f"[wide] fault {fault} at {tag}: " + "; ".join(
                f"{name} {r[name]:.3e} (limit {limits[name]:g})"
                for name in r), flush=True)
        pairs = {
            f"wide_mlp_fwd{sfx}": (
                lambda: fk.fused_mlp_forward(net, ipe, dirs, SAMPLES),
                lambda: ref.fused_mlp_reference(net, ipe, dirs, SAMPLES)),
            f"wide_enc_mlp_fwd{sfx}": (
                lambda: fk.fused_enc_mlp_forward(net, means, covs, dirs,
                                                 SAMPLES),
                lambda: ref.fused_enc_mlp_reference(net, means, covs, dirs,
                                                    SAMPLES)),
            f"wide_mlp_fwd_stash{sfx}": (
                lambda: fk.fused_mlp_forward(net, t_ipe, t_dirs, SAMPLES,
                                             stash=True),
                lambda: ref.fused_mlp_stash_reference(net, t_ipe, t_dirs,
                                                      SAMPLES)),
            f"wide_mlp_bwd{sfx}": (
                lambda: fk.fused_mlp_backward(net, t_ipe, t_dirs, g, SAMPLES,
                                              stash),
                lambda: ref.fused_mlp_backward_reference(
                    net, t_ipe, t_dirs, g, SAMPLES, stash)),
        }
        del got
        for name, (kern, plain) in pairs.items():
            times[name] = (_event_ms(torch, kern, WIDE_TIMING_REPS),
                           _event_ms(torch, plain, WIDE_TIMING_REPS))
        library = library_ms(torch, hidden, f32, "wide",
                             WIDE_TIMING_REPS)
        for name in pairs:
            times[name] += (library[name],)
        bounds = _wide_bounds(hidden, f32)
        padded = _wide_bounds(fk.kernel_width(600), f32)
        print(f"[wide] DepthMipMLP H={hidden} {'float32' if f32 else 'bf16'}: "
              + "; ".join(
                  f"{name} {times[name][0]:.3f} ms, plain {times[name][1]:.3f} "
                  f"ms, library {times[name][2]:.3f} ms (bound "
                  f"{bounds[name][0]:.3f} ms, {bounds[name][1]})"
                  for name in pairs)
              + f" (B1, B3 on {CHUNK_RAYS * SAMPLES} rows; B1s, B2 on "
              f"{TRAIN_RAYS * SAMPLES}; CUDA-event medians of "
              f"{WIDE_TIMING_REPS}); bounds at H=600 "
              + ", ".join(f"{name} {_wide_bounds(600, f32)[name][0]:.3f} ms "
                          f"({padded[name][0]:.3f} ms at its padded width "
                          f"{fk.kernel_width(600)})" for name in pairs),
              flush=True)
    if inside:
        fail(f"phase 19's float32 limits do not separate these faults: "
             f"{inside}")
    return worst, times


def _wide_bounds(hidden, f32):
    """:func:`kernel_bounds` at width ``hidden`` on the main paths' shapes,
    under the wide kernels' names."""
    return {"wide_" + name[len("fused_"):]: v for name, v in kernel_bounds(
        hidden, CHUNK_RAYS * SAMPLES, CHUNK_RAYS, TRAIN_RAYS * SAMPLES,
        TRAIN_RAYS, f32=f32).items()}


# The library yardstick (the kernels line's library_ms): one PyTorch matrix
# product per product of the network at the plan's shapes and in its dtype
# (bf16 operands with float32 products, or float32 with TF32 off), summed
# per kernel.  The port never calls them.
LIBRARY_KERNELS = (("mlp_fwd", "fwd", CHUNK_RAYS * SAMPLES),
                   ("enc_mlp_fwd", "fwd", CHUNK_RAYS * SAMPLES),
                   ("mlp_fwd_stash", "fwd", TRAIN_RAYS * SAMPLES),
                   ("mlp_bwd", "bwd", TRAIN_RAYS * SAMPLES))


def library_gemms(hidden, rows, kind):
    """``[(M, K, N, transposed)]``: the products of one call of ``kind``
    (``fwd``: B1, B3 and B1s; ``bwd``: B2) of a network of width ``hidden``
    at its kernel width on ``rows`` rows, as the wide plan launches them,
    each ``[M, K] @ [K, N]``; ``transposed``: A is the transpose of a
    stored ``[K, M]`` (a weight gradient's cotangent)."""
    from ddnerf_tpu_torch.kernels import fused_mlp as fk

    hp, ipe, dh = fk.kernel_width(hidden), fk.IPE_DIM, fk.DIR_HIDDEN
    if kind == "fwd":
        return ([(rows, ipe, hp, False)]
                + [(rows, ipe + hp if l == 5 else hp, hp, False)
                   for l in range(1, 9)]
                + [(rows, hp, fk.DIR_LAYER_ROWS, False),
                   (rows, dh, fk.HEAD_ROWS, False)])
    chain = ([(rows, fk.HEAD_ROWS, dh, False), (rows, dh + 1, hp, False)]
             + [(rows, hp, hp, False)] * 8)
    wgrad = ([(hp, rows, ipe, True)]
             + [(hp, rows, n, True) for i in range(1, 8)
                for n in ((ipe, hp) if i == 5 else (hp,))]
             + [(hp, rows, hp, True), (dh, rows, hp, True), (1, rows, hp, True),
                (fk.HEAD_ROWS, rows, dh, True)])
    return chain + wgrad


def library_ms(torch, hidden, f32, plan, reps=TIMING_REPS):
    """``{kernel: ms}`` for the four kernels of ``plan`` (``fused`` or
    ``wide``, the launch-count names' prefix) at width ``hidden``: the
    CUDA-event median over ``reps`` of :func:`library_gemms`' products of
    each on the main paths' shapes (B1 and B3 on a render chunk, B1s and
    B2 on a training batch, :data:`LIBRARY_KERNELS`), random operands made
    on the card."""
    dev = torch.device("cuda")
    cdt = torch.float32 if f32 else torch.bfloat16
    sfx = "_f32" if f32 else ""
    gen = torch.Generator(device=dev).manual_seed(5)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for base, kind, rows in LIBRARY_KERNELS:
            made = {}  # operands of one shape are made once

            def operand(shape):
                if shape not in made:
                    made[shape] = torch.randn(shape, generator=gen,
                                              device=dev).to(cdt)
                return made[shape]

            ops = [(operand((k, m)).t() if trans else operand((m, k)),
                    operand((k, n)))
                   for m, k, n, trans in library_gemms(hidden, rows, kind)]

            def run(ops=ops):
                for a, b in ops:
                    if f32:
                        torch.mm(a, b)
                    else:
                        torch.mm(a, b, out_dtype=torch.float32)
            out[f"{plan}_{base}{sfx}"] = _event_ms(torch, run, reps)
            del ops, made
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def phase_microbatch(torch):
    """Phase 19 (c): :data:`MB_OPTS` captured against eager, bitwise, over
    :data:`MB_GRAPH_STEPS` steps at bf16 and at float32 (8 B1s + 8 B2 per
    step), and the captured run's peak device memory against the captured
    monolithic 8192-ray step's, which must be higher.  Returns {tag:
    (microbatched, monolithic)} of :func:`phase_graph_vs_eager`'s
    results."""
    out = {}
    for tag, dtype_opts in (("mb", ()), ("mb-f32", F32_OPTS)):
        mb = phase_graph_vs_eager(torch, tag, (*MB_OPTS, *dtype_opts),
                                  MB_GRAPH_STEPS)
        whole = phase_graph_vs_eager(torch, f"{tag}-whole",
                                     (*MB_WHOLE_OPTS, *dtype_opts),
                                     MB_GRAPH_STEPS)
        print(f"[{tag}] 8192 rays a step: captured in 4 microbatches of "
              f"2048 {mb['graph']:.2f} ms/step (eager {mb['eager']:.2f}), "
              f"peak device memory {mb['peak_gib']:.2f} GiB; captured whole "
              f"{whole['graph']:.2f} ms/step, peak {whole['peak_gib']:.2f} "
              f"GiB", flush=True)
        if not mb["peak_gib"] < whole["peak_gib"]:
            fail(f"{tag}: the microbatched step's peak memory is not below "
                 f"the monolithic step's")
        out[tag] = (mb, whole)
    return out


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


def _sfx(cfg):
    """The launch-count suffix of the kernels a config runs: ``_f32`` at
    ``parallel.compute_dtype: float32``."""
    return "_f32" if cfg.parallel.compute_dtype == "float32" else ""


def _kn(cfg, base, times=1):
    """The launches of kernel ``base`` (a fused plan's, e.g.
    ``fused_mlp_fwd``) when ``cfg``'s two network evaluations (DDNeRF's
    coarse and fine nets; mip-NeRF's one net, twice) each launch it
    ``times`` times: {launch-count name: launches}, each evaluation under
    the name of its network's plan (``wide_*`` above the fused plans'
    widths) with ``_f32`` appended at float32."""
    from ddnerf_tpu_torch.kernels import fused_mlp as fk

    fine = (cfg.nerf.fine_hidden_size if cfg.is_ddnerf()
            else cfg.nerf.coarse_hidden_size)
    out = {}
    for hidden in (cfg.nerf.coarse_hidden_size, fine):
        name = ("wide_" + base[len("fused_"):] if fk.is_wide(hidden)
                else base) + _sfx(cfg)
        out[name] = out.get(name, 0) + times
    return out


def _enc(cfg, times=1):
    """The encode kernel's launches (``kernels/encode.py``) when ``cfg``'s
    two network evaluations each take ``times`` calls through a kernel fed
    IPE rows (the training kernels, or ``render_kernel_variant: mlp``):
    {launch-count name: launches}, one name for every width."""
    return {"ipe_encode" + _sfx(cfg): 2 * times}


def _only_dtype(launches, sfx, tag):
    """Fail if a run launched a kernel of the other compute dtype."""
    other = {k: v for k, v in launches.items()
             if v and k.endswith("_f32") != (sfx == "_f32")}
    if other:
        fail(f"{tag}: the run launched kernels of the other compute dtype: "
             f"{other}")


def check_events(logdir, tag):
    """The TensorBoard events a training run wrote into ``logdir``, read
    back with the port's reader (which checks both CRCs of every record):
    a ``train/loss`` scalar at each iteration ``metrics.jsonl`` records and,
    from validation, images and (DDNeRF) the mu / sigma histograms.  A
    missing or corrupt file fails the run.  Returns the counts."""
    from ddnerf_tpu_torch.viz.tfevents import read_events

    paths = sorted(glob.glob(os.path.join(logdir, "events.out.tfevents.*")))
    if not paths:
        fail(f"{tag}: no TensorBoard events file in {logdir}")
    values = []
    for path in paths:
        try:
            events = read_events(path)
        except (ValueError, IndexError, struct.error) as e:
            fail(f"{tag}: {path} does not read back: {e}")
        if events[0].get("file_version") != "brain.Event:2":
            fail(f"{tag}: {path} does not start with a file_version event")
        values += [(e["step"], v) for e in events for v in e["values"]]
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    want = [r["step"] for r in records if r["kind"] == "train"]
    loss = {s: v["value"] for s, v in values if v["tag"] == "train/loss"}
    got = sorted(loss)
    bad = [r["step"] for r in records if r["kind"] == "train"
           and r["step"] in loss and abs(loss[r["step"]] - r["loss"]) > 1e-6 *
           max(1.0, abs(r["loss"]))]
    if got != want or bad:
        fail(f"{tag}: train/loss scalars at {len(got)} steps ({bad[:3]} "
             f"disagree with metrics.jsonl), metrics.jsonl records {len(want)}")
    images = [v for _, v in values if v["kind"] == "image"]
    hists = [v for _, v in values if v["kind"] == "histogram"]
    is_dd = any(r["kind"] == "validation" and "dp_loss" in r for r in records)
    if not images or (is_dd and not hists):
        fail(f"{tag}: validation wrote {len(images)} images and "
             f"{len(hists)} histograms to the events")
    summary = {"files": len(paths), "train_steps": got,
               "images": len(images), "histograms": len(hists)}
    print(f"[{tag}] events: {len(paths)} file(s), train/loss at "
          f"{len(got)} steps (as metrics.jsonl), {len(images)} images, "
          f"{len(hists)} histograms", flush=True)
    return summary


def phase_train_main_path(logroot, tag="train", opts=(), run="synthetic_smoke",
                          iters=TRAIN_ITERS):
    """The training CLI at full width (``opts``: config overrides) for
    ``iters`` iterations; returns (logdir, launch counts)."""
    from ddnerf_tpu_torch.train.checkpoint import load_config_snapshot

    cmd = [sys.executable, "-m", "ddnerf_tpu_torch.cli.train", "--config",
           CONFIG, "--max-iters", str(iters),
           "experiment.logdir", logroot, "experiment.id", run, *opts]
    out, launches, wall = _cli(cmd, tag)
    logdir = os.path.join(logroot, run)
    _check_train_output(out, tag)
    if not re.search(r"^step mode: graph .*blocks of up to \d+", out, re.M):
        fail(f"{tag}: the CLI did not say that it runs the captured step in "
             f"blocks")
    for name in ("config.yml", "metrics.jsonl", f"checkpoint_{iters}.ckpt"):
        if not os.path.isfile(os.path.join(logdir, name)):
            fail(f"{tag}: training wrote no {name} in {logdir}")
    snapshot = load_config_snapshot(logdir)
    is_dd, sfx = snapshot.is_ddnerf(), _sfx(snapshot)
    if is_dd != bool(re.search(r"^\[VAL\] .* dp_loss \S+$", out, re.M)):
        fail(f"{tag}: the [VAL] line must carry dp_loss for DDNeRF only")
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    records = [r for r in records if r["kind"] == "train"]
    losses = [r["loss"] for r in records]
    if len(losses) != iters or not all(map(math.isfinite, losses)):
        fail(f"{tag}: metrics.jsonl holds {len(losses)} finite train losses, "
             f"expected {iters}")
    if is_dd != ("dp_loss" in records[0]):
        fail(f"{tag}: the train records must carry dp_loss for DDNeRF only")
    check_events(logdir, tag)
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
    want = {**_kn(snapshot, "fused_mlp_fwd_stash", iters),
            **_kn(snapshot, "fused_mlp_bwd", iters)}
    for name, count in want.items():
        if launches.get(name) != count:
            fail(f"{tag}: training launched {name} {launches.get(name)} "
                 f"times, expected {count} (two network evaluations per "
                 f"step)")
    _only_dtype(launches, sfx, tag)
    return logdir, launches


def phase_graph_vs_eager(torch, tag="graph", opts=(), steps=GRAPH_STEPS):
    """The captured step against the eager step from one seed for
    ``steps`` iterations (``opts``: config overrides): every metric of every
    iteration, the parameters, Adam's state and the generator's state must
    be bitwise equal, and each step must launch 2 B1s + 2 B2 per
    microbatch; returns both ms/step (steady state, no metric read) and the
    captured run's peak device memory (``peak_gib``)."""
    from ddnerf_tpu_torch.config import load_config
    from ddnerf_tpu_torch.data.datasets import load_train_store
    from ddnerf_tpu_torch.kernels.fused_mlp import LAUNCHES
    from ddnerf_tpu_torch.models.nerf import NerfPipeline
    from ddnerf_tpu_torch.train.state import TrainState
    from ddnerf_tpu_torch.train.step import (
        CapturedTrainStep,
        EagerTrainStep,
        _microbatches,
    )

    dev = torch.device("cuda")
    cfg = load_config(CONFIG)
    if opts:
        cfg = cfg.merge_from_list(list(opts)).resolved()
    store, _, cfg = load_train_store(cfg, dev)
    per_step = 2 * _microbatches(cfg, cfg.nerf.train.num_random_rays)
    head = 8  # the warm-up iterations and the capture lie in these
    runs, step_ms = {}, {}
    for mode in ("eager", "graph"):
        torch.cuda.reset_peak_memory_stats()
        pipe = NerfPipeline(cfg, dev, seed=0)
        state = TrainState(cfg, pipe)
        gen = torch.Generator(device=dev).manual_seed(11)
        if mode == "graph":
            stepper = CapturedTrainStep(cfg, pipe, state, store, gen,
                                        max_block=steps)
        else:
            stepper = EagerTrainStep.from_store(cfg, pipe, state, store, gen)
        before = dict(LAUNCHES)
        rows = [stepper.run(head).clone()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows.append(stepper.run(steps - head).clone())
        torch.cuda.synchronize()
        step_ms[mode] = (time.perf_counter() - t0) * 1e3 / (steps - head)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        launched = {k: LAUNCHES[k] - before[k] for k in before
                    if LAUNCHES[k] != before[k]}
        per_net = per_step // 2 * steps
        if launched != {**_kn(cfg, "fused_mlp_fwd_stash", per_net),
                        **_kn(cfg, "fused_mlp_bwd", per_net),
                        **_enc(cfg, per_net)}:
            fail(f"{tag}: {steps} {mode} steps counted {launched}, expected "
                 f"{per_step} of each training kernel per step")
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
    print(f"[{tag}] {steps} iterations, captured vs eager: "
          f"{len(names)} metrics per iteration, {len(tensors_e)} state "
          f"tensors: {'bitwise equal' if not differ else differ}; loss "
          f"{loss[0].item():.5f} -> {loss[-1].item():.5f}; eager "
          f"{step_ms['eager']:.2f} ms/step, captured {step_ms['graph']:.2f} "
          f"ms/step (iterations {head}-{steps - 1}); {per_step // 2} "
          f"microbatch(es) per step; the captured run's peak device memory "
          f"{peak_gib:.2f} GiB", flush=True)
    if differ:
        fail(f"{tag}: the captured step differs from the eager step: "
             f"{differ}")
    step_ms["peak_gib"] = peak_gib
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
    # The profiled steps are steps too, twice over: N without the profiler,
    # then N under it (cli/train.py --profile-steps).
    steps = PROFILE_ITERS + 2 * PROFILE_STEPS
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
    from ddnerf_tpu_torch.train.checkpoint import load_config_snapshot

    snapshot = load_config_snapshot(logdir)
    sfx, b1 = _sfx(snapshot), _kn(snapshot, "fused_mlp_fwd")
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
    idle = [name for name in b1 if launches.get(name, 0) <= 0]
    if idle:
        fail(f"{tag}: the eval render did not launch {idle}")
    _only_dtype(launches, sfx, tag)
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
    per_net = chunks * frames_wanted  # each network once per chunk
    sfx = _sfx(cfg)
    runs = {}
    b1 = {**_kn(cfg, "fused_mlp_fwd", per_net), **_enc(cfg, per_net)}
    b3 = _kn(cfg, "fused_enc_mlp_fwd", per_net)
    for variant, path, kernel, other in (("ipe2", sibling, b3, b1),
                                         ("mlp", logdir, b1, b3)):
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
        got = {name: launches.get(name) for name in {**kernel, **other}}
        if got != {**dict.fromkeys(other, 0), **kernel}:
            fail(f"video ({variant}) launched {got}, expected {kernel} and "
                 f"none of the other forward")
        _only_dtype(launches, sfx, f"{tag}-{variant}")
        runs[variant] = (frames, launches)
    diff = np.abs(runs["ipe2"][0].astype(int) - runs["mlp"][0].astype(int))
    print(f"[{tag}] ipe2 vs mlp frames: max {diff.max()} uint8 levels, "
          f"{(diff.max(-1) > 0).mean():.2e} of the pixels differ", flush=True)
    return _sum_launches(runs["ipe2"][1], runs["mlp"][1])


def phase_train_parity(torch, tag="parity", opts=(), config=CONFIG,
                       runs=(("kernel", "auto", None), ("plain", "off", None)),
                       gate=PARITY_GAP_TOL):
    """Kernel vs plain training from one seed on the same batches
    (``opts``: overrides of ``config``); ``runs``: two (name,
    ``parallel.pallas_mlp``, a function in place of the backward kernel or
    None) whose loss gap is held to ``gate`` (None: printed only)."""
    from ddnerf_tpu_torch.config import load_config
    from ddnerf_tpu_torch.data.datasets import (
        load_train_store,
        sample_rays_on_device,
    )
    from ddnerf_tpu_torch.kernels import fused_mlp as fk
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
    kernel_backward = fk.fused_mlp_backward
    for name, policy, backward in runs:
        c = cfg.replace_at("parallel.pallas_mlp", policy)
        pipe = NerfPipeline(c, dev, seed=0)
        state = TrainState(c, pipe)
        gen = torch.Generator(device=dev).manual_seed(11)
        traj, marks = [], {}
        fk.fused_mlp_backward = backward or kernel_backward
        try:
            for i, batch in enumerate(batches):
                if i == 5:  # steady state: after the first steps' set-up
                    torch.cuda.synchronize()
                    marks["t0"] = time.perf_counter()
                traj.append(train_step(c, pipe, state, batch, gen)["loss"])
            torch.cuda.synchronize()
        finally:
            fk.fused_mlp_backward = kernel_backward
        step_ms[name] = (time.perf_counter() - marks["t0"]) * 1e3 / (
            PARITY_STEPS - 5)
        losses[name] = [float(v) for v in traj]
    first, second = (name for name, _, _ in runs)
    gap = max(abs(a - b) / abs(b)
              for a, b in zip(losses[first], losses[second]))
    rays = cfg.nerf.train.num_random_rays
    for name in losses:
        print(f"[{tag}] {name} losses: "
              + " ".join(f"{v:.5f}" for v in losses[name]))
        print(f"[{tag}] {name}: {step_ms[name]:.2f} ms/step steady state "
              f"(steps 5-{PARITY_STEPS - 1}), "
              f"{rays / step_ms[name] * 1e3:,.0f} rays/s", flush=True)
    print(f"[{tag}] largest relative loss gap {first} vs {second} "
          f"{gap:.3e} ({'not held' if gate is None else f'gate {gate:g}'})",
          flush=True)
    if not all(math.isfinite(v) for v in losses[first] + losses[second]) or \
            (gate is not None and not gap <= gate):
        fail(f"{tag}: {first} and {second} training trajectories disagree")
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
    paths = {"kernel": ("auto", "mlp", {**_kn(cfg, "fused_mlp_fwd", chunks),
                                        **_enc(cfg, chunks)}),
             "ipe2": ("auto", "ipe2", _kn(cfg, "fused_enc_mlp_fwd", chunks)),
             "plain": ("off", "mlp", {})}
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
        want = paths[name][2]
        launched = {k: v for k, v in LAUNCHES.items() if v}
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
    if launched_k != {"fused_mlp_fwd_stash": 2, "fused_mlp_bwd": 2,
                      "ipe_encode": 2} or \
            launched_p != {"fused_mlp_fwd_stash": 2, "ipe_encode": 2}:
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


def _frame_vs_plain(cfg, tag, what, logdir=None):
    """A frame of the path's first render pose (its validation image's
    size) from seeded weights, through both forward kernels and the plain
    version: each kernel frame within ``FRAME_PSNR_MIN`` of the plain one,
    and each render launching its kernel alone, twice.  With ``logdir``,
    the weights of that run's newest checkpoint, and its first validation
    image (what eval renders) besides that video frame."""
    import torch

    from ddnerf_tpu_torch.data.assembly import get_datasets
    from ddnerf_tpu_torch.eval.evaluate import load_pipeline
    from ddnerf_tpu_torch.kernels.fused_mlp import LAUNCHES
    from ddnerf_tpu_torch.models.nerf import NerfPipeline, ScheduleValues
    from ddnerf_tpu_torch.render.renderer import ImageRenderer

    _, val_ds, cfg = get_datasets(cfg)
    views = {"video frame": val_ds.render_poses[0]}
    if logdir is not None:
        views["eval image"] = val_ds.poses[0]
    rgbs = {view: {} for view in views}
    for name, policy, variant, kernel in (
            ("plain", "off", "mlp", {}),
            ("kernel", "auto", "mlp", {**_kn(cfg, "fused_mlp_fwd"),
                                       **_enc(cfg)}),
            ("ipe2", "auto", "ipe2", _kn(cfg, "fused_enc_mlp_fwd"))):
        c = cfg.replace_at("parallel.pallas_mlp", policy).replace_at(
            "parallel.render_kernel_variant", variant)
        pipe = (NerfPipeline(c, "cuda", seed=0) if logdir is None else
                load_pipeline(logdir, c, torch.device("cuda")))
        renderer = ImageRenderer(c, pipe)
        sched = None if logdir is None else ScheduleValues.for_eval(c)
        for view, pose in views.items():
            for key in LAUNCHES:
                LAUNCHES[key] = 0
            rgbs[view][name] = renderer.render_image_from_pose(
                pose, val_ds.H, val_ds.W, val_ds.focal, sched=sched)[1]["rgb"]
            launched = {k: v for k, v in LAUNCHES.items() if v}
            if launched != kernel:
                fail(f"{tag}: the {name} {view} launched {launched}")
    for view in views:
        for name in ("kernel", "ipe2"):
            got, want = rgbs[view][name], rgbs[view]["plain"]
            mse = float(np.mean((got - want) ** 2))
            frame_psnr = float("inf") if mse == 0 else -10.0 * math.log10(mse)
            print(f"[{tag}] {val_ds.H} x {val_ds.W} {what} {view} rgb PSNR "
                  f"{name} vs plain {frame_psnr:.2f} dB (gate "
                  f"{FRAME_PSNR_MIN:g})", flush=True)
            if not (frame_psnr >= FRAME_PSNR_MIN and np.isfinite(got).all()):
                fail(f"{tag}: the {name} {view} disagrees with the plain "
                     f"version")


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
    runs.append(phase_ndc_mipnerf(logroot, scene))
    return _sum_launches(*runs), ("dataset.basedir", scene)


def phase_ndc_mipnerf(logroot, scene):
    """``configs/ff_mipnerf.yml`` (mip-NeRF under NDC: one shared net, the
    plain resampler between its cycles) through the three CLIs on the NDC
    scene: :data:`NDC_MIP_ITERS` captured iterations (B1s and B2 twice an
    iteration, on the one net), eval of one image, a video frame through B1
    and one through B3, and a frame of seeded weights kernel vs plain;
    returns the launch counts of its runs, summed."""
    from ddnerf_tpu_torch.config import load_config

    tag, run, iters = "ndc-mip", "ndc_mip_smoke", NDC_MIP_ITERS
    cfg = load_config(FF_MIP_CONFIG).merge_from_list(
        ["dataset.basedir", scene]).resolved()
    if cfg.is_ddnerf() or not cfg.dataset.ndc_rays:
        fail(f"{FF_MIP_CONFIG} is not mip-NeRF under NDC")
    cmd = [sys.executable, "-m", "ddnerf_tpu_torch.cli.train", "--config",
           FF_MIP_CONFIG, "--max-iters", str(iters), "dataset.basedir",
           scene, "experiment.logdir", logroot, "experiment.id", run,
           "experiment.validate_every", str(iters // 2),
           "experiment.save_every", str(iters),
           "experiment.print_every", "10"]
    out, launches, wall = _cli(cmd, f"{tag}-train")
    _check_train_output(out, f"{tag}-train")
    if not re.search(r"^step mode: graph ", out, re.M):
        fail(f"{tag}: the CLI did not run the captured step")
    print(f"[{tag}] {iters} iterations, wall {wall:.1f} s, launches "
          f"{launches}", flush=True)
    # One net evaluated in both cycles: B1s and B2 twice an iteration.
    for base in ("fused_mlp_fwd_stash", "fused_mlp_bwd"):
        want = _kn(cfg, base, iters)
        if {k: launches.get(k) for k in want} != want:
            fail(f"{tag}: training launched {launches}, expected {want} of "
                 f"{base}")
    if launches.get("fused_mlp_fwd", 0) <= 0:
        fail(f"{tag}: validation did not launch fused_mlp_fwd")
    logdir = os.path.join(logroot, run)
    runs = [launches, phase_main_path(logdir, f"{tag}-eval", images=1),
            phase_video_main_path(logdir, f"{tag}-video", 1, NDC_HW, iters)]
    _frame_vs_plain(cfg, f"{tag}-frame", "NDC mip-NeRF")
    return _sum_launches(*runs)


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
# Phase 20, kernel against plain quality at other widths: the blender
# rehearsal (its scene, schedule and gate) with the kernels and with the
# plain MLP (--plain, pallas_mlp off) at coarse-192 / fine-512 (the fused
# plans, 512 on the N-split plan), and with the kernels at coarse-600 /
# fine-1024 (the wide plan).  A kernel run and the plain run at its widths
# must read psnr_fine within QUALITY_GAP_DB (ROADMAP A8's gap).  The plain
# runs at 256 / 256 and 600 / 1024 take 120 s and 434 s on the card, so
# their readings are recorded here, from scripts/dress_rehearsal_torch.sh
# --plain [--widths 600 1024] on one NVIDIA H100 80GB HBM3 at 700 W
# (20.82 and 28.0, beside the kernel runs' 20.81 and 28.0 in that call).
WIDTH_REHEARSALS = {
    "rehearsal-192x512": ("--widths", "192", "512"),
    "rehearsal-192x512-plain": ("--widths", "192", "512", "--plain"),
    "rehearsal-600x1024": ("--widths", "600", "1024"),
}
WIDTH_PAIRS = (("rehearsal-192x512", "rehearsal-192x512-plain"),)
PLAIN_PSNR_RECORDED = {"rehearsal-blender": 20.82,
                       "rehearsal-600x1024": 28.0}
QUALITY_GAP_DB = 0.5
# Phase 21, kernel against plain quality where no card run held it: the
# rehearsal in float32 (blender, the fused float32 kernels, its gate 19.0),
# mip-NeRF under NDC (configs/ff_mipnerf.yml) and real-360
# (configs/real360_dd.yml), each at the default shape with the kernels,
# held within QUALITY_GAP_DB of its plain run's reading, taken once with
# --plain in the same flags on one NVIDIA H100 80GB HBM3 at 700 W (20.82,
# 29.67 and 15.39, beside the kernel runs' 20.81, 29.71 and 15.40 in that
# call; the script gates the last two 2 dB under that reading).
# tag -> (flags, psnr_fine gate, recorded plain reading).
QUALITY_REHEARSALS = {
    "rehearsal-f32": (("--f32",), 19.0, 20.82),
    "rehearsal-llff-mipnerf": (("--llff", "--mipnerf"), 27.67,
                               29.67),
    "rehearsal-real360": (("--real360",), 13.39, 15.39),
}


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


def _rehearsal_cmd(flags):
    return ["bash", os.path.join(REPO, "scripts", "dress_rehearsal_torch.sh"),
            *flags]


def phase_rehearsal(logroot, tag):
    """``scripts/dress_rehearsal_torch.sh`` at its default shape
    (:data:`REHEARSALS`), checked by :func:`_rehearsal_result` -> (the
    launch counts of its CLIs, summed; psnr_fine)."""
    flags, gate, iters = REHEARSALS[tag]
    out, _, wall = _subprocess(
        _rehearsal_cmd(flags), tag, timeout=600,
        env={"DRESS_WORKDIR": os.path.join(logroot, tag)})
    return _rehearsal_result(out, wall, tag, flags, gate, iters)


def _rehearsal_result(out, wall, tag, flags, gate, iters):
    """The output of a rehearsal run with ``flags``: the dataset writer,
    the three CLIs and the script's own PSNR gate ``gate``, held here too,
    then the launches of training: with the kernels B1s and B2 once an
    iteration for each network under its plan, with ``--plain`` no kernel
    at all -> (the launch counts of its CLIs, summed; psnr_fine)."""
    from ddnerf_tpu_torch.kernels import fused_mlp as fk

    counts = [json.loads(m) for m in re.findall(
        r"^kernel launches: (\{.*\})$", out, re.M)]
    launches = _sum_launches(*counts)
    summary = re.search(r"^eval psnr_fine=(\S+) ssim_v1_fine=(\S+) "
                        r"ssim_v2_fine=(\S+) .* loop (\S+) ms/step; wall "
                        r"train (\S+) s, eval (\S+) s, video (\S+) s$",
                        out, re.M)
    if not summary or "DRESS REHEARSAL PASSED" not in out or len(counts) != 3:
        fail(f"{tag}: the rehearsal printed no summary, not each CLI's "
             f"launches, or did not pass")
    psnr = float(summary.group(1))
    print(f"[{tag}] psnr_fine {psnr} (gate {gate}), ssim_v1_fine "
          f"{summary.group(2)}, ssim_v2_fine {summary.group(3)}; loop "
          f"{summary.group(4)} ms/step; CLI walls train {summary.group(5)} "
          f"s, eval {summary.group(6)} s, video {summary.group(7)} s; whole "
          f"script {wall:.1f} s; launches {launches}", flush=True)
    if not psnr >= gate:
        fail(f"{tag}: psnr_fine {psnr} below the gate {gate}")
    if "--plain" in flags:
        if any(launches.values()):
            fail(f"{tag}: the plain run launched kernels: {launches}")
        return launches, psnr
    widths = (256, 256)  # the config's (mip-NeRF: one net, twice a step)
    if "--widths" in flags:
        i = flags.index("--widths")
        widths = (int(flags[i + 1]), int(flags[i + 2]))
    sfx = "_f32" if "--f32" in flags else ""
    expected = {}  # each network's B1s and B2 once a step, under its plan
    for hidden in widths:
        for base in ("mlp_fwd_stash", "mlp_bwd"):
            name = ("wide_" if fk.is_wide(hidden) else "fused_") + base + sfx
            expected[name] = expected.get(name, 0) + iters
    for name, n in expected.items():
        if launches.get(name) != n:
            fail(f"{tag}: launched {name} {launches.get(name)} times, "
                 f"expected {n}")
    return launches, psnr


def phase_width_quality(logroot, psnr_256):
    """Phase 20: the runs of :data:`WIDTH_REHEARSALS`, one after another,
    on phase 16's blender scene, each under the blender gate
    (:func:`_rehearsal_result`); each pair of :data:`WIDTH_PAIRS`, and each
    kernel run against its plain run's recorded reading
    (:data:`PLAIN_PSNR_RECORDED`; ``psnr_256``: phase 16's kernel run at
    256 / 256), within :data:`QUALITY_GAP_DB` -> the kernel runs' launch
    counts by run."""
    _, gate, iters = REHEARSALS["rehearsal-blender"]
    env = {"DRESS_WORKDIR": os.path.join(logroot, "rehearsal-blender")}
    psnr, kernel_runs = {"rehearsal-blender": psnr_256}, {}
    for tag, flags in WIDTH_REHEARSALS.items():
        out, _, wall = _subprocess(_rehearsal_cmd(flags), tag, timeout=900,
                                   env=env)
        launches, psnr[tag] = _rehearsal_result(out, wall, tag, flags, gate,
                                                iters)
        if "--plain" not in flags:
            kernel_runs[tag] = launches
    pairs = [(kernel, plain, psnr[plain]) for kernel, plain in WIDTH_PAIRS]
    pairs += [(kernel, "its plain run (recorded)", value)
              for kernel, value in PLAIN_PSNR_RECORDED.items()]
    for kernel, plain, value in pairs:
        gap = psnr[kernel] - value
        print(f"[quality] {kernel} psnr_fine {psnr[kernel]} against {plain} "
              f"{value}: kernel - plain {gap:+.3f} dB (limit "
              f"{QUALITY_GAP_DB})", flush=True)
        if not abs(gap) <= QUALITY_GAP_DB:
            fail(f"{kernel} and {plain} differ by {gap:+.3f} dB")
    return kernel_runs


def phase_quality_rehearsals(logroot):
    """Phase 21: the runs of :data:`QUALITY_REHEARSALS`, one after another
    (each after the last one's process has given the card back), each under
    its gate and within :data:`QUALITY_GAP_DB` of its recorded plain
    reading -> the runs' launch counts by run."""
    launches = {}
    for tag, (flags, gate, plain) in QUALITY_REHEARSALS.items():
        out, _, wall = _subprocess(
            _rehearsal_cmd(flags), tag, timeout=600,
            env={"DRESS_WORKDIR": os.path.join(logroot, tag)})
        launches[tag], psnr = _rehearsal_result(
            out, wall, tag, flags, gate, REHEARSALS["rehearsal-blender"][2])
        gap = psnr - plain
        print(f"[quality] {tag} psnr_fine {psnr} against its plain run "
              f"(recorded) {plain}: kernel - plain {gap:+.3f} dB (limit "
              f"{QUALITY_GAP_DB})", flush=True)
        if not abs(gap) <= QUALITY_GAP_DB:
            fail(f"{tag} and its plain run differ by {gap:+.3f} dB")
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
                "fused_mlp_bwd": 2 * GLOO_ITERS,
                "ipe_encode": 2 * GLOO_ITERS}
        for what in ("steps_False", "steps_True"):
            if res[what]["launches"] != want:
                fail(f"{tag}: rank {r} launched {res[what]['launches']} in "
                     f"{GLOO_ITERS} steps ({what}), expected {want}")
        # Validation encodes once per forward launch besides the steps.
        loop = {k: v for k, v in res["loop"].items() if k != "fused_mlp_fwd"}
        loop["ipe_encode"] = loop.get("ipe_encode", 0) - res["loop"].get(
            "fused_mlp_fwd", 0)
        if loop != want:
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
    want = {"eval": {"fused_mlp_fwd": 2 * c_mip * 2,
                     "ipe_encode": 2 * c_mip * 2},
            "mlp": {"fused_mlp_fwd": 2 * c_mlp * frames,
                    "ipe_encode": 2 * c_mlp * frames},
            "ipe2": {"fused_enc_mlp_fwd": 2 * c_mlp * frames},
            "ndc": {"fused_mlp_fwd": 2 * c_ndc, "ipe_encode": 2 * c_ndc}}
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
    start_fault_build()
    phase_build()
    max_err, timing = phase_kernel(torch)
    enc_err, enc_timing = phase_enc_kernel(torch)
    encode_err, encode_timing = phase_encode_kernel(torch)
    fused_library = phase_fused_library(torch)
    train_err, train_timing = phase_train_kernels(torch)
    width_err = phase_widths(torch)
    f32_err, f32_times = phase_f32_kernels(torch)
    wide_plan_err, wide_plan_times = phase_wide_plan(torch)
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
        if {k: v for k, v in mip_eval.items() if v} != {
                "fused_mlp_fwd": 2 * chunks * 2, "ipe_encode": 2 * chunks * 2}:
            fail(f"mip-NeRF eval launched {mip_eval}, expected "
                 f"{2 * chunks * 2} of fused_mlp_fwd and ipe_encode only")
        mip_video = phase_video_main_path(mip_logdir, "mip-video")
        ndc_launches, ndc_scene = phase_ndc_main_path(logroot)
        # The training kernels against plain on that path's own batches.
        ndc_step_ms = phase_train_parity(torch, "ndc-parity", ndc_scene,
                                         FF_CONFIG)
        phase_step_gradients(torch, "ndc-grads", ndc_scene, FF_CONFIG)
        real360_launches = phase_real360_main_path(logroot)
        wide_launches = phase_cli_path(logroot, "wide", WIDE_TRAIN_OPTS,
                                       WIDE_ITERS, "coarse-192 / fine-512")
        f32_launches = phase_cli_path(logroot, "f32", F32_TRAIN_OPTS,
                                      F32_ITERS, "float32")
        big_launches = phase_cli_path(logroot, "big", BIG_TRAIN_OPTS,
                                      BIG_ITERS, "coarse-600 / fine-1024")
        big_f32_launches = phase_cli_path(
            logroot, "big-f32", (*BIG_TRAIN_OPTS, *F32_OPTS), BIG_ITERS,
            "coarse-600 / fine-1024 float32")
        mixed_launches = phase_cli_path(logroot, "mixed", MIXED_OPTS,
                                        BIG_ITERS, "coarse-256 / fine-1024")
        _close_cli_worker()
        # The rehearsals are processes of their own: this process's cached
        # blocks go back to the card first.
        torch.cuda.empty_cache()
        rehearsals = {tag: phase_rehearsal(logroot, tag)
                      for tag in REHEARSALS}
        rehearsal_launches = {tag: r[0] for tag, r in rehearsals.items()}
        width_launches = phase_width_quality(
            logroot, rehearsals["rehearsal-blender"][1])
        quality_launches = phase_quality_rehearsals(logroot)
        # Data parallelism: torchrun launches on this one card.
        nccl_launches, nccl_ms = phase_nccl_one_rank(logroot, logdir)
        render_launches, lpips_weights, eval_dir = phase_render_two_ranks(
            logroot, logdir, mip_logdir, os.path.join(logroot, "ndc_smoke"))
        phase_lpips_on_card(torch, lpips_weights, eval_dir)
        gloo_launches, gloo_ms = phase_gloo_two_ranks(torch, logroot)
    graph_ms = phase_graph_vs_eager(torch)
    mip_graph_ms = phase_graph_vs_eager(torch, "mip-graph", MIPNERF)
    wide_graph_ms = phase_graph_vs_eager(torch, "wide-graph", WIDE_OPTS,
                                         WIDE_GRAPH_STEPS)
    wide_step_ms = phase_train_parity(torch, "wide-parity", WIDE_OPTS)
    f32_graph_ms = phase_graph_vs_eager(torch, "f32-graph", F32_OPTS,
                                        F32_GRAPH_STEPS)
    f32_step_ms = phase_train_parity(torch, "f32-parity", F32_OPTS)
    # The float32 stash and workspace of a coarse-192 / fine-512 pair in the
    # graph's pool.
    f32_wide_graph_ms = phase_graph_vs_eager(
        torch, "f32-wide-graph", (*F32_OPTS, *WIDE_OPTS), WIDE_GRAPH_STEPS)
    f32_frame_s = phase_frame(torch, "f32-frame", F32_OPTS)
    big_graph_ms = phase_graph_vs_eager(torch, "big-graph", BIG_OPTS,
                                        BIG_GRAPH_STEPS)
    big_step_ms = phase_train_parity(torch, "big-parity", BIG_OPTS)
    mixed_graph_ms = phase_graph_vs_eager(torch, "mixed-graph", MIXED_OPTS,
                                          BIG_GRAPH_STEPS)
    mixed_step_ms = phase_train_parity(torch, "mixed-parity", MIXED_OPTS)
    mb = phase_microbatch(torch)
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
          f"(mip-NeRF), {wide_graph_ms['graph']:.2f} vs "
          f"{wide_graph_ms['eager']:.2f} ms (coarse-192 / fine-512; its "
          f"train step kernel {wide_step_ms['kernel']:.2f} ms, plain "
          f"{wide_step_ms['plain']:.2f} ms); torchrun one rank on NCCL "
          f"{nccl_ms['nccl']:.2f} vs "
          f"one process {nccl_ms['single']:.2f} ms/step, two ranks on one "
          f"card under gloo {gloo_ms:.2f} ms/step; whole run "
          f"{time.perf_counter() - t_start:.1f} s")
    print(f"[f32-frame] 800x800 best of two: kernel (B1-f32) "
          f"{f32_frame_s['kernel']:.3f} s, ipe2 (B3-f32) "
          f"{f32_frame_s['ipe2']:.3f} s, plain {f32_frame_s['plain']:.3f} s; "
          f"float32 train step kernel {f32_step_ms['kernel']:.2f} ms, plain "
          f"{f32_step_ms['plain']:.2f} ms; captured vs eager "
          f"{f32_graph_ms['graph']:.2f} vs {f32_graph_ms['eager']:.2f} ms "
          f"(coarse-192 / fine-512: {f32_wide_graph_ms['graph']:.2f} vs "
          f"{f32_wide_graph_ms['eager']:.2f} ms)")
    print(f"[big] coarse-600 / fine-1024: captured vs eager "
          f"{big_graph_ms['graph']:.2f} vs {big_graph_ms['eager']:.2f} ms/step "
          f"(peak {big_graph_ms['peak_gib']:.2f} GiB); train step kernel "
          f"{big_step_ms['kernel']:.2f} ms, plain {big_step_ms['plain']:.2f} "
          f"ms; coarse-256 / fine-1024 captured vs eager "
          f"{mixed_graph_ms['graph']:.2f} vs {mixed_graph_ms['eager']:.2f} "
          f"ms/step (train step kernel {mixed_step_ms['kernel']:.2f} ms, "
          f"plain {mixed_step_ms['plain']:.2f} ms); microbatched 8192 rays (4 x 2048) captured "
          + ", ".join(f"{tag} {m['graph']:.2f} ms/step (eager "
                      f"{m['eager']:.2f}), peak {m['peak_gib']:.2f} GiB vs "
                      f"{w['peak_gib']:.2f} GiB whole ({w['graph']:.2f} "
                      f"ms/step)" for tag, (m, w) in mb.items())
          + f"; whole run {time.perf_counter() - t_start:.1f} s")
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
               "real360": real360_launches, "widths": wide_launches,
               "f32": f32_launches, "wide1024": big_launches,
               "wide1024-f32": big_f32_launches, "mixed": mixed_launches,
               **rehearsal_launches, **width_launches, **quality_launches}
    total = _sum_launches(*by_path.values())
    print("[launches] per main path: " + json.dumps(by_path, sort_keys=True))
    for path, counts in by_path.items():
        # The rehearsals film through B1 alone (their configs' variant);
        # the NDC path films mip-NeRF through B3 too.
        # The float32 paths run the float32 kernels, every other path the
        # bf16 ones; the coarse-600 / fine-1024 paths the wide plan's,
        # the coarse-256 / fine-1024 path both plans', every other path the
        # fused plans'.
        b1_only = (path in REHEARSALS or path in WIDTH_REHEARSALS
                   or path in QUALITY_REHEARSALS)
        f32 = path in ("f32", "wide1024-f32", "rehearsal-f32")
        plans = (("wide_", "fused_") if path == "mixed" else
                 ("wide_",) if path.startswith("wide1024")
                 or path == "rehearsal-600x1024" else ("fused_",))
        expected = [k for k in total
                    if k.endswith("_f32") == f32 and k.startswith(plans)
                    and not (b1_only and "enc_mlp_fwd" in k)]
        idle = [k for k in expected if counts.get(k, 0) <= 0]
        if idle:
            fail(f"the {path} main path never launched {idle}")
        # Every bf16 fused B2 reads its relu masks from B1s's bit words;
        # no float32 or wide one does.
        if counts.get("chain_mask_bits", 0) != counts.get("fused_mlp_bwd", 0):
            fail(f"the {path} main path counted chain_mask_bits "
                 f"{counts.get('chain_mask_bits', 0)} times, not as often "
                 f"as fused_mlp_bwd ({counts.get('fused_mlp_bwd', 0)})")
    print(f"[launches] chain_mask_bits {total.get('chain_mask_bits', 0)}, "
          f"fused_mlp_bwd {total.get('fused_mlp_bwd', 0)}: every bf16 fused "
          "B2 applied the bit-word masks", flush=True)

    ms, plain_ms = timing["DepthMipMLP"]
    coarse = train_timing["DepthMipMLP"]
    enc = enc_timing["DepthMipMLP"]
    bounds = kernel_bounds(256, CHUNK_RAYS * SAMPLES, CHUNK_RAYS,
                           TRAIN_RAYS * SAMPLES, TRAIN_RAYS)
    bounds.update(kernel_bounds(256, CHUNK_RAYS * SAMPLES, CHUNK_RAYS,
                                TRAIN_RAYS * SAMPLES, TRAIN_RAYS, f32=True))
    max_err = max(max_err, width_err["fused_mlp_fwd"])
    enc_err = max(enc_err, width_err["fused_enc_mlp_fwd"])
    for name in ("fused_mlp_fwd_stash", "fused_mlp_bwd"):
        train_err[name] = max(train_err[name], width_err[name])
    fwd_cu = "ddnerf_tpu_torch/kernels/csrc/fused_mlp_fwd.cu"
    # name, source, the TPU kernel, main-path launches, error, ms, plain ms,
    # library ms (phase 3c's yardstick)
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
    # The float32 instantiations of the same TPU kernels (phase 18's times
    # at width 256, DepthMipMLP).
    f32_cu = "ddnerf_tpu_torch/kernels/csrc/fused_mlp_f32.cu"
    for name, replaces in (
            ("fused_mlp_fwd_f32", "ddnerf_tpu/kernels/fused_mlp.py:464"),
            ("fused_mlp_fwd_stash_f32", "ddnerf_tpu/kernels/fused_mlp.py:464"),
            ("fused_mlp_bwd_f32", "ddnerf_tpu/kernels/fused_mlp_bwd.py:299"),
            ("fused_enc_mlp_fwd_f32", "ddnerf_tpu/kernels/fused_mlp.py:309")):
        rows.append((name, f32_cu, replaces, total[name], f32_err[name],
                     *f32_times[256][name]))
    rows = [(*row, fused_library[row[0]]) for row in rows]
    # The wide plan, both dtypes (phase 19's times at width 1024,
    # DepthMipMLP), with their library yardstick.
    wide_cu = "ddnerf_tpu_torch/kernels/csrc/fused_mlp_wide.cu"
    for f32 in (False, True):
        bounds.update(_wide_bounds(WIDE_TIMING_WIDTH, f32))
    for name in WIDE_NAMES:
        replaces = ("ddnerf_tpu/kernels/fused_mlp_bwd.py:299"
                    if "bwd" in name else "ddnerf_tpu/kernels/fused_mlp.py:309"
                    if "enc" in name else "ddnerf_tpu/kernels/fused_mlp.py:464")
        rows.append((name, wide_cu, replaces, total[name],
                     wide_plan_err[name], *wide_plan_times[name]))
    # The encode kernel (phase 3d's times on a render chunk), which
    # replaces the XLA fusion of the same operations: no TPU kernel, no
    # library product.
    bounds["ipe_encode"] = encode_bound_ms(CHUNK_RAYS, SAMPLES)
    rows.append(("ipe_encode", "ddnerf_tpu_torch/kernels/csrc/ipe_encode.cu",
                 "none (XLA's fusion of ddnerf_tpu/core/math.py:90 and :189)",
                 total["ipe_encode"], encode_err,
                 *encode_timing[CHUNK_RAYS * SAMPLES], None))
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": count, "max_abs_err": err, "ms": t, "plain_ms": plain_t,
        "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        "library_ms": lib_t,
    } for name, source, replaces, count, err, t, plain_t, lib_t in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
