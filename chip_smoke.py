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
   plain versions at this path's shapes and cotangents too.

The second-to-last line is the kernel table as JSON (each kernel's time
beside its plain version's and beside ``bound_ms``, the least time the card
could take for the same work, see :func:`_bound_ms`); the last line is
``{"ok": true, "device": {...}}``.  A kernel's ``launches`` there is the
sum over the main paths of phases 5, 5c, 5d, 6, 6b, 9 and 10, each counted
from 0 in its own process.  Without CUDA, or without the package
beside this file, the run exits non-zero and prints no result.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import pickle
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


def _subprocess(cmd, tag, timeout=900):
    """Run ``cmd`` from the repository root in a fresh process (its kernel
    launch counts start at 0), echo its stdout, fail on a non-zero exit."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"[{tag}] {line}")
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        fail(f"{' '.join(cmd[2:4])} exited {proc.returncode}")
    m = re.search(r"^kernel launches: (\{.*\})$", proc.stdout, re.M)
    return proc.stdout, (json.loads(m.group(1)) if m else {}), wall


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
    out, launches, wall = _subprocess(cmd, tag)
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
    out, launches, wall = _subprocess(cmd, tag)
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
    out, launches, wall = _subprocess(cmd, tag)
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
    _, launches, wall = _subprocess(cmd, tag)
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


def phase_video_main_path(logdir, tag="video"):
    """The video CLI on an ``ipe2`` sibling of the trained logdir and on
    the logdir itself (``mlp``); returns both runs' launch counts summed."""
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
    newest = f"checkpoint_{TRAIN_ITERS}.ckpt"
    os.symlink(os.path.join(logdir, newest), os.path.join(sibling, newest))
    h, w = VIDEO_HW
    chunks = -(-h * w // cfg.nerf.validation.chunksize)
    expected = 2 * chunks * VIDEO_FRAMES  # two networks per chunk
    runs = {}
    for variant, path, kernel, other in (
            ("ipe2", sibling, "fused_enc_mlp_fwd", "fused_mlp_fwd"),
            ("mlp", logdir, "fused_mlp_fwd", "fused_enc_mlp_fwd")):
        cmd = [sys.executable, "-m", "ddnerf_tpu_torch.cli.render_video",
               "--logdir", path, "--max-frames", str(VIDEO_FRAMES),
               "--save_images"]
        out, launches, wall = _subprocess(cmd, f"{tag}-{variant}")
        avi = os.path.join(path, "video", "video.avi")
        if not os.path.isfile(avi) or os.path.getsize(avi) == 0:
            fail(f"video ({variant}) wrote no video.avi")
        frames, fps = read_avi(avi)
        if frames.shape != (VIDEO_FRAMES, h, 2 * w, 3) or fps != 24:
            fail(f"video.avi ({variant}) holds {frames.shape} at {fps} fps, "
                 f"expected {(VIDEO_FRAMES, h, 2 * w, 3)} at 24")
        for i in range(VIDEO_FRAMES):
            png = read_png(os.path.join(path, "video", f"frame_{i:04d}.png"))
            if not np.array_equal(png, frames[i]):
                fail(f"frame_{i:04d}.png ({variant}) differs from the video")
        if frames.std() == 0:
            fail(f"video ({variant}) frames are constant")
        avg = re.search(r"^avg render time per frame: (\S+)s", out, re.M)
        print(f"[{tag}-{variant}] {VIDEO_FRAMES} frames of "
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


def phase_ndc_main_path(logroot):
    """The NDC path through the CLIs on an on-disk LLFF scene, with a stop
    and a rerun; returns the launch counts of its runs, summed, and the
    config overrides that name the scene."""
    from ddnerf_tpu_torch.config import load_config
    from ddnerf_tpu_torch.data.assembly import get_datasets
    from ddnerf_tpu_torch.data.synthetic import write_synthetic_llff
    from ddnerf_tpu_torch.kernels.fused_mlp import LAUNCHES
    from ddnerf_tpu_torch.models.nerf import NerfPipeline
    from ddnerf_tpu_torch.render.media import read_avi
    from ddnerf_tpu_torch.render.renderer import ImageRenderer
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
        out, launches, wall = _subprocess(cmd, f"ndc-train-{attempt}")
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
    out, launches, wall = _subprocess(cmd, "ndc-video")
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
            fail(f"ndc {name} frame launched {launched}")
    for name in ("kernel", "ipe2"):
        mse = float(np.mean((rgbs[name] - rgbs["plain"]) ** 2))
        frame_psnr = float("inf") if mse == 0 else -10.0 * math.log10(mse)
        print(f"[ndc-frame] {h} x {w} NDC rgb PSNR {name} vs plain "
              f"{frame_psnr:.2f} dB (gate {FRAME_PSNR_MIN:g})", flush=True)
        if not (frame_psnr >= FRAME_PSNR_MIN
                and np.isfinite(rgbs[name]).all()):
            fail(f"ndc {name} frame disagrees with the plain version")
    return _sum_launches(*runs), ("dataset.basedir", scene)


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
          f"(mip-NeRF); whole run "
          f"{time.perf_counter() - t_start:.1f} s")
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in FORBIDDEN_MODULES)
    if leaked:
        fail(f"imported {leaked}")

    # Each kernel's launches: the sum over the main paths, and per path.
    by_path = {"ddnerf": _sum_launches(train_launches, host_launches,
                                       profile_launches, launches,
                                       video_launches),
               "mipnerf": _sum_launches(mip_train, mip_eval, mip_video),
               "ndc": ndc_launches}
    total = _sum_launches(*by_path.values())
    print("[launches] per main path: " + json.dumps(by_path, sort_keys=True))
    for path, counts in by_path.items():
        # The NDC path films through B1 alone (the config's variant).
        expected = [k for k in total if not (path == "ndc"
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
