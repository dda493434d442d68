"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the repository root.  Phases, each of which fails the run:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the CUDA kernels from ``ddnerf_tpu_torch/kernels/csrc``;
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
   (2048 rays x 32 samples) and a ragged one, with CUDA-event timings;
5. training main path: ``python -m ddnerf_tpu_torch.cli.train`` on
   ``configs/synthetic_smoke.yml`` for 200 iterations: finite losses, a
   lower mean loss over the last 20 iterations than over the first 20, a
   validation line, ``config.yml`` and ``checkpoint.ckpt``, and two
   launches of each training kernel per step;
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
   frame (uint8) of the in-kernel-IPE path against the plain one.

The second-to-last line is the kernel table as JSON (each kernel's time
beside its plain version's and beside ``bound_ms``, the least time the card
could take for the same work, see :func:`_bound_ms`); the last line is
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
# at most this share may be exactly representable in bf16 (read <= 0.4%;
# weight gradients rounded to bf16 read 100%).
WEIGHT_GRAD_BF16_SHARE_MAX = 0.05
TRAIN_ITERS = 200
LOSS_WINDOW = 20  # iterations averaged at each end of the training run
PARITY_STEPS = 20
# Kernel vs plain training, per step: |loss_kernel - loss_plain| /
# loss_plain.  The two differ in summation order and in the weight
# gradients (f32 in the kernel, rounded to bf16 by the plain path's cast).
# Read 1.26e-6.  Faults injected into B2's gradients read: the dir layer's
# zeroed 3.0e-3, every bias zeroed 1.0e-3, trunk layers 0-3 zeroed 2.4e-5,
# every gradient x0.1 2.2e-5.  Layer 0 alone zeroed (1.5e-6) and
# bf16-rounded weight gradients (5.3e-7) are invisible in 20 early steps:
# the per-gradient gates above catch those.
PARITY_GAP_TOL = 1e-5


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
        if "registers" in line or "spill" in line or "(C75" in line:
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
        net = cls(hidden_size=256, compute_dtype=torch.bfloat16,
                  generator=gen).to(dev)
        for rays, k in ((TRAIN_RAYS, SAMPLES), (333, 33)):
            n = rays * k
            tag = f"{cls.__name__} N={n} K={k}"
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
            if rays != TRAIN_RAYS:
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


def phase_train_main_path(logroot):
    """The training CLI at full width; returns (logdir, launch counts)."""
    cmd = [sys.executable, "-m", "ddnerf_tpu_torch.cli.train", "--config",
           CONFIG, "--max-iters", str(TRAIN_ITERS),
           "experiment.logdir", logroot]
    out, launches, wall = _subprocess(cmd, "train")
    logdir = os.path.join(logroot, "synthetic_smoke")
    train_lines = re.findall(r"^\[TRAIN\] iter (\d+) loss (\S+) psnr (\S+)",
                             out, re.M)
    val_lines = re.findall(r"^\[VAL\] iter \d+ loss (\S+) psnr (\S+)", out,
                           re.M)
    if not train_lines or not all(math.isfinite(float(a)) and
                                  math.isfinite(float(b))
                                  for _, a, b in train_lines):
        fail(f"[TRAIN] lines missing or not finite: {train_lines}")
    if not val_lines or not all(math.isfinite(float(a)) and
                                math.isfinite(float(b)) for a, b in val_lines):
        fail(f"[VAL] lines missing or not finite: {val_lines}")
    for name in ("config.yml", "checkpoint.ckpt", "metrics.jsonl"):
        if not os.path.isfile(os.path.join(logdir, name)):
            fail(f"training wrote no {name} in {logdir}")
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if r["kind"] == "train"]
    if len(losses) != TRAIN_ITERS or not all(map(math.isfinite, losses)):
        fail(f"metrics.jsonl holds {len(losses)} finite train losses, "
             f"expected {TRAIN_ITERS}")
    first = statistics.mean(losses[:LOSS_WINDOW])
    last = statistics.mean(losses[-LOSS_WINDOW:])
    print(f"[train] mean loss of iterations 0-{LOSS_WINDOW - 1}: {first:.5f}, "
          f"of the last {LOSS_WINDOW}: {last:.5f}; wall {wall:.1f} s, "
          f"launches {launches}", flush=True)
    if not last < first:
        fail("training did not lower the mean loss")
    for name in ("fused_mlp_fwd_stash", "fused_mlp_bwd"):
        if launches.get(name) != 2 * TRAIN_ITERS:
            fail(f"training launched {name} {launches.get(name)} times, "
                 f"expected {2 * TRAIN_ITERS} (two networks per step)")
    return logdir, launches


def phase_main_path(logdir):
    """The eval CLI on the trained logdir; returns its launch counts."""
    cmd = [sys.executable, "-m", "ddnerf_tpu_torch.cli.eval",
           "--logdir", logdir, "--max-images", "2"]
    _, launches, wall = _subprocess(cmd, "eval")
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
    print(f"[eval] {len(metrics)} finite PSNR/SSIM values, wall {wall:.1f} s, "
          f"launches {launches}", flush=True)
    if launches.get("fused_mlp_fwd", 0) <= 0:
        fail("the eval render did not launch fused_mlp_fwd")
    return launches


def phase_video_main_path(logdir):
    """The video CLI on an ``ipe2`` sibling of the trained logdir and on
    the logdir itself (``mlp``); returns the ``ipe2`` run's launch counts."""
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
    os.symlink(os.path.join(logdir, "checkpoint.ckpt"),
               os.path.join(sibling, "checkpoint.ckpt"))
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
        out, launches, wall = _subprocess(cmd, f"video-{variant}")
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
        print(f"[video-{variant}] {VIDEO_FRAMES} frames of "
              f"{frames.shape[1:]} in video.avi ({os.path.getsize(avi)} "
              f"bytes) and as PNGs; avg frame {avg.group(1) if avg else '?'} "
              f"s, wall {wall:.1f} s, launches {launches}", flush=True)
        if launches.get(kernel) != expected or launches.get(other) != 0:
            fail(f"video ({variant}) launched {kernel} "
                 f"{launches.get(kernel)} and {other} {launches.get(other)} "
                 f"times, expected {expected} and 0")
        runs[variant] = (frames, launches)
    diff = np.abs(runs["ipe2"][0].astype(int) - runs["mlp"][0].astype(int))
    print(f"[video] ipe2 vs mlp frames: max {diff.max()} uint8 levels, "
          f"{(diff.max(-1) > 0).mean():.2e} of the pixels differ", flush=True)
    return runs["ipe2"][1]


def phase_train_parity(torch):
    """Kernel vs plain training from one seed on the same batches."""
    from ddnerf_tpu_torch.config import load_config
    from ddnerf_tpu_torch.data.datasets import (
        load_train_store,
        sample_rays_on_device,
    )
    from ddnerf_tpu_torch.models.nerf import NerfPipeline
    from ddnerf_tpu_torch.train.state import TrainState
    from ddnerf_tpu_torch.train.step import train_step

    dev = torch.device("cuda")
    store, _, cfg = load_train_store(load_config(CONFIG), dev)
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
        print(f"[parity] {name} losses: "
              + " ".join(f"{v:.5f}" for v in losses[name]))
        print(f"[parity] {name}: {step_ms[name]:.2f} ms/step steady state "
              f"(steps 5-{PARITY_STEPS - 1}), "
              f"{rays / step_ms[name] * 1e3:,.0f} rays/s", flush=True)
    print(f"[parity] largest relative loss gap kernel vs plain {gap:.3e} "
          f"(gate {PARITY_GAP_TOL:g})", flush=True)
    if not gap <= PARITY_GAP_TOL or not all(
            math.isfinite(v) for v in losses["kernel"] + losses["plain"]):
        fail("kernel and plain training trajectories disagree")
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


def phase_frame(torch):
    from ddnerf_tpu_torch.config import load_config
    from ddnerf_tpu_torch.kernels.fused_mlp import LAUNCHES
    from ddnerf_tpu_torch.models.nerf import NerfPipeline
    from ddnerf_tpu_torch.render.renderer import ImageRenderer

    cfg = load_config(CONFIG)
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
            fail(f"800x800 {name} render launched {launched}, expected "
                 f"{want}")
    rgb_p = outs["plain"][1]["rgb"]
    for name in ("kernel", "ipe2"):
        rgb = outs[name][1]["rgb"]
        if rgb.shape != (FRAME, FRAME, 3) or not np.isfinite(rgb).all():
            fail(f"800x800 {name} render: shape {rgb.shape} or non-finite "
                 f"rgb")
        mse = float(np.mean((rgb - rgb_p) ** 2))
        frame_psnr = float("inf") if mse == 0 else -10.0 * math.log10(mse)
        print(f"[frame] 800x800 rgb PSNR {name} vs plain {frame_psnr:.2f} dB "
              f"(gate {FRAME_PSNR_MIN:g})", flush=True)
        if not frame_psnr >= FRAME_PSNR_MIN:
            fail(f"800x800 {name} frame disagrees with the plain version")
    print("[frame] 800x800 walls: " + "; ".join(
        f"{name} {walls[name]} s" for name in walls), flush=True)
    video = {name: renderers[name].render_video_frame_from_pose(
        pose, FRAME, FRAME, focal) for name in ("ipe2", "plain")}
    for i, part in enumerate(("rgb", "disp")):
        diff = np.abs(video["ipe2"][i].astype(int)
                      - video["plain"][i].astype(int))
        if diff.ndim == 3:
            diff = diff.max(-1)
        print(f"[frame] 800x800 video frame {part}, ipe2 vs plain: max "
              f"{diff.max()} uint8 levels, {(diff > 0).mean():.3e} of the "
              f"pixels differ", flush=True)
    return {name: min(v) for name, v in walls.items()}


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
        launches = phase_main_path(logdir)
        video_launches = phase_video_main_path(logdir)
    step_ms = phase_train_parity(torch)
    frame_s = phase_frame(torch)
    print(f"[frame] 800x800 best of two: kernel (B1) {frame_s['kernel']:.3f} "
          f"s, ipe2 (B3) {frame_s['ipe2']:.3f} s, plain "
          f"{frame_s['plain']:.3f} s; train step kernel "
          f"{step_ms['kernel']:.2f} ms, plain {step_ms['plain']:.2f} ms; "
          f"whole run {time.perf_counter() - t_start:.1f} s")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "orbax", "ddnerf_tpu"))
    if leaked:
        fail(f"imported {leaked}")

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
         launches["fused_mlp_fwd"], max_err, ms, plain_ms),
        ("fused_mlp_fwd_stash", fwd_cu, "ddnerf_tpu/kernels/fused_mlp.py:464",
         train_launches["fused_mlp_fwd_stash"],
         train_err["fused_mlp_fwd_stash"], coarse["fwd_stash"],
         coarse["plain_fwd"]),
        ("fused_mlp_bwd", "ddnerf_tpu_torch/kernels/csrc/fused_mlp_bwd.cu",
         "ddnerf_tpu/kernels/fused_mlp_bwd.py:299",
         train_launches["fused_mlp_bwd"], train_err["fused_mlp_bwd"],
         coarse["bwd"], coarse["plain_bwd"]),
        ("fused_enc_mlp_fwd", fwd_cu, "ddnerf_tpu/kernels/fused_mlp.py:309",
         video_launches["fused_enc_mlp_fwd"], enc_err, enc["enc"],
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
