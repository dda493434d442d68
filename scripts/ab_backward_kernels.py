"""Hold two source trees of the fused-MLP training kernels against each
other on one NVIDIA GPU, inside one process: B2's gradients leaf by leaf,
and B1s and B2 timed in turns.

    python3 scripts/ab_backward_kernels.py --other DIR [--reps 20]
        [--widths 64,96,128,192,256,320,384,512]

``DIR`` holds another version of ``fused_mlp_fwd.cu`` and
``fused_mlp_bwd.cu`` and the headers they include (for a parent commit:
``git archive REV ddnerf_tpu_torch/kernels/csrc | tar -x -C DIR
--strip-components 3``), with the same C entry points or those of a
version that passes no relu-mask words (``bits``: its chain reads the masks
from the bf16 stash).  Each file is compiled with nvcc for sm_90a into
``DIR/other_{fwd,bwd}.so``; the repository's own library is built as usual.

1. Gradients: at each width of ``--widths`` (96 and 320 run zero-padded at
   128 and 384), for DepthMipMLP and MipMLP on a ragged row count (333 rays
   x 33 samples) and at 256 also on the training shape (2048 x 32), this
   library's stash forward feeds both backwards, in both settings of
   ``per_ray_dirs``; the count of leaves that are bitwise equal, per case
   and in all.
2. Times (DepthMipMLP and MipMLP, width 256, 2048 rays x 32 samples): B1s
   and B2 through their C entry points on buffers made beforehand, each
   library's forward feeding its own backward, CUDA-event medians of
   ``--reps``, in the order other, this, this, other; then, under
   ``torch.profiler``, the device time per call of the kernels inside
   them (``fused_mlp_fwd_kernel``, ``chain_kernel``, ``wgrad_kernel``).

The first line is the card's name and power limit.  Needs a GPU; prints
nothing of worth without one.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import os
import statistics
import subprocess
import sys
import types

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ddnerf_tpu_torch.core.math import integrated_pos_enc  # noqa: E402
from ddnerf_tpu_torch.kernels import build, fused_mlp as fk  # noqa: E402
from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP  # noqa: E402

# The entry points each file gives, and where the bits argument sits in
# this version's argument lists (after stash_h).
ENTRIES = {"fused_mlp_fwd.cu": {"ddnerf_fused_mlp_fwd": 8},
           "fused_mlp_bwd.cu": {"ddnerf_fused_mlp_bwd_workspace": None,
                                "ddnerf_fused_mlp_bwd": 5}}
KERNELS = ("fused_mlp_fwd_kernel", "chain_kernel", "wgrad_kernel")


def event_ms(fn, reps):
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


def kernel_ms(fn, reps):
    """Device ms per call of ``fn`` in each of :data:`KERNELS` (all its
    instantiations), from a profile of ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        for name in KERNELS:
            if f"{name}<" in ev.key:
                us = getattr(ev, "device_time_total", None)
                if us is None:
                    us = ev.cuda_time_total
                out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


def build_other(directory, this_lib):
    """The other tree's entry points, called with this version's
    arguments (the bits dropped where the other version takes none), with
    this library's error strings."""
    fns = {"ddnerf_cuda_error_string": this_lib.ddnerf_cuda_error_string}
    for src, entries in ENTRIES.items():
        so = os.path.join(directory, f"other_{src[10:13]}.so")
        cmd = [build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
               so, os.path.join(directory, src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {directory}:\n{proc.stderr}")
        lib = ctypes.CDLL(so)
        with open(os.path.join(directory, src)) as f:
            has_bits = "void* bits" in f.read()
        for name, at in entries.items():
            fn = getattr(lib, name)
            argtypes = list(getattr(this_lib, name).argtypes)
            drop = at is not None and not has_bits
            if drop:
                del argtypes[at]
            fn.argtypes = argtypes
            fn.restype = getattr(this_lib, name).restype
            fns[name] = functools.partial(_drop_arg, fn, at) if drop else fn
    return types.SimpleNamespace(**fns)


def _drop_arg(fn, at, *args):
    return fn(*args[:at], *args[at + 1:])


def inputs(net, rays, k, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    n = rays * k
    means = torch.randn(n, 3, generator=gen).to(dev)
    covs = (torch.rand(n, 3, generator=gen) * 0.1).to(dev)
    ipe = integrated_pos_enc((means, covs), double_angle=False)
    dirs = (torch.rand(rays, 27, generator=gen) * 2 - 1).to(dev)
    g = torch.randn(n, net.out_dim, generator=gen).to(dev)
    return ipe, dirs, g


def raw_calls(lib, net, ipe, dirs, g, k):
    """B1s and B2 through ``lib``'s C entry points alone, on buffers made
    here once: ``(forward, backward)``, the backward reading the stash and
    mask words this forward wrote."""
    dev, n = ipe.device, ipe.shape[0]
    hid = fk.kernel_width(net.hidden_size)
    kw = fk._packed(net)
    ipe_b = ipe.to(torch.bfloat16).contiguous()
    dirs_b = dirs.to(torch.bfloat16).contiguous()
    dirs_p = torch.zeros((n // k, fk.DIRS_LD), dtype=torch.bfloat16,
                         device=dev)
    dirs_p[:, :dirs.shape[1]] = dirs
    out = torch.empty((n, net.out_dim), dtype=torch.float32, device=dev)
    dproj = torch.empty((n // k, fk.DIR_HIDDEN), dtype=torch.float32,
                        device=dev)
    trunk = torch.empty((9, n, hid), dtype=torch.bfloat16, device=dev)
    h = torch.empty((n, fk.DIR_HIDDEN), dtype=torch.bfloat16, device=dev)
    bits = torch.zeros(fk.mask_bits_shape(n, hid), dtype=torch.int32,
                       device=dev)
    g32 = g.float().contiguous()
    gw = torch.empty(kw.w.numel(), dtype=torch.float32, device=dev)
    gb = torch.empty(kw.b.numel(), dtype=torch.float32, device=dev)
    ws_bytes = lib.ddnerf_fused_mlp_bwd_workspace(n, k, hid)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev)
    offs = fk._offsets(kw)
    stream = torch.cuda.current_stream(dev).cuda_stream
    keep = (ipe_b, dirs_b, dirs_p, out, dproj, trunk, h, bits, g32, gw, gb,
            ws, offs)

    def forward():
        err = lib.ddnerf_fused_mlp_fwd(
            ipe_b.data_ptr(), dirs_b.data_ptr(), kw.w.data_ptr(),
            kw.b.data_ptr(), dproj.data_ptr(), out.data_ptr(),
            trunk.data_ptr(), h.data_ptr(), bits.data_ptr(), n, k, hid,
            int(net.depth_head), *offs, stream)
        build.check(lib, err, "fused_mlp_fwd_stash")
        return keep

    def backward():
        err = lib.ddnerf_fused_mlp_bwd(
            ipe_b.data_ptr(), dirs_p.data_ptr(), g32.data_ptr(),
            trunk.data_ptr(), h.data_ptr(), bits.data_ptr(), kw.w.data_ptr(),
            gw.data_ptr(), gb.data_ptr(), ws.data_ptr(), ws_bytes, n, k, hid,
            int(net.depth_head), 0, *offs, stream)
        build.check(lib, err, "fused_mlp_bwd")
        return keep

    forward()
    return forward, backward


def compare(libs, widths, dev):
    """Part 1: B2 of both libraries on this library's stash, leaf by
    leaf."""
    same_all = total = 0
    for hidden in widths:
        for cls in (DepthMipMLP, MipMLP):
            net = cls(hidden_size=hidden, compute_dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(hidden)).to(dev)
            shapes = [(333, 33)] + ([(2048, 32)] if hidden == 256 else [])
            for rays, k in shapes:
                ipe, dirs, g = inputs(net, rays, k, hidden + rays, dev)
                build.load_library = lambda: libs["this"]
                _, stash = fk.fused_mlp_forward(net, ipe, dirs, k, stash=True)
                for per_ray in (False, True):
                    grads = {}
                    for which in ("other", "this"):
                        # The wrappers fetch the library at every call.
                        build.load_library = lambda lib=libs[which]: lib
                        grads[which] = fk.fused_mlp_backward(
                            net, ipe, dirs, g, k, stash, per_ray)
                    this, other = grads["this"], grads["other"]
                    same = sum(torch.equal(this[name], other[name])
                               for name in this)
                    same_all += same
                    total += len(this)
                    worst = max(
                        (((this[name] - other[name]).norm()
                          / other[name].norm().clamp_min(1e-30)).item(), name)
                        for name in this)
                    mode = "per-ray" if per_ray else "per-sample"
                    print(f"{cls.__name__} H={hidden} N={rays * k} K={k} "
                          f"({mode} dirs): {same} of {len(this)} leaves "
                          f"bitwise equal, largest ||d|| / ||other|| "
                          f"{worst[0]:.3e} ({worst[1]})", flush=True)
    build.load_library = lambda: libs["this"]
    print(f"bitwise: {same_all} of {total} leaves equal", flush=True)
    return same_all == total


def timings(libs, reps, dev):
    """Part 2: B1s and B2 of both libraries at width 256 on the training
    shape, in turns, then their kernels' device times."""
    for cls in (DepthMipMLP, MipMLP):
        net = cls(hidden_size=256, compute_dtype=torch.bfloat16,
                  generator=torch.Generator().manual_seed(0)).to(dev)
        rays, k = 2048, 32
        ipe, dirs, g = inputs(net, rays, k, 1, dev)
        calls = {which: raw_calls(lib, net, ipe, dirs, g, k)
                 for which, lib in libs.items()}
        tag = f"{cls.__name__} H=256 N={rays * k} K={k}"
        for which in ("other", "this", "this", "other"):
            fwd, bwd = calls[which]
            print(f"{tag} {which}: B1s {event_ms(fwd, reps):.4f} ms, B2 "
                  f"{event_ms(bwd, reps):.4f} ms (C entry points, "
                  f"CUDA-event medians of {reps})", flush=True)
        for which in ("other", "this"):
            fwd, bwd = calls[which]
            ms = {**kernel_ms(fwd, reps), **kernel_ms(bwd, reps)}
            print(f"{tag} {which}: device ms per call (torch.profiler, "
                  f"{reps} calls): " + ", ".join(
                      f"{name} {ms[name]:.4f}" for name in KERNELS
                      if name in ms), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="directory with the other fused_mlp_{fwd,bwd}.cu")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--widths", default="64,96,128,192,256,320,384,512")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    this_lib = build.load_library()
    libs = {"other": build_other(args.other, this_lib), "this": this_lib}
    dev = torch.device("cuda")
    ok = compare(libs, [int(w) for w in args.widths.split(",")], dev)
    timings(libs, args.reps, dev)
    if not ok:
        raise SystemExit("the two backwards differ")


if __name__ == "__main__":
    main()
