"""Time two source trees of the fused-MLP backward against each other on one
NVIDIA GPU, inside one process, in turns.

    python3 scripts/ab_backward_kernels.py --other DIR [--reps 20]

``DIR`` holds another version of ``fused_mlp_bwd.cu`` and the headers it
includes (for a parent commit: ``git show REV:ddnerf_tpu_torch/kernels/csrc/F
> DIR/F`` for each file), with the same C entry points or those of a version
whose ``ddnerf_fused_mlp_bwd`` has no ``per_ray`` argument (which computes
the per-ray dirs gradient only).  It is compiled with nvcc for sm_90a into ``DIR/other_bwd.so``; the
repository's own library is built as usual and its stash forward feeds both.
Then the backward is timed with CUDA events, medians of ``--reps``, for
DepthMipMLP and MipMLP at width 256 on the training shape (2048 rays x 32
samples) and on 2048 x 33, with per-ray dirs (``per_ray_dirs=True``, what
both versions compute) in the order other, this, this, other, and then this
version with per-sample dirs (the default): once through the wrapper
(``fused_mlp_backward``: what a train step calls, allocations and gradient
views included) and once through the C entry point alone on buffers made
beforehand (the kernels' own time), each with the host time to enqueue it.
The two libraries' per-ray gradients are compared leaf by leaf: the count
of leaves that are bitwise equal, and the largest ||d|| / ||other||
(``layers_dir.0.weight`` may differ in summation order: its dirs columns
are a float32 product here, a tensor-core one in the parent of the
per-sample repair).  The first
line is the card's name and power limit.  Needs a GPU; prints nothing of
worth without one.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import time
import types

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ddnerf_tpu_torch.kernels import build, fused_mlp as fk  # noqa: E402
from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP  # noqa: E402

ENTRIES = ("ddnerf_fused_mlp_bwd_workspace", "ddnerf_fused_mlp_bwd")


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


def host_ms(fn, reps):
    """Host time to enqueue one call (no synchronisation inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def build_other(directory, this_lib):
    """The other tree's backward, with this library's error strings."""
    so = os.path.join(directory, "other_bwd.so")
    cmd = [build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so,
           os.path.join(directory, "fused_mlp_bwd.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {directory}:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    with open(os.path.join(directory, "fused_mlp_bwd.cu")) as f:
        per_ray_arg = "int per_ray" in f.read()
    fns = {"ddnerf_cuda_error_string": this_lib.ddnerf_cuda_error_string}
    for name in ENTRIES:
        fn = getattr(lib, name)
        argtypes = list(getattr(this_lib, name).argtypes)
        if not per_ray_arg and name == "ddnerf_fused_mlp_bwd":
            del argtypes[14]  # the per_ray argument follows depth_head
        fn.argtypes = argtypes
        fn.restype = getattr(this_lib, name).restype
        fns[name] = fn
    if not per_ray_arg:
        fns = {**fns, **legacy_entries(fns)}
    return types.SimpleNamespace(**fns)


def legacy_entries(fns):
    """This version's backward entry point over a version without the
    per_ray argument, which rounds the per-ray sum (per_ray must be 1)."""
    old_bwd = fns["ddnerf_fused_mlp_bwd"]

    def backward(*args):
        args = list(args)
        assert args.pop(14), "the other version computes per-ray dirs only"
        return old_bwd(*args)

    return {"ddnerf_fused_mlp_bwd": backward}


def raw_call(lib, net, ipe, dirs, g, k, stash, per_ray):
    """The C entry point alone, on buffers made here once."""
    dev, n, hid = ipe.device, ipe.shape[0], net.hidden_size
    kw = fk._packed(net)
    ipe_b = ipe.to(torch.bfloat16).contiguous()
    dirs_p = torch.zeros((n // k, fk.DIRS_LD), dtype=torch.bfloat16, device=dev)
    dirs_p[:, :dirs.shape[1]] = dirs
    g32 = g.float().contiguous()
    gw = torch.empty(kw.w.numel(), dtype=torch.float32, device=dev)
    gb = torch.empty(kw.b.numel(), dtype=torch.float32, device=dev)
    ws_bytes = lib.ddnerf_fused_mlp_bwd_workspace(n, k, hid)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev)
    offs = fk._offsets(kw)
    stream = torch.cuda.current_stream(dev).cuda_stream
    keep = (ipe_b, dirs_p, g32, gw, gb, ws, offs)

    def call():
        err = lib.ddnerf_fused_mlp_bwd(
            ipe_b.data_ptr(), dirs_p.data_ptr(), g32.data_ptr(),
            stash.trunk.data_ptr(), stash.h.data_ptr(), kw.w.data_ptr(),
            gw.data_ptr(), gb.data_ptr(), ws.data_ptr(), ws_bytes, n, k, hid,
            int(net.depth_head), int(per_ray), *offs, stream)
        build.check(lib, err, "fused_mlp_bwd")
        return keep

    return call


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="directory with the other fused_mlp_bwd.cu")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    this_lib = build.load_library()
    libs = {"other": build_other(args.other, this_lib), "this": this_lib}
    dev = torch.device("cuda")
    for cls in (DepthMipMLP, MipMLP):
        gen = torch.Generator().manual_seed(0)
        net = cls(hidden_size=256, compute_dtype=torch.bfloat16,
                  generator=gen).to(dev)
        for rays, k in ((2048, 32), (2048, 33)):
            n = rays * k
            ipe = (torch.rand(n, 96, generator=gen) * 2 - 1).to(dev)
            dirs = (torch.rand(rays, 27, generator=gen) * 2 - 1).to(dev)
            g = torch.randn(n, net.out_dim, generator=gen).to(dev)
            build.load_library = lambda: this_lib
            _, stash = fk.fused_mlp_forward(net, ipe, dirs, k, stash=True)
            grads = {}
            for which, per_ray in (("other", True), ("this", True),
                                   ("this", True), ("other", True),
                                   ("this", False)):
                # The wrappers fetch the library at every call.
                build.load_library = lambda lib=libs[which]: lib
                if per_ray:
                    grads[which] = fk.fused_mlp_backward(net, ipe, dirs, g, k,
                                                         stash, True)

                def wrapper():
                    return fk.fused_mlp_backward(net, ipe, dirs, g, k, stash,
                                                 per_ray)

                call = raw_call(libs[which], net, ipe, dirs, g, k, stash,
                                per_ray)
                mode = "per-ray" if per_ray else "per-sample"
                print(f"{cls.__name__} N={n} K={k} {which} ({mode} dirs): B2 "
                      f"through the "
                      f"wrapper {event_ms(wrapper, args.reps):.3f} ms (host "
                      f"{host_ms(wrapper, args.reps):.3f} ms per call), the "
                      f"C entry point alone {event_ms(call, args.reps):.3f} "
                      f"ms (host {host_ms(call, args.reps):.3f} ms per call)",
                      flush=True)
            this, other = grads["this"], grads["other"]
            same = sum(torch.equal(this[name], other[name]) for name in this)
            worst = max(
                (((this[name] - other[name]).norm()
                  / other[name].norm().clamp_min(1e-30)).item(), name)
                for name in this)
            print(f"{cls.__name__} N={n} K={k}: this vs other (per-ray "
                  f"dirs), {same} of {len(this)} leaves bitwise equal, "
                  f"largest ||d|| / ||other|| {worst[0]:.3e} ({worst[1]})",
                  flush=True)


if __name__ == "__main__":
    main()
