"""Time two source trees of the fused-MLP forward against each other on one
NVIDIA GPU, inside one process, in turns.

    python3 scripts/ab_forward_kernels.py --other DIR [--reps 20]

``DIR`` holds another version of ``fused_mlp_fwd.cu`` and the headers it
includes (for a parent commit: ``git show REV:ddnerf_tpu_torch/kernels/csrc/F
> DIR/F`` for each file), with the same C entry points or those of a version
that writes no relu-mask words (no ``bits`` argument).  It is compiled with
nvcc for sm_90a into ``DIR/other.so``; the repository's own library is built
as usual.  Then B1 (render mode), B1s (stash mode) and B3 (in-kernel IPE)
are timed with CUDA events, medians of ``--reps``, for DepthMipMLP and
MipMLP at width 256 on a production chunk (16384 rays x 32 samples) and on
the training shape (2048 x 32), in the order other, this, this, other, and
the two libraries' outputs are compared.  The first line is the card's name
and power limit.  Needs a GPU; prints nothing of worth without one.
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

ENTRIES = ("ddnerf_fused_mlp_fwd", "ddnerf_fused_enc_mlp_fwd",
           "ddnerf_cuda_error_string")
BITS_ARG = 8  # ddnerf_fused_mlp_fwd's mask words, after stash_h


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


def build_other(directory, this_lib):
    so = os.path.join(directory, "other.so")
    cmd = [build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so,
           os.path.join(directory, "fused_mlp_fwd.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {directory}:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    with open(os.path.join(directory, "fused_mlp_fwd.cu")) as f:
        has_bits = "void* bits" in f.read()
    fns = {}
    for name in ENTRIES:
        fn = getattr(lib, name)
        argtypes = list(getattr(this_lib, name).argtypes)
        drop = name == "ddnerf_fused_mlp_fwd" and not has_bits
        if drop:
            del argtypes[BITS_ARG]
        fn.argtypes = argtypes
        fn.restype = getattr(this_lib, name).restype
        fns[name] = functools.partial(_drop_bits, fn) if drop else fn
    return types.SimpleNamespace(**fns)


def _drop_bits(fn, *args):
    return fn(*args[:BITS_ARG], *args[BITS_ARG + 1:])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="directory with the other fused_mlp_fwd.cu")
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
        for rays, k in ((16384, 32), (2048, 32)):
            n = rays * k
            means = (torch.rand(n, 3, generator=gen) * 6 - 3).to(dev)
            covs = (10.0 ** (torch.rand(n, 3, generator=gen) * 6 - 7)).to(dev)
            dirs = (torch.rand(rays, 27, generator=gen) * 2 - 1).to(dev)
            ipe = integrated_pos_enc((means, covs), double_angle=False).to(
                torch.bfloat16)
            outs = {}
            for which in ("other", "this", "this", "other"):
                # The wrappers fetch the library at every call.
                build.load_library = lambda lib=libs[which]: lib
                outs[which] = fk.fused_mlp_forward(net, ipe, dirs, k)
                t = (event_ms(lambda: fk.fused_mlp_forward(net, ipe, dirs, k),
                              args.reps),
                     event_ms(lambda: fk.fused_mlp_forward(
                         net, ipe, dirs, k, stash=True), args.reps),
                     event_ms(lambda: fk.fused_enc_mlp_forward(
                         net, means, covs, dirs, k), args.reps))
                print(f"{cls.__name__} N={n} {which}: B1 {t[0]:.3f} ms, B1s "
                      f"{t[1]:.3f} ms, B3 {t[2]:.3f} ms", flush=True)
            gap = (outs["this"] - outs["other"]).abs().max().item()
            print(f"{cls.__name__} N={n}: this vs other max |d| {gap:.3e}",
                  flush=True)


if __name__ == "__main__":
    main()
