"""Time two source trees of the wide plan (``csrc/fused_mlp_wide.cu``, the
fused MLP at widths above 512) against each other on one NVIDIA GPU, inside
one process, in turns.

    python3 scripts/ab_wide_kernels.py [--other DIR] [--reps 5] [--widths 1024]
        [--profile] [--library]

``DIR`` holds another version of ``fused_mlp_wide.cu`` with the same C
entry points (a parent commit's: ``git show REV:ddnerf_tpu_torch/kernels/
csrc/fused_mlp_wide.cu > DIR/fused_mlp_wide.cu``); the headers it includes
come from ``DIR`` first, then from this tree's ``csrc``.  It is compiled with
nvcc for sm_90a into ``DIR/other.so``; the repository's own library is built
as usual.  Then B1 (render mode, 16384 rays x 32 samples), B3 (the same
rows from means and covariances), B1s and B2 (the training shape, 2048 x
32) of a DepthMipMLP at each width, in bf16 and float32, are timed through
the wrappers with CUDA events, medians of ``--reps``, in the order other,
this, this, other, beside the plain version, and the two libraries'
outputs are compared.  Without ``--other`` only this tree is timed.  With
``--profile`` each case's call on this tree is traced once under
torch.profiler and its device time split into the GEMM launches, the
column and split reductions, the wide plan's small kernels (dir
projection, encode, entry, dirs gradient, TF32 splits, memsets) and the
wrapper's PyTorch kernels; with ``--library`` each case's library
yardstick is timed (``chip_smoke.py::library_ms``: one PyTorch matrix
product per GEMM of the wide plan).  The first line is the card's name and
power limit.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ddnerf_tpu_torch.core.math import integrated_pos_enc  # noqa: E402
from ddnerf_tpu_torch.kernels import build, fused_mlp as fk  # noqa: E402
from ddnerf_tpu_torch.kernels import reference as ref  # noqa: E402
from ddnerf_tpu_torch.models.mlp import DepthMipMLP  # noqa: E402
import chip_smoke  # noqa: E402

ENTRIES = ("ddnerf_wide_fwd", "ddnerf_wide_enc_fwd", "ddnerf_wide_bwd",
           "ddnerf_wide_fwd_workspace", "ddnerf_wide_bwd_workspace",
           "ddnerf_wide_tf32_split")
CHUNK_RAYS, TRAIN_RAYS, SAMPLES = 16384, 2048, 32


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


def profile_split(fn):
    """One call of ``fn`` (after a warm one) under torch.profiler: its
    device time by kind of kernel, in ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = dict.fromkeys(("gemm", "reduce", "small", "torch"), 0.0)
    for ev in prof.events():
        if str(getattr(ev, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        name = ev.name
        if "wide_" in name and "gemm" in name:
            kind = "gemm"
        elif "colsum" in name or "split_reduce" in name:
            kind = "reduce"
        elif "wide_" in name or "Memset" in name:
            kind = "small"
        else:
            kind = "torch"
        kinds[kind] += ev.time_range.elapsed_us() / 1e3
    total = sum(kinds.values())
    return (", ".join(f"{k} {v:.3f} ms" for k, v in kinds.items())
            + f" (device total {total:.3f} ms)")


def build_other(directory, this_lib):
    """``DIR/fused_mlp_wide.cu`` as a library with this library's C
    signatures (and its error strings, which only the other sources
    define)."""
    so = os.path.join(directory, "other.so")
    cmd = [build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", directory, "-I", str(build.CSRC), "-o", so,
           os.path.join(directory, "fused_mlp_wide.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"nvcc failed on the other tree:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    for name in ENTRIES:
        fn, mine = getattr(lib, name), getattr(this_lib, name)
        fn.argtypes, fn.restype = mine.argtypes, mine.restype
    lib.ddnerf_cuda_error_string = this_lib.ddnerf_cuda_error_string
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other",
                    help="directory holding the other fused_mlp_wide.cu")
    ap.add_argument("--profile", action="store_true",
                    help="split each case's device time by kernel kind")
    ap.add_argument("--library", action="store_true",
                    help="time each case's library yardstick")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--widths", type=int, nargs="+", default=[1024])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    this = build.load_library()
    libs = {"this": this}
    if args.other:
        libs["other"] = build_other(args.other, this)
    real_load = build.load_library
    dev = torch.device("cuda")

    def using(name, fn):
        """``fn`` with the wrappers launching library ``name``."""
        def call():
            build.load_library = lambda flags=(): libs[name]
            try:
                return fn()
            finally:
                build.load_library = real_load
        return call

    for hidden in args.widths:
        for cdt in (torch.bfloat16, torch.float32):
            net = DepthMipMLP(hidden_size=hidden, compute_dtype=cdt,
                              generator=torch.Generator().manual_seed(0)
                              ).to(dev)
            gen = torch.Generator().manual_seed(1)
            n = CHUNK_RAYS * SAMPLES
            means = ((torch.rand(n, 3, generator=gen) * 2 - 1) * 3).to(dev)
            covs = (10 ** (torch.rand(n, 3, generator=gen) * 6 - 6)).to(dev)
            ipe = integrated_pos_enc((means, covs), double_angle=False)
            dirs = (torch.rand(CHUNK_RAYS, 27, generator=gen) * 2 - 1).to(dev)
            t_ipe, t_dirs = ipe[:TRAIN_RAYS * SAMPLES], dirs[:TRAIN_RAYS]
            g = torch.randn(TRAIN_RAYS * SAMPLES, 6, generator=gen).to(dev)
            _, stash = fk.fused_mlp_forward(net, t_ipe, t_dirs, SAMPLES,
                                            stash=True)
            cases = {
                "B1": (lambda: fk.fused_mlp_forward(net, ipe, dirs, SAMPLES),
                       lambda: ref.fused_mlp_reference(net, ipe, dirs,
                                                       SAMPLES)),
                "B3": (lambda: fk.fused_enc_mlp_forward(net, means, covs,
                                                        dirs, SAMPLES),
                       lambda: ref.fused_enc_mlp_reference(net, means, covs,
                                                           dirs, SAMPLES)),
                "B1s": (lambda: fk.fused_mlp_forward(net, t_ipe, t_dirs,
                                                     SAMPLES, stash=True),
                        lambda: ref.fused_mlp_stash_reference(
                            net, t_ipe, t_dirs, SAMPLES)),
                "B2": (lambda: fk.fused_mlp_backward(net, t_ipe, t_dirs, g,
                                                     SAMPLES, stash),
                       lambda: ref.fused_mlp_backward_reference(
                           net, t_ipe, t_dirs, g, SAMPLES, stash)),
            }
            dtype = "float32" if cdt == torch.float32 else "bf16"
            order = (("other", "this", "this", "other") if args.other
                     else ("this", "this"))
            for case, (kern, plain) in cases.items():
                ms = {"other": [], "this": []}
                for name in order:
                    fk.forget_packed(net)  # each library packs its own
                    ms[name].append(event_ms(using(name, kern), args.reps))
                line = (f"[ab-wide] DepthMipMLP H={hidden} {dtype} {case}: "
                        f"this {ms['this'][0]:.3f} / {ms['this'][1]:.3f} ms, "
                        f"plain {event_ms(plain, args.reps):.3f} ms")
                if args.other:
                    outs = {}
                    for name in ("this", "other"):
                        fk.forget_packed(net)
                        outs[name] = using(name, kern)()
                    fk.forget_packed(net)
                    torch.cuda.synchronize()
                    a, b = outs["this"], outs["other"]
                    if case == "B1s":
                        a, b = [a[0], *a[1]], [b[0], *b[1]]
                    elif case == "B2":
                        a, b = list(a.values()), list(b.values())
                    else:
                        a, b = [a], [b]
                    same = sum(torch.equal(x, y) for x, y in zip(a, b))
                    diff = max((x.float() - y.float()).abs().max().item()
                               for x, y in zip(a, b))
                    line += (f", other {ms['other'][0]:.3f} / "
                             f"{ms['other'][1]:.3f} ms; {same} of {len(a)} "
                             f"outputs bitwise equal, largest |this - other| "
                             f"{diff:.3e}")
                print(line, flush=True)
                if args.profile:
                    fk.forget_packed(net)
                    print(f"[ab-wide] profile H={hidden} {dtype} {case}: "
                          + profile_split(kern), flush=True)
            if args.library:
                lib_ms = chip_smoke.library_ms(torch, hidden,
                                               cdt == torch.float32, "wide",
                                               args.reps)
                print(f"[ab-wide] library H={hidden} {dtype}: "
                      + ", ".join(f"{name} {t:.3f} ms"
                                  for name, t in lib_ms.items()), flush=True)

if __name__ == "__main__":
    main()
