"""Where a consumer warpgroup of the fused-MLP forward spends its cycles, on
one NVIDIA GPU.

    python3 scripts/profile_forward_cycles.py [--check-anchors]

The kernel carries no instrumentation.  This script copies
``ddnerf_tpu_torch/kernels/csrc`` into a temporary directory, adds
``clock64()`` counters to the copy of ``fused_mlp_fwd.cu`` by text
substitution (each substitution asserts that its anchor is still there: when
the kernel changes, bring the anchors below up to date), builds the copy with
nvcc for sm_90a and runs B1, B1s and B3 at width 256 (DepthMipMLP) on a
the training shape (2048 rays x 32 samples) and a production chunk (16384 x
32).  For each it prints the launch's CUDA-event time and, as medians over
the 2 x SMs consumer warpgroups, the cycles of one thread: in all, waiting
for a weight slice (full barrier), waiting for the last products of a slice
or layer (wgmma wait), in the trunk layers' epilogues (stash wait, write-back,
fence, warpgroup barrier, stash stores) and waiting for the IPE tile.  What
is left is mostly products queued against a busy tensor pipe.  The
counters cost some time themselves.  Last, B1 runs back to back for three
seconds while ``nvidia-smi`` is sampled: the SM clock and power draw under
this kernel (a card at its power limit clocks down, and the published
tensor-core peak assumes the boost clock).  The first line is the card's name
and power limit.  ``--check-anchors`` only applies the substitutions (no GPU).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ddnerf_tpu_torch.core.math import integrated_pos_enc  # noqa: E402
from ddnerf_tpu_torch.kernels import build, fused_mlp as fk  # noqa: E402
from ddnerf_tpu_torch.models.mlp import DepthMipMLP  # noqa: E402

MAX_CTAS = 264
FIELDS = ("total", "weight-wait", "wgmma-wait", "trunk-epilogue", "ipe-wait")

# (anchor, replacement) pairs applied to fused_mlp_fwd.cu, each exactly once
# unless a count is given.
SUBSTITUTIONS = [
    ("using namespace ddnerf;\n",
     "using namespace ddnerf;\n"
     f"__device__ long long g_prof[{MAX_CTAS} * 2 * 8];\n"
     "struct Prof { long long full, mma, epi, ipe; };\n", 1),
    ("uint32_t& it, const Smem& s,\n",
     "uint32_t& it, Prof& pf, const Smem& s,\n", 1),
    ("it, s,", "it, pf, s,", 3),
    ("    mbar_wait(s.full + 8 * stage, parity);\n",
     "    { long long t = clock64(); mbar_wait(s.full + 8 * stage, parity);"
     " pf.full += clock64() - t; }\n", 1),
    ("      wgmma_wait<1>();\n",
     "      { long long t = clock64(); wgmma_wait<1>();"
     " pf.mma += clock64() - t; }\n", 1),
    ("  wgmma_wait<0>();\n",
     "  { long long t = clock64(); wgmma_wait<0>();"
     " pf.mma += clock64() - t; }\n", 1),
    ("  uint32_t it = 0, round = 0;\n",
     "  uint32_t it = 0, round = 0;\n  Prof pf = {0, 0, 0, 0};\n"
     "  const long long t_start = clock64();\n", 1),
    ("    mbar_wait(s.ipe_full + 8 * buf, (round / S::IPE_BUFS) & 1);\n",
     "    { long long t = clock64();"
     " mbar_wait(s.ipe_full + 8 * buf, (round / S::IPE_BUFS) & 1);"
     " pf.ipe += clock64() - t; }\n", 1),
    ("        if (l == SKIP && lane == 0) mbar_arrive(s.ipe_empty + 8 * buf);\n",
     "        if (l == SKIP && lane == 0) mbar_arrive(s.ipe_empty + 8 * buf);\n"
     "        const long long t_epi = clock64();\n", 1),
    ("          bulk_commit();\n        }\n      }\n    }\n",
     "          bulk_commit();\n        }\n"
     "        pf.epi += clock64() - t_epi;\n      }\n    }\n", 1),
    ("  if (p.stash && tid == 0) bulk_wait();\n",
     "  if (p.stash && tid == 0) bulk_wait();\n"
     f"  if (tid == 0 && blockIdx.x < {MAX_CTAS}) {{\n"
     "    long long* o = g_prof + (blockIdx.x * 2 + wg) * 8;\n"
     "    o[0] = clock64() - t_start; o[1] = pf.full; o[2] = pf.mma;\n"
     "    o[3] = pf.epi; o[4] = pf.ipe;\n  }\n", 1),
    ('extern "C" const char* ddnerf_cuda_error_string',
     'extern "C" int ddnerf_prof_read(long long* host) {\n'
     "  return cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));\n}\n"
     'extern "C" const char* ddnerf_cuda_error_string', 1),
]


def instrument(directory):
    """Copy the sources into ``directory`` and add the counters -> the
    path of the instrumented ``fused_mlp_fwd.cu``."""
    shutil.copytree(build.CSRC, directory, dirs_exist_ok=True)
    path = os.path.join(directory, "fused_mlp_fwd.cu")
    with open(path) as f:
        src = f.read()
    for anchor, new, count in SUBSTITUTIONS:
        if src.count(anchor) != count:
            raise SystemExit(f"anchor found {src.count(anchor)} times, "
                             f"expected {count}: {anchor!r}")
        src = src.replace(anchor, new)
    with open(path, "w") as f:
        f.write(src)
    return path


def compile_and_load(path):
    so = os.path.join(os.path.dirname(path), "profiled.so")
    cmd = [build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so,
           path]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    this_lib = build.load_library()
    for name in ("ddnerf_fused_mlp_fwd", "ddnerf_fused_enc_mlp_fwd",
                 "ddnerf_cuda_error_string"):
        getattr(lib, name).argtypes = getattr(this_lib, name).argtypes
        getattr(lib, name).restype = getattr(this_lib, name).restype
    lib.ddnerf_prof_read.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    return lib


def clocks_under_load(fn, seconds=3.0):
    """Run ``fn`` back to back for ``seconds`` -> nvidia-smi samples
    ``(SM clock MHz, power draw W)`` taken meanwhile."""
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True).stdout.strip().splitlines()
            if out:
                mhz, watts = out[0].split(",")
                samples.append((float(mhz), float(watts)))
            time.sleep(0.2)

    thread = threading.Thread(target=sample)
    t0 = time.perf_counter()
    thread.start()
    while time.perf_counter() - t0 < seconds:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    stop.set()
    thread.join()
    return samples[len(samples) // 3:]  # the card has warmed up by then


def main():
    with tempfile.TemporaryDirectory(prefix="ddnerf_prof_") as tmp:
        path = instrument(tmp)
        if "--check-anchors" in sys.argv:  # needs no GPU
            print("anchors ok")
            return
        if not torch.cuda.is_available():
            raise SystemExit("needs a CUDA device")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip(), flush=True)
        lib = compile_and_load(path)
        build.load_library = lambda: lib  # the wrappers fetch it per call
        dev = torch.device("cuda")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        gen = torch.Generator().manual_seed(0)
        net = DepthMipMLP(hidden_size=256, compute_dtype=torch.bfloat16,
                          generator=gen).to(dev)
        for rays, k in ((2048, 32), (16384, 32)):
            n = rays * k
            means = (torch.rand(n, 3, generator=gen) * 6 - 3).to(dev)
            covs = (10.0 ** (torch.rand(n, 3, generator=gen) * 6 - 7)).to(dev)
            dirs = (torch.rand(rays, 27, generator=gen) * 2 - 1).to(dev)
            ipe = integrated_pos_enc((means, covs), double_angle=False).to(
                torch.bfloat16)
            calls = (
                ("B1", lambda: fk.fused_mlp_forward(net, ipe, dirs, k)),
                ("B1s", lambda: fk.fused_mlp_forward(net, ipe, dirs, k,
                                                     stash=True)),
                ("B3", lambda: fk.fused_enc_mlp_forward(net, means, covs,
                                                        dirs, k)),
            )
            for name, fn in calls:
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                fn()
                e1.record()
                torch.cuda.synchronize()
                buf = (ctypes.c_longlong * (MAX_CTAS * 2 * 8))()
                lib.ddnerf_prof_read(buf)
                ctas = min(sms, -(-n // 128), MAX_CTAS)
                med = [statistics.median(buf[(c * 2 + w) * 8 + i]
                                         for c in range(ctas) for w in (0, 1))
                       for i in range(len(FIELDS))]
                print(f"{name} N={n}: {e0.elapsed_time(e1):.3f} ms, "
                      f"{-(-n // 128) / ctas:.2f} tiles per CTA; median cycles "
                      + ", ".join(f"{f} {v:.0f}" for f, v in zip(FIELDS, med)),
                      flush=True)
        b1 = lambda: fk.fused_mlp_forward(net, ipe, dirs, k)
        samples = clocks_under_load(b1)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(50):
            b1()
        e1.record()
        torch.cuda.synchronize()
        print(f"B1 N={n}, 50 launches queued back to back: "
              f"{e0.elapsed_time(e1) / 50:.3f} ms each", flush=True)
        print(f"B1 N={n} back to back: SM clock median "
              f"{statistics.median(m for m, _ in samples):.0f} MHz (min "
              f"{min(m for m, _ in samples):.0f}), power draw median "
              f"{statistics.median(w for _, w in samples):.0f} W "
              f"({len(samples)} nvidia-smi samples)", flush=True)


if __name__ == "__main__":
    main()
