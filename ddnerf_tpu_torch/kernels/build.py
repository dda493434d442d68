"""Build the CUDA sources under ``kernels/csrc/`` into one shared library.

The library is compiled at first use with ``nvcc`` for ``sm_90a`` (Hopper)
into ``kernels/_build/<hash>/``, keyed by a hash of the sources and flags,
and loaded with ``ctypes``: one ``nvcc`` per source, all started together,
then one link.  The sources have a plain C interface and no PyTorch
headers, so a build takes well under a minute.  A failed build raises; nothing
falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

from ddnerf_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libddnerf_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
)


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # compile time of this call; 0.0 when the cache was hit
    log: str  # nvcc / ptxas output of the build that made the library
    cached: bool


@dataclass(frozen=True)
class KernelReport:
    """What ptxas said of one ``__global__`` function."""

    name: str  # e.g. ``chain_kernel<256>``
    registers: int
    spill_bytes: int  # spill stores + spill loads
    advisories: tuple  # "(C75..)" lines: wgmma serialized, and the like


# The element types a kernel template is instantiated for, as mangled.
_TYPE_ARGS = {"f": "float", "13__nv_bfloat16": "bf16"}
_TEMPLATE_ARG = r"L[a-z]\d+E|13__nv_bfloat16|f"


def kernel_name(mangled: str) -> str:
    """``chain_kernel<256>`` (or ``wide_gemm_kernel<bf16,0,1>``) from the
    mangled name that ptxas and cuobjdump print."""
    m = re.search(rf"([a-z_]+_kernel)(?:I((?:{_TEMPLATE_ARG})+)E)?", mangled)
    if not m:
        return mangled
    args = [_TYPE_ARGS.get(a) or re.sub(r"\D", "", a)
            for a in re.findall(_TEMPLATE_ARG, m.group(2) or "")]
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def ptxas_report(log: str) -> list[KernelReport]:
    """Registers, spill bytes and advisories of every kernel in a build
    log (``-Xptxas -v``), in the log's order."""
    advisories: dict[str, list[str]] = {}
    for m in re.finditer(r"\((C75\d+)\) ([^\n]*?) in (?:the )?function '(\w+)",
                         log):
        advisories.setdefault(kernel_name(m.group(3)), []).append(
            f"({m.group(1)}) {m.group(2)}")
    out = []
    for m in re.finditer(
            r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, "
            r"(\d+) bytes spill loads.*?Used (\d+) registers", log, re.S):
        name = kernel_name(m.group(1))
        out.append(KernelReport(name, int(m.group(4)),
                                int(m.group(2)) + int(m.group(3)),
                                tuple(advisories.get(name, ()))))
    return out


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest(flags: tuple = ()) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    candidates = [
        os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
        if os.environ.get("CUDA_HOME") else None,
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ]
    for cand in candidates:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of ddnerf_tpu_torch are compiled at first use")


def build(flags: tuple = ()) -> BuildInfo:
    """Compile the library unless a build of these exact sources exists.
    ``flags``: nvcc flags added to :data:`NVCC_FLAGS` (e.g. a ``-D`` that
    compiles a fault in, to show that a check catches it); a build of
    other flags is another library, in a directory of its own."""
    out_dir = BUILD_ROOT / _digest(flags)
    lib = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildInfo(lib, 0.0, log, True)
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    nvcc = find_nvcc()
    units = [s for s in _sources() if s.suffix == ".cu"]
    objects = [out_dir / f"{s.stem}.{os.getpid()}.o" for s in units]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(units, objects)]
    log, failed = "", []
    for src, proc in zip(units, procs):
        log += proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objects)],
            capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed.append("link")
    seconds = time.perf_counter() - t0
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    profiling.count("kernels.library_builds")
    return BuildInfo(lib, seconds, log, False)


@functools.cache
def load_library(flags: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with C signatures
    (``flags``: :func:`build`'s), in the span ``ddnerf.kernels.load_library``.
    :func:`build` counts a compile as ``kernels.library_builds``; a load of
    the cached library counts nothing."""
    with profiling.span("ddnerf.kernels.load_library"):
        return _load(flags)


def _load(flags: tuple) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(flags).path))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    offs = [ctypes.POINTER(i64), ctypes.POINTER(i64)]  # w_off, b_off (host)
    # The float32 kernels (fused_mlp_f32.cu): their bfloat16 counterparts'
    # arguments without the mask bits.
    lib.ddnerf_fused_mlp_fwd_f32.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # ipe, dirs, w, b, dproj, out
        ptr, ptr,  # stash, stash_h (null in render mode)
        i64, i32, i32, i32,  # n, samples, hidden, depth_head
        *offs, ptr,  # w_off, b_off, stream
    ]
    fwd = lib.ddnerf_fused_mlp_fwd_f32.argtypes
    lib.ddnerf_fused_mlp_fwd.argtypes = [
        *fwd[:8], ptr, *fwd[8:]]  # bits after stash_h (null in render mode)
    lib.ddnerf_fused_mlp_fwd.restype = i32
    lib.ddnerf_fused_enc_mlp_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # means, covs, dirs, w, b, dproj, out
        i64, i32, i32, i32,  # n, samples, hidden, depth_head
        *offs, ptr,  # w_off, b_off, stream
    ]
    lib.ddnerf_fused_enc_mlp_fwd.restype = i32
    # n, samples, hidden
    lib.ddnerf_fused_mlp_bwd_workspace.argtypes = [i64, i32, i32]
    lib.ddnerf_fused_mlp_bwd_workspace.restype = i64
    lib.ddnerf_fused_mlp_bwd_f32.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # ipe, dirs, g, stash, stash_h, w
        ptr, ptr, ptr, i64,  # gw, gb, workspace, workspace bytes
        i64, i32, i32, i32, i32,  # n, samples, hidden, depth_head, per_ray
        *offs, ptr,  # w_off, b_off, stream
    ]
    bwd = lib.ddnerf_fused_mlp_bwd_f32.argtypes
    lib.ddnerf_fused_mlp_bwd.argtypes = [
        *bwd[:5], ptr, *bwd[5:]]  # bits after stash_h
    lib.ddnerf_fused_mlp_bwd.restype = i32
    for name in ("fused_mlp_fwd", "fused_mlp_bwd"):
        getattr(lib, f"ddnerf_{name}_f32").restype = i32
    # The float32 kernels take the same arguments as these.
    for name in ("fused_enc_mlp_fwd", "fused_mlp_bwd_workspace"):
        bf16, f32 = (getattr(lib, f"ddnerf_{name}{sfx}") for sfx in ("", "_f32"))
        f32.argtypes, f32.restype = bf16.argtypes, bf16.restype
    # w (the float32 pack's planes), hidden, w_off, stream
    lib.ddnerf_tf32_split.argtypes = [ptr, i32, offs[0], ptr]
    lib.ddnerf_tf32_split.restype = i32
    # The wide plan (fused_mlp_wide.cu): both compute dtypes, `f32` 0 or 1.
    lib.ddnerf_wide_tf32_split.argtypes = [ptr, i32, offs[0], ptr]
    lib.ddnerf_wide_tf32_split.restype = i32
    lib.ddnerf_wide_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # ipe, dirs, w, b, dproj, out
        ptr, ptr, ptr, i64,  # stash, stash_h, workspace, workspace bytes
        i64, i32, i32, i32, i32,  # n, samples, hidden, depth_head, f32
        *offs, ptr,  # w_off, b_off, stream
    ]
    lib.ddnerf_wide_fwd.restype = i32
    lib.ddnerf_wide_enc_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # means, covs, dirs, w, b, dproj, out
        ptr, i64,  # workspace, workspace bytes
        i64, i32, i32, i32, i32,  # n, samples, hidden, depth_head, f32
        *offs, ptr,  # w_off, b_off, stream
    ]
    lib.ddnerf_wide_enc_fwd.restype = i32
    # n, hidden, f32, stash, enc
    lib.ddnerf_wide_fwd_workspace.argtypes = [i64, i32, i32, i32, i32]
    lib.ddnerf_wide_fwd_workspace.restype = i64
    # n, samples, hidden, f32
    lib.ddnerf_wide_bwd_workspace.argtypes = [i64, i32, i32, i32]
    lib.ddnerf_wide_bwd_workspace.restype = i64
    lib.ddnerf_wide_bwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # ipe, dirs, g, stash, stash_h, w
        ptr, ptr, ptr, i64,  # gw, gb, workspace, workspace bytes
        i64, i32, i32, i32, i32, i32,  # n, samples, hidden, depth_head,
        # per_ray, f32
        *offs, ptr,  # w_off, b_off, stream
    ]
    lib.ddnerf_wide_bwd.restype = i32
    # The encode stage (ipe_encode.cu): t_vals, origins, directions, radii,
    # viewdirs, each with its row stride; ipe, dirs; n, samples, cone,
    # double_angle, f32; stream.
    lib.ddnerf_ipe_encode.argtypes = [
        *[ptr, i64] * 5, ptr, ptr, i64, i32, i32, i32, i32, ptr]
    lib.ddnerf_ipe_encode.restype = i32
    lib.ddnerf_cuda_error_string.argtypes = [i32]
    lib.ddnerf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        msg = lib.ddnerf_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: cudaError {err} ({msg})")
