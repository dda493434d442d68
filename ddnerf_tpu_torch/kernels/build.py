"""Build the CUDA sources under ``kernels/csrc/`` into one shared library.

The library is compiled at first use with ``nvcc`` for ``sm_90a`` (Hopper)
into ``kernels/_build/<hash>/``, keyed by a hash of the sources and flags,
and loaded with ``ctypes``.  The sources have a plain C interface and no
PyTorch headers, so a build takes seconds.  A failed build raises; nothing
falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libddnerf_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
)


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # compile time of this call; 0.0 when the cache was hit
    log: str  # nvcc / ptxas output of the build that made the library
    cached: bool


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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


def build() -> BuildInfo:
    """Compile the library unless a build of these exact sources exists."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildInfo(lib, 0.0, log, True)
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in _sources() if s.suffix == ".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return BuildInfo(lib, seconds, log, False)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with C signatures."""
    lib = ctypes.CDLL(str(build().path))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    offs = [ctypes.POINTER(i64), ctypes.POINTER(i64)]  # w_off, b_off (host)
    lib.ddnerf_fused_mlp_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # ipe, dirs, w, b, dproj, out
        ptr, ptr,  # stash, stash_h (null in render mode)
        i64, i32, i32, i32,  # n, samples, hidden, depth_head
        *offs, ptr,  # w_off, b_off, stream
    ]
    lib.ddnerf_fused_mlp_fwd.restype = i32
    lib.ddnerf_fused_mlp_bwd_workspace.argtypes = [i64, i32, i32]
    lib.ddnerf_fused_mlp_bwd_workspace.restype = i64
    lib.ddnerf_fused_mlp_bwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # ipe, dirs, g, stash, stash_h, w
        ptr, ptr, ptr, i64,  # gw, gb, workspace, workspace bytes
        i64, i32, i32, i32,  # n, samples, hidden, depth_head
        *offs, ptr,  # w_off, b_off, stream
    ]
    lib.ddnerf_fused_mlp_bwd.restype = i32
    lib.ddnerf_cuda_error_string.argtypes = [i32]
    lib.ddnerf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        msg = lib.ddnerf_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: cudaError {err} ({msg})")
