"""How far B2 (the fused MLP backward) can agree with its plain version at
each network width, what its stage-by-stage check reads, and what faults
injected into it read, on one NVIDIA GPU.

    python3 scripts/b2_rounding_floor.py [--seeds 5] [--no-faults]

Both round every cotangent to bf16 between layers and accumulate in
float32, in different orders; where an order change moves a float32 sum
across a bf16 rounding boundary, the two cotangents differ by a bf16 step,
and the chain carries that down to layer 0.  For DepthMipMLP at widths 128,
256, 384 and 512 (10,989 rows, 333 rays of 33 samples, per-sample dirs):

* exact-integer data (``chip_smoke.py::_exact_case``: every sum of the
  forward and of the cotangent chain exact in float32 whatever its order):
  B1 against the plain forward, and B2's worst leaf against the plain
  backward; a sound kernel reads 0;
* ``chip_smoke.py``'s random data (phase 17's), one line per seed: the
  largest ||d|| / ||ref|| over the trunk leaves and over the others, of
  the kernel against the plain version (float32), of the kernel against
  the plain version with float64 products and sums
  (``accumulate=torch.float64``: the same bf16 rounding points), and of
  the plain float32 version against that float64 one: the rounding floor
  of float32 accumulation; then ``chip_smoke.py::b2_stage_readings`` (each
  stage against float64 fed the kernel's own cotangents);
* the same data, per width: the share of bf16 cotangent elements of the
  8 trunk products (fc_feat, W7..W1; K = the width) that differ from the
  bf16 rounding of the float64 product of the same input, for the kernel,
  for float32 products (cuBLAS, TF32 off) and for bf16 tensor-core
  products with float32 accumulation (cuBLAS, bf16 output): which
  accumulation the kernel's flips follow; and the share of the kernel's
  elements that differ from the tensor cores' through cuBLAS;
* unless ``--no-faults``: faults injected into a copy of
  ``csrc/fused_mlp_bwd.cu`` (built here into a temporary directory; the
  repository's sources stay as they are), each read like the sound kernel
  at widths 256 and 512 on the first seed: the bf16 cotangents rounded
  toward zero, the bias gradients summed after the cotangent's rounding,
  the weight gradients rounded to bf16, the last split of every weight
  gradient dropped, the per-sample dirs cotangent summed unrounded.

The first line is the card's name and power limit.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
import types

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from ddnerf_tpu_torch.core.math import integrated_pos_enc  # noqa: E402
from ddnerf_tpu_torch.kernels import build  # noqa: E402
from ddnerf_tpu_torch.kernels import fused_mlp as fk  # noqa: E402
from ddnerf_tpu_torch.kernels import reference as ref  # noqa: E402
from ddnerf_tpu_torch.models.mlp import DepthMipMLP  # noqa: E402

WIDTHS = (128, 256, 384, 512)
FAULT_WIDTHS = (256, 512)
RAYS, K = 333, 33
# (name, text of fused_mlp_bwd.cu, its replacement)
FAULTS = (
    ("cotangent rounded toward zero",
     "__floats2bfloat162_rn(v[half][0], v[half][1]);",
     "__halves2bfloat162(__float2bfloat16_rz(v[half][0]),\n"
     "                               __float2bfloat16_rz(v[half][1]));"),
    ("biases summed after rounding",
     "acc[4 * j] = v[0][0] + v[1][0];\n"
     "      acc[4 * j + 1] = v[0][1] + v[1][1];",
     "acc[4 * j] = __bfloat162float(__float2bfloat16_rn(v[0][0])) +\n"
     "                   __bfloat162float(__float2bfloat16_rn(v[1][0]));\n"
     "      acc[4 * j + 1] = __bfloat162float(__float2bfloat16_rn(v[0][1])) +\n"
     "                       __bfloat162float(__float2bfloat16_rn(v[1][1]));"),
    ("weight gradients rounded to bf16",
     "R.gw[T.dst + (local / T.n) * T.ld + local % T.n] = s;",
     "R.gw[T.dst + (local / T.n) * T.ld + local % T.n] =\n"
     "      __bfloat162float(__float2bfloat16_rn(s));"),
    ("last split of each weight gradient dropped",
     "for (int sp = 0; sp < T.splits; ++sp)",
     "for (int sp = 0; sp < T.splits - (T.splits > 1); ++sp)"),
    ("per-sample dirs cotangent summed unrounded",
     "s += per_ray ? v : __bfloat162float(__float2bfloat16_rn(v));",
     "s += v;"),
)


def rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-300)).item()


def worst(grads, want):
    """The largest ||d|| / ||want|| over the trunk leaves and the rest."""
    trunk = max(rel(grads[m], want[m]) for m in want
                if m.startswith("layers_xyz."))
    rest = max(rel(grads[m], want[m]) for m in want
               if not m.startswith("layers_xyz."))
    return f"trunk {trunk:.3e} / rest {rest:.3e}"


def random_case(hidden, seed, dev):
    """Phase 17's random data for ``hidden`` (its seed is ``hidden``)."""
    gen = torch.Generator().manual_seed(seed)
    net = DepthMipMLP(hidden_size=hidden, compute_dtype=torch.bfloat16,
                      generator=gen).to(dev)
    means, covs = cs._gaussians(torch, gen, RAYS * K, dev)
    ipe = integrated_pos_enc((means, covs), double_angle=False)
    dirs = (torch.rand(RAYS, 27, generator=gen) * 2 - 1).to(dev)
    g = torch.randn(RAYS * K, net.out_dim, generator=gen).to(dev)
    _, stash = fk.fused_mlp_forward(net, ipe, dirs, K, stash=True)
    return net, ipe, dirs, g, stash


def readings(tag, net, ipe, dirs, g, stash, lib=None):
    stages, kern = cs.b2_stage_readings(torch, net, ipe, dirs, g, K, stash,
                                        False, lib)
    p32 = ref.fused_mlp_backward_reference(net, ipe, dirs, g, K, stash)
    p64 = ref.fused_mlp_backward_reference(net, ipe, dirs, g, K, stash,
                                           accumulate=torch.float64)
    print(f"{tag}: kernel vs plain {worst(kern, p32)}; kernel vs float64 "
          f"{worst(kern, p64)}; plain vs float64 {worst(p32, p64)}; stages "
          + ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                      for k, v in stages.items()), flush=True)


def flip_witness(hidden, net, ipe, dirs, g, stash):
    """Mean share over the trunk products of bf16 cotangent elements that
    differ from the rounded float64 product: kernel, float32, bf16 tensor
    cores."""
    _, _, ws, kw = cs._b2_launch(torch, net, ipe, dirs, g, K, stash, False)
    hid = fk.kernel_width(hidden)
    gt = cs._b2_slabs(torch, ws, ipe.shape[0], hid)["gt"]
    w = cs._packed_mats(kw, kw.w, hid)
    share = {"kernel": 0.0, "float32": 0.0, "bf16 tensor cores": 0.0,
             "kernel vs tensor cores": 0.0}
    prods = [(8, 7)] + [(i, i - 1) for i in range(7, 0, -1)]
    for layer, out in prods:
        wm = w[layer][:, 96:] if layer == 5 else w[layer]
        gin, mask = gt[layer], stash.trunk[out] > 0
        want = torch.where(mask, gin.double() @ wm, 0.0).to(torch.bfloat16)
        got = {"kernel": gt[out],
               "float32": (gin.float() @ wm.float()).to(torch.bfloat16),
               "bf16 tensor cores": gin @ wm.to(torch.bfloat16)}
        for name, t in got.items():
            got[name] = t = torch.where(mask, t, torch.zeros_like(t))
            share[name] += (t != want).double().mean().item() / len(prods)
        share["kernel vs tensor cores"] += (
            got["kernel"] != got["bf16 tensor cores"]).double().mean().item(
            ) / len(prods)
    print(f"H={hidden} trunk products (K={hidden}): bf16 elements off the "
          f"rounded float64 product, mean share: " + ", ".join(
              f"{k} {v:.3e}" for k, v in share.items()), flush=True)


def faulted_library(directory, name, old, new, this_lib):
    """This tree's backward with ``old`` replaced by ``new``, built into
    ``directory``; the entry points that ``_b2_launch`` calls."""
    src = os.path.join(directory, "csrc")
    shutil.copytree(build.CSRC, src)
    path = os.path.join(src, "fused_mlp_bwd.cu")
    with open(path) as f:
        text = f.read()
    if text.count(old) != 1:
        raise SystemExit(f"fault {name!r}: its text is not in the source once")
    with open(path, "w") as f:
        f.write(text.replace(old, new))
    so = os.path.join(directory, "fault.so")
    proc = subprocess.run(
        [build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so,
         path], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on fault {name!r}:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    fns = {"ddnerf_cuda_error_string": this_lib.ddnerf_cuda_error_string}
    for entry in ("ddnerf_fused_mlp_bwd_workspace", "ddnerf_fused_mlp_bwd"):
        fn = getattr(lib, entry)
        fn.argtypes = getattr(this_lib, entry).argtypes
        fn.restype = getattr(this_lib, entry).restype
        fns[entry] = fn
    return types.SimpleNamespace(**fns)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--no-faults", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    this_lib = build.load_library()
    for hidden in WIDTHS:
        net, ipe, dirs, g = cs._exact_case(torch, DepthMipMLP, hidden, RAYS,
                                           K, dev, hidden + 1)
        out, stash = fk.fused_mlp_forward(net, ipe, dirs, K, stash=True)
        want = ref.fused_mlp_reference(net, ipe, dirs, K)
        grads = fk.fused_mlp_backward(net, ipe, dirs, g, K, stash)
        plain = ref.fused_mlp_backward_reference(net, ipe, dirs, g, K, stash)
        top = max((rel(grads[m], plain[m]), m) for m in plain)
        print(f"H={hidden} exact-integer data: B1 max |kernel - plain| "
              f"{(out - want).abs().max().item():.3e} (outputs up to "
              f"{want.abs().max().item():.3e}); B2 worst leaf "
              f"{top[0]:.3e} ({top[1]})", flush=True)
        for s in range(args.seeds):
            case = random_case(hidden, hidden + s, dev)
            readings(f"H={hidden} seed {hidden + s}", *case)
            if s == 0:
                flip_witness(hidden, *case)
    if args.no_faults:
        return
    with tempfile.TemporaryDirectory(prefix="b2_faults_") as tmp:
        for i, (name, old, new) in enumerate(FAULTS):
            d = os.path.join(tmp, str(i))
            os.makedirs(d)
            lib = faulted_library(d, name, old, new, this_lib)
            for hidden in FAULT_WIDTHS:
                readings(f"fault '{name}' H={hidden} seed {hidden}",
                         *random_case(hidden, hidden, dev), lib=lib)


if __name__ == "__main__":
    main()
