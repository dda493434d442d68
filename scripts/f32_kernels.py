"""The float32 kernels on the card, alone: build the kernel library (and,
beside it, the single-pass TF32 fault library), print ptxas' registers,
spill bytes and advisories of every kernel of ``csrc/fused_mlp_f32.cu``,
then run ``chip_smoke.py``'s phase 18: the TF32 split of the weight pack
against its plain version bit for bit, B1, B3, B1s and B2 at float32
against their plain versions at widths 256, 64, 192 and 512 (main shapes
and a ragged 333 x 33), their times beside their bounds, and the readings
of the three faults the limits must separate.

    python scripts/f32_kernels.py [--log DIR]
    python scripts/f32_kernels.py --other DIR [--reps 10]

``--log DIR`` also writes the full build log there.  ``--other DIR`` runs
a same-call A/B instead: ``DIR`` holds another version of
``fused_mlp_f32.cu`` and the headers it includes (for a parent commit:
``git show REV:ddnerf_tpu_torch/kernels/csrc/F > DIR/F`` for each file),
with the same C entry points; it is compiled with nvcc for sm_90a into
``DIR/other.so``.  B1, B1s and B3 (DepthMipMLP, a render chunk of 16384 x
32 rows and the training batch of 2048 x 32) and B2 (the training batch)
are then timed with CUDA events, medians of ``--reps``, at widths 64, 192,
256 and 512, in the order other, this, this, other, beside the plain
versions (float32, TF32 off), and the two libraries' outputs are compared
(forwards max |d|, B2 the largest per-leaf norm-relative gap).  The other
library is handed this tree's pack, whose first plane is the packed
float32 weights that a library of one plane reads.  The first line is the
card's name and power limit.  Needs a GPU.
"""

import argparse
import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRIES = ("ddnerf_fused_mlp_fwd_f32", "ddnerf_fused_enc_mlp_fwd_f32",
           "ddnerf_fused_mlp_bwd_workspace_f32", "ddnerf_fused_mlp_bwd_f32")
AB_WIDTHS = (64, 192, 256, 512)


class _Mixed:
    """This library, with ENTRIES taken from ``other``."""

    def __init__(self, this, other):
        self._this, self._other = this, other

    def __getattr__(self, name):
        return getattr(self._other if name in ENTRIES else self._this, name)


def _build_other(directory, this_lib, build):
    so = os.path.join(directory, "other.so")
    cmd = [build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so,
           os.path.join(directory, "fused_mlp_f32.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {directory}:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    for name in ENTRIES:
        getattr(lib, name).argtypes = getattr(this_lib, name).argtypes
        getattr(lib, name).restype = getattr(this_lib, name).restype
    return _Mixed(this_lib, lib)


def ab(torch, other_dir, reps):
    """The same-call A/B of this tree's float32 kernels against ``other_dir``'s."""
    import chip_smoke as cs
    from ddnerf_tpu_torch.core.math import integrated_pos_enc
    from ddnerf_tpu_torch.kernels import build
    from ddnerf_tpu_torch.kernels import fused_mlp as fk
    from ddnerf_tpu_torch.kernels import reference as ref
    from ddnerf_tpu_torch.models.mlp import DepthMipMLP

    this_lib = build.load_library()
    libs = {"other": _build_other(other_dir, this_lib, build),
            "this": this_lib}
    load = build.load_library
    dev = torch.device("cuda")
    k = cs.SAMPLES
    for hidden in AB_WIDTHS:
        gen = torch.Generator().manual_seed(hidden + 12)
        net = DepthMipMLP(hidden_size=hidden, compute_dtype=torch.float32,
                          generator=gen).to(dev)
        n, nt = cs.CHUNK_RAYS * k, cs.TRAIN_RAYS * k
        means, covs = cs._gaussians(torch, gen, n, dev)
        ipe = integrated_pos_enc((means, covs), double_angle=False)
        dirs = (torch.rand(cs.CHUNK_RAYS, 27, generator=gen) * 2 - 1).to(dev)
        t_ipe, t_dirs = ipe[:nt].contiguous(), dirs[:cs.TRAIN_RAYS].contiguous()
        g = torch.randn(nt, net.out_dim, generator=gen).to(dev)
        _, stash = fk.fused_mlp_forward(net, t_ipe, t_dirs, k, stash=True)
        calls = {
            "B1": lambda: fk.fused_mlp_forward(net, ipe, dirs, k),
            "B1s": lambda: fk.fused_mlp_forward(net, t_ipe, t_dirs, k,
                                                stash=True)[0],
            "B3": lambda: fk.fused_enc_mlp_forward(net, means, covs, dirs, k),
            "B2": lambda: fk.fused_mlp_backward(net, t_ipe, t_dirs, g, k,
                                                stash),
        }
        plain = {
            "B1": lambda: ref.fused_mlp_reference(net, ipe, dirs, k),
            "B1s": lambda: ref.fused_mlp_stash_reference(net, t_ipe, t_dirs,
                                                         k),
            "B3": lambda: ref.fused_enc_mlp_reference(net, means, covs, dirs,
                                                      k),
            "B2": lambda: ref.fused_mlp_backward_reference(
                net, t_ipe, t_dirs, g, k, stash),
        }
        outs, times = {}, {name: {"other": [], "this": []} for name in calls}
        for which in ("other", "this", "this", "other"):
            build.load_library = lambda flags=(), lib=libs[which]: lib
            outs[which] = {name: fn() for name, fn in calls.items()}
            for name, fn in calls.items():
                times[name][which].append(cs._event_ms(torch, fn, reps))
        build.load_library = load
        plain_ms = {name: cs._event_ms(torch, fn, reps)
                    for name, fn in plain.items()}
        torch.cuda.synchronize()
        for name in calls:
            a, b = outs["this"][name], outs["other"][name]
            if name == "B2":
                gap = max(cs._rel(a[x], b[x]) for x in a)
                what = "largest norm_rel"
            else:
                gap = (a - b).abs().max().item()
                what = "max |d|"
            o, t = times[name]["other"], times[name]["this"]
            print(f"[ab-f32] DepthMipMLP H={hidden} {name} "
                  f"({nt if name in ('B1s', 'B2') else n} rows): other "
                  f"{o[0]:.3f} / {o[1]:.3f} ms, this {t[0]:.3f} / {t[1]:.3f} "
                  f"ms, plain {plain_ms[name]:.3f} ms; this vs other {what} "
                  f"{gap:.3e}", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log", help="directory for the full build log")
    parser.add_argument("--other",
                        help="directory with another fused_mlp_f32.cu: A/B")
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from ddnerf_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        sys.exit("scripts/f32_kernels.py needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_device(torch)
    if not args.other:
        cs.start_fault_build()
    info = build.build()
    if args.log:
        os.makedirs(args.log, exist_ok=True)
        with open(os.path.join(args.log, "build.log"), "w") as f:
            f.write(info.log)
    print(f"[build] {info.path.name} in {info.seconds:.1f} s", flush=True)
    for r in build.ptxas_report(info.log):
        if r.name.startswith(("float_", "tf32_")):
            print(f"[build]   {r.name}: {r.registers} registers, "
                  f"{r.spill_bytes} spill bytes"
                  + "".join(f"; {a}" for a in r.advisories), flush=True)
    build.load_library()
    if args.other:
        ab(torch, args.other, args.reps)
    else:
        cs.phase_f32_kernels(torch)


if __name__ == "__main__":
    main()
