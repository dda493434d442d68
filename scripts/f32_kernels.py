"""The float32 kernels on the card, alone: build the kernel library (and,
beside it, the single-pass TF32 fault library), print ptxas' registers,
spill bytes and advisories of every kernel of ``csrc/fused_mlp_f32.cu``,
then run ``chip_smoke.py``'s phase 18: B1, B3, B1s and B2 at float32
against their plain versions at widths 256, 64, 192 and 512 (main shapes
and a ragged 333 x 33), their times beside their bounds, and the readings
of the three faults the limits must separate.

    python scripts/f32_kernels.py [--log DIR]

``--log DIR`` also writes the full build log there.  Needs a GPU.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log", help="directory for the full build log")
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from ddnerf_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        sys.exit("scripts/f32_kernels.py needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_device(torch)
    cs.start_fault_build()
    info = build.build()
    if args.log:
        os.makedirs(args.log, exist_ok=True)
        with open(os.path.join(args.log, "build.log"), "w") as f:
            f.write(info.log)
    print(f"[build] {info.path.name} in {info.seconds:.1f} s", flush=True)
    for r in build.ptxas_report(info.log):
        if r.name.startswith("float_"):
            print(f"[build]   {r.name}: {r.registers} registers, "
                  f"{r.spill_bytes} spill bytes"
                  + "".join(f"; {a}" for a in r.advisories), flush=True)
    build.load_library()
    cs.phase_f32_kernels(torch)


if __name__ == "__main__":
    main()
