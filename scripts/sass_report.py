"""What the compiled fused-MLP kernels are made of: per ``__global__``
function of the port's CUDA library, the number of warpgroup products
(``HGMMA``), TMA loads and stores (``UTMALDG`` / ``UTMASTG``), mbarrier
operations (``SYNCS``), older tensor-core products (``HMMA``) and atomics
(``ATOM`` / ``RED``) in its SASS, beside ptxas' registers and spills.

    python3 scripts/sass_report.py

Builds the library as the wrappers do (nvcc for sm_90a) and disassembles it
with ``cuobjdump -sass``.  Needs the CUDA toolkit, not a GPU.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ddnerf_tpu_torch.kernels import build  # noqa: E402

OPCODES = ("HGMMA", "UTMALDG", "UTMASTG", "SYNCS", "HMMA", "ATOM", "RED")


def main():
    info = build.build()
    ptxas = {r.name: r for r in build.ptxas_report(info.log)}
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(info.path)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\w+)", line)
        if m:
            name = build.kernel_name(m.group(1))
            counts[name] = dict.fromkeys(OPCODES, 0)
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_]+)", line)
        if m and name:
            op = "ATOM" if m.group(1).startswith("ATOM") else m.group(1)
            if op in counts[name]:
                counts[name][op] += 1
    for name, c in counts.items():
        r = ptxas.get(name)
        regs = (f"{r.registers} registers, {r.spill_bytes} spill bytes"
                if r else "no ptxas line (cached build)")
        print(f"{name}: " + ", ".join(f"{k} {v}" for k, v in c.items())
              + f"; {regs}")


if __name__ == "__main__":
    main()
