"""How far two training trajectories drift apart at the full learning rate
from step 0, on one NVIDIA GPU: is a kernel-vs-plain loss gap there the
kernel's, or the trajectory's sensitivity to any change of accumulation?

    python3 scripts/parity_full_rate.py

``chip_smoke.py::phase_train_parity`` (20 steps from one seed on the same
batches of ``configs/synthetic_smoke.yml``; the largest relative loss gap
per step), with ``optimizer.lr_delay_steps 0``:

1. widths 256 / 256 (the shipped configs'): kernel vs plain;
2. coarse 192 / fine 512: kernel vs plain;
3. widths 256 / 256 and 4. coarse 192 / fine 512: the kernel forward with
   the plain backward accumulating in float32 against the same with the
   plain backward accumulating in float64 (the same bf16 rounding points:
   ``fused_mlp_backward_reference(accumulate=torch.float64)``): what float32
   accumulation alone moves;

then 1 and 2 on the config's schedule (``lr_delay_steps`` 2500,
``lr_delay_mult`` 0.01), as ``chip_smoke.py`` holds them.  The first line
is the card's name and power limit.  Needs a GPU.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from ddnerf_tpu_torch.kernels import reference as ref  # noqa: E402

FULL_RATE = ("optimizer.lr_delay_steps", "0")
NARROW = ("nerf.coarse_hidden_size", "256", "nerf.fine_hidden_size", "256")


def plain_backward(accumulate):
    def backward(net, ipe, dirs, g, k, stash, per_ray_dirs=False):
        grads = ref.fused_mlp_backward_reference(
            net, ipe, dirs, g, k, stash, per_ray_dirs, accumulate)
        return {name: t.float() for name, t in grads.items()}
    return backward


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    accumulations = (("plain-B2-float32", "auto", plain_backward(torch.float32)),
                     ("plain-B2-float64", "auto", plain_backward(torch.float64)))
    for tag, opts in (("full-rate 256/256", NARROW),
                      ("full-rate 192/512", cs.WIDE_OPTS)):
        cs.phase_train_parity(torch, tag, (*opts, *FULL_RATE), gate=None)
    for tag, opts in (("full-rate 256/256 accumulation", NARROW),
                      ("full-rate 192/512 accumulation", cs.WIDE_OPTS)):
        cs.phase_train_parity(torch, tag, (*opts, *FULL_RATE),
                              runs=accumulations, gate=None)
    for tag, opts in (("schedule 256/256", NARROW),
                      ("schedule 192/512", cs.WIDE_OPTS)):
        cs.phase_train_parity(torch, tag, opts, gate=None)


if __name__ == "__main__":
    main()
