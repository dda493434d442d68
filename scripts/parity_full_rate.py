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
``lr_delay_mult`` 0.01), as ``chip_smoke.py`` holds them.

    python3 scripts/parity_full_rate.py --render

instead asks whether the fine network's render survives 40 training steps
from step 0 at a given learning rate, at several widths, with the kernels
and with the plain path: each case of ``RENDER_CASES`` trains 40 eager
steps from one seed, then renders the first validation image and prints
the loss over the first and the last 20 steps and, per cycle, the rendered
rgb's min, max and standard deviation.  A fine render whose min and max
are both 0 is black: the eval's ``ssim_v2`` (data range max - min) is then
NaN.  This is why ``chip_smoke.py``'s coarse-600 / fine-1024 CLI runs
(``BIG_TRAIN_OPTS``) start at ``lr_init`` 1e-4.

The first line is the card's name and power limit.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from ddnerf_tpu_torch.kernels import reference as ref  # noqa: E402

FULL_RATE = ("optimizer.lr_delay_steps", "0")
NARROW = ("nerf.coarse_hidden_size", "256", "nerf.fine_hidden_size", "256")
RENDER_STEPS = 40
# (label, parallel.pallas_mlp, coarse / fine widths, other overrides)
RENDER_CASES = (
    ("kernel full-rate", "auto", (600, 1024), FULL_RATE),
    ("plain full-rate", "off", (600, 1024), FULL_RATE),
    ("kernel 192/512 full-rate", "auto", (192, 512), FULL_RATE),
    ("kernel lr 1e-4", "auto", (600, 1024),
     (*FULL_RATE, "optimizer.lr_init", "1e-4")),
    ("kernel schedule", "auto", (600, 1024), ()),
    ("kernel full-rate 256", "auto", (256, 256), FULL_RATE),
    ("kernel 256/1024 lr 1e-4", "auto", (256, 1024),
     (*FULL_RATE, "optimizer.lr_init", "1e-4")),
    ("plain 256/1024 lr 1e-4", "off", (256, 1024),
     (*FULL_RATE, "optimizer.lr_init", "1e-4")),
    ("kernel 256/1024 lr 2e-4", "auto", (256, 1024),
     (*FULL_RATE, "optimizer.lr_init", "2e-4")),
    ("kernel 256/1024 full-rate", "auto", (256, 1024), FULL_RATE),
    ("kernel 256/1024 schedule", "auto", (256, 1024), ()),
)


def plain_backward(accumulate):
    def backward(net, ipe, dirs, g, k, stash, per_ray_dirs=False):
        grads = ref.fused_mlp_backward_reference(
            net, ipe, dirs, g, k, stash, per_ray_dirs, accumulate)
        return {name: t.float() for name, t in grads.items()}
    return backward


def render_probe():
    """Each of :data:`RENDER_CASES`: the loss and the fine render after
    :data:`RENDER_STEPS` eager steps from step 0."""
    from ddnerf_tpu_torch.config import load_config
    from ddnerf_tpu_torch.data.assembly import get_datasets
    from ddnerf_tpu_torch.data.datasets import load_train_store
    from ddnerf_tpu_torch.models.nerf import NerfPipeline, ScheduleValues
    from ddnerf_tpu_torch.render.renderer import ImageRenderer
    from ddnerf_tpu_torch.train.state import TrainState
    from ddnerf_tpu_torch.train.step import EagerTrainStep

    dev = torch.device("cuda")
    for label, policy, (coarse, fine), opts in RENDER_CASES:
        cfg = load_config(cs.CONFIG).merge_from_list([
            "nerf.coarse_hidden_size", str(coarse),
            "nerf.fine_hidden_size", str(fine), *opts,
            "parallel.pallas_mlp", policy]).resolved()
        store, _, cfg = load_train_store(cfg, dev)
        pipe = NerfPipeline(cfg, dev, seed=0)
        state = TrainState(cfg, pipe)
        gen = torch.Generator(device=dev).manual_seed(11)
        stepper = EagerTrainStep.from_store(cfg, pipe, state, store, gen)
        t0 = time.perf_counter()
        rows = stepper.run(RENDER_STEPS)
        torch.cuda.synchronize()
        loss = rows[:, stepper.names.index("loss")].cpu()
        _, val_ds, vcfg = get_datasets(cfg)
        out = ImageRenderer(vcfg, pipe).render_image_from_pose(
            val_ds.poses[0], val_ds.H, val_ds.W, val_ds.focal,
            sched=ScheduleValues.for_eval(vcfg))
        cycles = "; ".join(
            f"cycle {c} rgb min {out[c]['rgb'].min():.4f} max "
            f"{out[c]['rgb'].max():.4f} std {out[c]['rgb'].std():.4f}"
            for c in (0, 1))
        half = RENDER_STEPS // 2
        print(f"{label}: {time.perf_counter() - t0:.1f} s, loss first "
              f"{half} {loss[:half].mean():.4f} last {half} "
              f"{loss[half:].mean():.4f}; {cycles}", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--render", action="store_true",
                        help="the fine render after 40 steps from step 0, "
                             "per width, lr and path")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    if args.render:
        render_probe()
        return
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
