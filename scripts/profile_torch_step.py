"""Where a train step's time goes in the PyTorch port, on one NVIDIA GPU.

    python3 scripts/profile_torch_step.py [--step-mode graph|eager|ab]
        [--steps 40] [--loop-iters 200] [--top 12] [--plain]
        [--host-sampling] [dot.path value ...]
    python3 scripts/profile_torch_step.py --records LOGDIR/metrics.jsonl

Trains ``configs/synthetic_smoke.yml`` (the full DDNeRF model, 2048 rays per
step, seeded random weights; ``nerf.type GeneralMipNerfModel`` as an
override profiles the mip-NeRF step) through the fused-MLP kernels
(``pallas_mlp: auto``).  For each step mode asked for (``ab``: eager, graph,
graph, eager, the order for a comparison within one call):

* the bare step: ms/step over ``--steps`` steady steps through the mode's
  stepper (``train/step.py``), host clock ending in a synchronise, no
  metric read on the host;
* 5 steady steps under ``torch.profiler`` through ``utils/profiling.py::
  summarize``: device busy time per step, the device span, the device
  activities per step (under ``graph``: the nodes of one replay) and the
  largest kernels;
* the loop: ``train/loop.py::train`` for ``--loop-iters`` iterations in
  that mode with the config's own events (a record per iteration at the
  default ``train_scalars_every: 1``), ms/step between its last two block
  ends, from the records' time stamps.

``--plain`` adds the plain version (``pallas_mlp: off``, eager).
``--host-sampling`` adds the host-sampling loop (``parallel.max_store_gb
0``, the eager step) with and without the prefetched batch, in the order
with, without, without, with.  The first line is the card's name and power
limit.  ``--records`` only reads a finished run's ``metrics.jsonl`` (any
version of the training CLI wrote it) and prints the loop's ms/step the
same way, between its last two print events.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ddnerf_tpu_torch.config import load_config  # noqa: E402
from ddnerf_tpu_torch.data.datasets import (  # noqa: E402
    PrefetchedHostBatches,
    load_train_store,
)
from ddnerf_tpu_torch.models.nerf import NerfPipeline  # noqa: E402
from ddnerf_tpu_torch.train.loop import train  # noqa: E402
from ddnerf_tpu_torch.train.state import TrainState  # noqa: E402
from ddnerf_tpu_torch.train.step import (  # noqa: E402
    CapturedTrainStep,
    EagerTrainStep,
)
from ddnerf_tpu_torch.utils.profiling import summarize  # noqa: E402

WARMUP, PROFILED = 5, 5


def _stepper(cfg, dev, mode, store, max_block):
    pipe = NerfPipeline(cfg, dev, seed=0)
    state = TrainState(cfg, pipe)
    gen = torch.Generator(device=dev).manual_seed(11)
    if mode == "graph":
        return CapturedTrainStep(cfg, pipe, state, store, gen,
                                 max_block=max_block)
    return EagerTrainStep.from_store(cfg, pipe, state, store, gen)


def _timed(stepper, steps):
    """ms/step over ``steps`` steps after WARMUP, ending in a synchronise."""
    stepper.run(WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stepper.run(steps)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def bare_step(cfg, dev, store, tag, mode, steps, top):
    stepper = _stepper(cfg, dev, mode, store, max(steps, WARMUP, PROFILED))
    rays = cfg.nerf.train.num_random_rays
    ms = _timed(stepper, steps)
    print(f"[{tag}] bare step: {ms:.2f} ms/step over {steps} steps "
          f"({rays / ms * 1e3:,.0f} rays/s), ray draw included", flush=True)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        stepper.run(PROFILED)
        torch.cuda.synchronize()
    print(summarize(prof, PROFILED, top=top, tag=tag), flush=True)


def records_ms(path, tag):
    """ms/step between the last two train records of ``path`` that carry
    ``rays_per_sec`` (print events: the block loop's block ends)."""
    with open(path) as f:
        ends = [r for r in map(json.loads, f)
                if r["kind"] == "train" and "rays_per_sec" in r]
    a, b = ends[-2], ends[-1]
    ms = (b["time"] - a["time"]) * 1e3 / (b["step"] - a["step"])
    print(f"[{tag}] loop: {ms:.2f} ms/step over iterations {a['step'] + 1}-"
          f"{b['step']}", flush=True)


def loop_ms(cfg, tag, mode, iters):
    """The CLI's loop in ``mode`` at the config's own events and
    ``train_scalars_every``."""
    with tempfile.TemporaryDirectory(prefix="profile_step_") as logroot:
        c = cfg.replace_at("experiment.logdir", logroot)
        _, logdir = train(c, max_iters=iters, device="cuda", verbose=False,
                          step_mode=mode)
        records_ms(os.path.join(logdir, "metrics.jsonl"), tag)


def host_sampling(cfg, dev, steps):
    """The eager step fed by host-side sampling, with and without the
    batch uploaded one step ahead."""
    c = cfg.replace_at("parallel.max_store_gb", 0.0)
    train_ds, _, c = load_train_store(c, dev)
    rays = c.nerf.train.num_random_rays
    for prefetch in (True, False, False, True):
        pipe = NerfPipeline(c, dev, seed=0)
        state = TrainState(c, pipe)
        gen = torch.Generator(device=dev).manual_seed(11)
        batches = PrefetchedHostBatches(train_ds, rays, 0, dev,
                                        WARMUP + steps, prefetch=prefetch)
        ms = _timed(EagerTrainStep(c, pipe, state, batches.take, gen,
                                   after_dispatch=batches.prefetch), steps)
        print(f"[host-sampling, prefetch {'on' if prefetch else 'off'}] "
              f"{ms:.2f} ms/step over {steps} steps", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--step-mode", choices=("graph", "eager", "ab"),
                    default="graph")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--loop-iters", type=int, default=200,
                    help="0 skips the loop")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--host-sampling", action="store_true")
    ap.add_argument("--records", default="",
                    help="only read this metrics.jsonl (needs no device)")
    ap.add_argument("opts", nargs="*", default=[],
                    help="Config overrides as 'dot.path value' pairs.")
    args = ap.parse_args()
    if args.records:
        records_ms(args.records, "records")
        return
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg = load_config(os.path.join(REPO, "configs", "synthetic_smoke.yml"))
    if args.opts:
        cfg = cfg.merge_from_list(args.opts).resolved()
        print("overrides: " + " ".join(args.opts), flush=True)
    store, _, cfg = load_train_store(cfg, dev)
    modes = (("eager", "graph", "graph", "eager") if args.step_mode == "ab"
             else (args.step_mode,))
    for i, mode in enumerate(modes):
        tag = f"{mode} #{i}" if len(modes) > 1 else mode
        bare_step(cfg, dev, store, tag, mode, args.steps, args.top)
        if args.loop_iters:
            loop_ms(cfg, tag, mode, args.loop_iters)
    if args.plain:
        bare_step(cfg.replace_at("parallel.pallas_mlp", "off"), dev, store,
                  "plain, eager", "eager", args.steps, args.top)
    if args.host_sampling:
        host_sampling(cfg, dev, args.steps)


if __name__ == "__main__":
    main()
