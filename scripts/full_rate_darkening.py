"""Does the fine render go black at the full learning rate from step 0, and
what makes it?  A bisection from the case where a card went dark.

    python3 scripts/full_rate_darkening.py [--device cpu|cuda] [--cases A,B]
        [--seeds 11,12,13] [--steps 40] [--policy off|auto] [--threads N]
        [--host-batches] [--grid 'C,F,R,S;...'] [dot.path value ...]

trains the port alone (:data:`CASES`; each case ``configs/synthetic_smoke.yml``
with ``optimizer.lr_delay_steps 0``, the rate ``lr_init`` 5e-4 from the
first step, and the overrides named, then those given) for ``--steps``
eager steps from the pipeline's seeded weights, once per ``--seeds`` seed
of the training generator (ray draws, jitter, density noise), then renders
the first validation image and prints per cycle the rgb's min, max and
standard deviation, and ``dark`` when the fine rgb's min and max are both
below :data:`DARK_LEVEL` (``scripts/parity_full_rate.py --render`` printed
them at four decimals: 0.0000 / 0.0000 was its black).  ``--host-batches``
draws the rays on the host from ``default_rng(seed)``, so that a case
without draws (``no-draws``) is the same run on every device; ``--grid``
runs each case at each shape of coarse width, fine width, rays per step
and samples per cycle.

    python3 scripts/full_rate_darkening.py --cotrain [--cases A,B]
        [--dtype bfloat16|float32] [--rays N] [dot.path value ...]

co-trains the JAX package and the port from one JAX initialization on the
same host batches (``tests/test_torch_port_full_rate.py::cotrain_renders``)
in each case whose draws both packages can share (no perturbation, no
density noise) and prints both packages' fine PSNR and fine rgb statistics
on the validation views.  This mode imports JAX and runs on the CPU only.

The first line is the device: the card's name and power limit on a GPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CONFIG = os.path.join(REPO, "configs", "synthetic_smoke.yml")
FULL_RATE = ("optimizer.lr_delay_steps", "0")
DARK_LEVEL = 5e-5
NO_NOISE = ("nerf.train.radiance_field_noise_std", "0.0")
NO_PERTURB = ("nerf.train.perturb", "false")
# name -> (config overrides, True when the scene is the written blender
# scene of tests/test_torch_port_quality.py instead of the procedural one).
CASES = {
    "card": ((), False),
    "no-noise": (NO_NOISE, False),
    "no-perturb": (NO_PERTURB, False),
    "no-draws": (NO_NOISE + NO_PERTURB, False),
    "scene": ((), True),
    "batch-1024": (("nerf.train.num_random_rays", "1024"), False),
    "batch-512": (("nerf.train.num_random_rays", "512"), False),
    "no-draws-batch-512": (NO_NOISE + NO_PERTURB + (
        "nerf.train.num_random_rays", "512"), False),
    "samples-16": (("nerf.train.num_coarse", "16", "nerf.train.num_fine",
                    "16", "nerf.validation.num_coarse", "16",
                    "nerf.validation.num_fine", "16"), False),
    "192x512": (("nerf.coarse_hidden_size", "192", "nerf.fine_hidden_size",
                 "512"), False),
    "600x1024": (("nerf.coarse_hidden_size", "600", "nerf.fine_hidden_size",
                  "1024"), False),
    "no-draws-600x1024": (NO_NOISE + NO_PERTURB + (
        "nerf.coarse_hidden_size", "600", "nerf.fine_hidden_size", "1024"),
        False),
}


def _write_scene(path):
    """The 32 x 32 blender scene of tests/test_torch_port_quality.py."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_synthetic_dataset_torch",
        os.path.join(REPO, "scripts", "make_synthetic_dataset_torch.py"))
    writer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(writer)
    if not os.path.exists(os.path.join(path, "transforms_train.json")):
        writer.main([path, "--size", "32", "--train", "8", "--val", "2",
                     "--test", "1", "--seed", "1"])
    return ["dataset.synthetic", "false", "dataset.basedir", path,
            "dataset.single_image_mode", "false"]


def case_opts(name, scene_dir):
    opts, written = CASES[name]
    return [*FULL_RATE, *opts, *(_write_scene(scene_dir) if written else ())]


def rgb_stats(rgb):
    """(min, max, std) of an rgb map, and whether it is black."""
    lo, hi, sd = float(rgb.min()), float(rgb.max()), float(rgb.std())
    return lo, hi, sd, abs(lo) < DARK_LEVEL and abs(hi) < DARK_LEVEL


def port_alone(dev, name, opts, policy, seed, steps, host_batches=False,
               label=""):
    """One case on ``dev``: ``steps`` eager steps, then the first
    validation image -> whether the fine render is black.  With
    ``host_batches`` the rays are drawn on the host by ``default_rng(seed)``
    (``PrefetchedHostBatches``), the same rays on every device, and the
    training generator draws only the jitter and the density noise."""
    from ddnerf_tpu_torch.config import load_config
    from ddnerf_tpu_torch.data.assembly import get_datasets
    from ddnerf_tpu_torch.data.datasets import (
        PrefetchedHostBatches,
        load_train_store,
    )
    from ddnerf_tpu_torch.models.nerf import NerfPipeline, ScheduleValues
    from ddnerf_tpu_torch.render.renderer import ImageRenderer
    from ddnerf_tpu_torch.train.state import TrainState
    from ddnerf_tpu_torch.train.step import EagerTrainStep

    cfg = load_config(CONFIG).merge_from_list(
        [*opts, "parallel.pallas_mlp", policy]).resolved()
    pipe = NerfPipeline(cfg, dev, seed=0)
    state = TrainState(cfg, pipe)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if host_batches:
        train_ds, _, cfg = get_datasets(cfg)
        batches = PrefetchedHostBatches(train_ds,
                                        cfg.nerf.train.num_random_rays, seed,
                                        dev, steps_expected=steps + 1)
        stepper = EagerTrainStep(cfg, pipe, state, batches.take, gen,
                                 after_dispatch=batches.prefetch)
    else:
        store, _, cfg = load_train_store(cfg, dev)
        stepper = EagerTrainStep.from_store(cfg, pipe, state, store, gen)
    t0 = time.perf_counter()
    rows = stepper.run(steps)
    loss = rows[:, stepper.names.index("loss")].cpu()
    _, val_ds, vcfg = get_datasets(cfg)
    out = ImageRenderer(vcfg, pipe).render_image_from_pose(
        val_ds.poses[0], val_ds.H, val_ds.W, val_ds.focal,
        sched=ScheduleValues.for_eval(vcfg))
    half = steps // 2
    density = raw_density(cfg, pipe, stepper.take())
    cycles = []
    for c in (0, 1):
        lo, hi, sd, dark = rgb_stats(out[c]["rgb"])
        cycles.append(f"cycle {c} rgb min {lo:.3e} max {hi:.3e} std "
                      f"{sd:.3e}{' dark' if dark else ''}, raw density "
                      f"{density[c][0]:.2f} to {density[c][1]:.2f}, "
                      f"sections {density[c][2]:.3g} to {density[c][3]:.3g}")
    fine_dark = rgb_stats(out[1]["rgb"])[3]
    losses = " ".join(f"{v:.6f}" for v in loss.tolist())
    print(f"[port {policy}{' host' if host_batches else ''}] {name}"
          f"{' ' + label if label else ''} seed "
          f"{seed}: {steps} steps "
          f"{time.perf_counter() - t0:.1f} s, loss first {half} "
          f"{loss[:half].mean():.4f} last {half} {loss[half:].mean():.4f}; "
          + "; ".join(cycles) + f" -> {'DARK' if fine_dark else 'lit'}; "
          f"losses {losses}", flush=True)
    return fine_dark


def raw_density(cfg, pipe, batch):
    """Per cycle, on ``batch``'s rays rendered without draws: the network's
    raw density head's min and max (softplus(density - 1) is the section's
    density) and the shortest and longest section between fenceposts."""
    from ddnerf_tpu_torch.models.nerf import RayBatch, ScheduleValues

    rays = RayBatch.create(batch["origins"], batch["directions"],
                           batch["radii"], cfg.dataset.near, cfg.dataset.far)
    with torch.no_grad():
        out = pipe.render_rays(rays, ScheduleValues.for_eval(cfg), "render")
        nets = (pipe.coarse, pipe.coarse if pipe.shared_net else pipe.fine)
        readings = []
        for c, net in enumerate(nets):
            t = out[c]["t_vals"]
            raw = pipe._run_network(net, rays, t, "render")[..., 3]
            gaps = t[..., 1:] - t[..., :-1]
            readings.append((raw.min().item(), raw.max().item(),
                             gaps.min().item(), gaps.max().item()))
    return readings


def cotrained(name, opts, dtype, steps, rays):
    """Both packages co-trained in one case -> printed readings."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_port_full_rate import cotrain_renders

    t0 = time.perf_counter()
    res = cotrain_renders(CONFIG, [*opts, "parallel.compute_dtype", dtype],
                          steps=steps, rays=rays)
    for pkg in ("port", "jax"):
        r = res[pkg]
        print(f"[cotrain {dtype}] {name} {pkg}: fine PSNR untrained "
              f"{res['untrained']:.3f} -> {r['psnr']:.3f}; fine rgb min "
              f"{r['min']:.3e} max {r['max']:.3e} std {r['std']:.3e} -> "
              f"{'DARK' if r['dark'] else 'lit'}", flush=True)
    print(f"[cotrain {dtype}] {name}: {time.perf_counter() - t0:.1f} s",
          flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--cases", default="card")
    parser.add_argument("--seeds", default="11")
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--policy", default="off", choices=("off", "auto"))
    parser.add_argument("--threads", type=int, default=0)
    parser.add_argument("--host-batches", action="store_true",
                        help="draw the rays on the host (the same on every "
                             "device)")
    parser.add_argument("--cotrain", action="store_true")
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--rays", type=int, default=0,
                        help="--cotrain: rays per step (0: the case's)")
    parser.add_argument("--grid", default="",
                        help="shapes run in turn, each case and seed at "
                             "each: 'C,F,R,S;...' = coarse / fine width, "
                             "rays per step, coarse = fine samples")
    parser.add_argument("overrides", nargs="*",
                        help="dot.path value pairs applied after the case's")
    parser.add_argument("--scene-dir", default="",
                        help="where the written scene goes (default: a "
                             "temporary directory)")
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        run(args, args.scene_dir or os.path.join(tmp, "scene"))


def run(args, scene_dir):
    """The cases of ``args`` (:func:`main`'s), the written scene in
    ``scene_dir``."""
    if args.threads:
        torch.set_num_threads(args.threads)
    cases = args.cases.split(",")
    if args.cotrain:
        print("cpu (both packages)", flush=True)
        for name in cases:
            cotrained(name, case_opts(name, scene_dir)
                      + args.overrides, args.dtype, args.steps,
                      args.rays or None)
        return
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip(), flush=True)
    else:
        print(f"cpu, {torch.get_num_threads()} threads", flush=True)
    shapes = [()]
    if args.grid:
        shapes = []
        for entry in args.grid.split(";"):
            c, f, r, n = entry.split(",")
            shapes.append((
                "nerf.coarse_hidden_size", c, "nerf.fine_hidden_size", f,
                "nerf.train.num_random_rays", r, *(
                    x for m in ("train", "validation")
                    for k in ("coarse", "fine")
                    for x in (f"nerf.{m}.num_{k}", n))))
    seeds = [int(seed) for seed in args.seeds.split(",")]
    for shape in shapes:
        for name in cases:
            dark = [port_alone(dev, name, case_opts(name, scene_dir)
                               + list(shape) + args.overrides, args.policy,
                               seed, args.steps, args.host_batches,
                               label=" ".join(shape[1:8:2]))
                    for seed in seeds]
            print(f"[summary {args.policy}"
                  f"{' host' if args.host_batches else ''}] {name}"
                  f"{' ' + ' '.join(shape[1:8:2]) if shape else ''}: dark "
                  f"in {sum(dark)} of {len(seeds)} seeds", flush=True)


if __name__ == "__main__":
    main()
