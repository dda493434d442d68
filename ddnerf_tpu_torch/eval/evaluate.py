"""Model evaluation.

Counterpart of ``ddnerf_tpu/eval/evaluate.py::eval_model`` (reference
eval_nerf.py:20-165): reads the config snapshot and a reference-format
``checkpoint.ckpt`` from a logdir, renders up to ``max_images`` validation
views, computes PSNR and the two SSIM variants per image for the coarse and
fine cycles, and writes ``validation/results.txt``.

LPIPS is reported as unavailable, as the JAX package does without local
AlexNet weights (its scorer is JAX code).  The point cloud and image dumps
of the JAX package's eval, and reading its orbax checkpoints, come later.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict

import torch

from ddnerf_tpu_torch.data.assembly import get_datasets
from ddnerf_tpu_torch.eval.metrics import calc_ssim, psnr
from ddnerf_tpu_torch.viz.visualization import write_dicts_to_a_file
from ddnerf_tpu_torch.models.nerf import NerfPipeline, ScheduleValues
from ddnerf_tpu_torch.render.renderer import ImageRenderer
from ddnerf_tpu_torch.train.checkpoint import (
    CHECKPOINT_NAME,
    load_config_snapshot,
)
from ddnerf_tpu_torch.utils.weights import load_checkpoint

MAX_VALIDATION_IMAGES = 10  # eval_nerf.py:18


def resolve_device(name: str) -> torch.device:
    """The requested device; asking for CUDA without one is an error, never
    a silent run on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False; pass --device cpu to evaluate on the CPU")
    return device


def load_pipeline(basedir: str, cfg, dev: torch.device,
                  torch_checkpoint: str | None = None) -> NerfPipeline:
    """The run's networks on ``dev``, from ``torch_checkpoint`` (default
    ``basedir/checkpoint.ckpt``)."""
    ckpt_path = torch_checkpoint or os.path.join(basedir, CHECKPOINT_NAME)
    if not os.path.isfile(ckpt_path):
        raise FileNotFoundError(
            f"no {CHECKPOINT_NAME} at {ckpt_path!r}: the port reads "
            "reference-format torch checkpoints (pass --torch-checkpoint); "
            "orbax checkpoints of the JAX package are not readable yet")
    ckpt = load_checkpoint(ckpt_path)
    pipeline = NerfPipeline(cfg, dev)
    pipeline.load_state_dicts(ckpt["coarse"], ckpt["fine"])
    print(f"loaded {ckpt_path} (iter {ckpt['step']}) on {dev}")
    return pipeline


def eval_model(
    basedir: str,
    max_images: int = MAX_VALIDATION_IMAGES,
    torch_checkpoint: str | None = None,
    device: str = "cuda",
):
    """Evaluate the run in ``basedir``.  ``torch_checkpoint``: the
    ``checkpoint.ckpt`` to load (default ``basedir/checkpoint.ckpt``).
    Returns ``(summary, per_image)`` as the JAX ``eval_model`` does."""
    dev = resolve_device(device)
    savedir = os.path.join(basedir, "validation")
    os.makedirs(savedir, exist_ok=True)
    results_file = os.path.join(savedir, "results.txt")

    cfg = load_config_snapshot(basedir)
    _, val_ds, cfg = get_datasets(cfg)
    pipeline = load_pipeline(basedir, cfg, dev, torch_checkpoint)

    sched = ScheduleValues.for_eval(cfg)  # eval-time fixup, eval_nerf.py:53-55
    renderer = ImageRenderer(cfg, pipeline)

    summary = defaultdict(list)
    per_image = {}
    n_images = min(max_images, len(val_ds))
    poses_gts = [val_ds.get_next_validation_pose() for _ in range(n_images)]
    outs = renderer.render_images_from_poses(
        [p for p, _ in poses_gts], val_ds.H, val_ds.W, val_ds.focal,
        sched=sched)
    model_time = []
    for i, (_, gt) in enumerate(poses_gts):
        t0 = time.perf_counter()
        out = next(outs)  # maps arrive on the host: the device work is done
        model_time.append(time.perf_counter() - t0)

        res = {
            "psnr_coarse": psnr(out[0]["rgb"], gt),
            "psnr_fine": psnr(out[1]["rgb"], gt),
        }
        res["ssim_v1_coarse"], res["ssim_v2_coarse"] = calc_ssim(
            out[0]["rgb"], gt)
        res["ssim_v1_fine"], res["ssim_v2_fine"] = calc_ssim(out[1]["rgb"], gt)
        per_image[i] = res
        for k, v in res.items():
            summary[k].append(v)
        print(f"image {i}: " + " ".join(f"{k}={v:.4f}" for k, v in res.items()))

    summary["model_time_sec"] = model_time
    write_dicts_to_a_file(summary, per_image, results_file)
    print("lpips: unavailable (no LPIPS scorer in the port yet)")
    print(f"avg model time per image: {sum(model_time) / len(model_time):.2f}s"
          f" on {dev}")
    print(f"results written to {results_file}")
    return summary, per_image
