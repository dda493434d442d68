"""Model evaluation.

Counterpart of ``ddnerf_tpu/eval/evaluate.py::eval_model`` (reference
eval_nerf.py:20-165): reads the config snapshot and a reference-format
checkpoint from a logdir (the newest, a retained step, or a file given by
path), renders up to ``max_images`` validation views, computes PSNR and the
two SSIM variants per image for the coarse and fine cycles, writes
``validation/results.txt`` and, on request, the image dumps
(``validation/{i}/*.png``), a point cloud per image
(``validation/ptc_{i}.npy``) and, under
``train_params.depth_analysis_rays``, the per-ray figures
(``validation/rays/ray_{j}.png``) with ``validation/ray_dict.pkl``.
``lpips_weights`` (a local AlexNet-LPIPS ``.npz``, ``eval/lpips_net.py``)
adds ``lpips_coarse`` / ``lpips_fine``; a missing or unreadable file omits
them with a warning.

Under ``torchrun`` with more than one rank every rank renders its share of
each image (``render/renderer.py``) and rank 0 alone computes the metrics,
prints and writes, as the JAX package's process 0 does.  Orbax checkpoints
of the JAX package are not read (the port imports no orbax).
"""

from __future__ import annotations

import os
import pickle
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from ddnerf_tpu_torch.data.assembly import get_datasets
from ddnerf_tpu_torch.data.images import write_image
from ddnerf_tpu_torch.eval.depth_analysis import run_depth_analysis
from ddnerf_tpu_torch.eval.metrics import Lpips, calc_ssim, psnr
from ddnerf_tpu_torch.viz.visualization import (
    get_density_distribution_plots,
    save_validation_images,
    write_dicts_to_a_file,
)
from ddnerf_tpu_torch.models.nerf import NerfPipeline, ScheduleValues
from ddnerf_tpu_torch.parallel.mesh import maybe_mesh
from ddnerf_tpu_torch.render.renderer import ImageRenderer
from ddnerf_tpu_torch.train.checkpoint import (
    checkpoint_path,
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
                  torch_checkpoint: Optional[str] = None,
                  checkpoint_step: Optional[int] = None,
                  mesh=None) -> NerfPipeline:
    """The run's networks on ``dev``, from ``torch_checkpoint`` if given,
    else the retained ``checkpoint_step`` of ``basedir``, else its newest
    (``basedir/checkpoint.ckpt``).  A checkpoint of the other model family
    (one network where the config needs two, or the reverse) raises.
    ``mesh``: this rank's data-parallel group, or None."""
    ckpt_path = torch_checkpoint or checkpoint_path(basedir, checkpoint_step)
    ckpt = load_checkpoint(ckpt_path)
    pipeline = NerfPipeline(cfg, dev, mesh=mesh)
    pipeline.load_state_dicts(ckpt["coarse"], ckpt["fine"])
    if mesh is None or mesh.primary:
        print(f"loaded {ckpt_path} (iter {ckpt['step']}) on {dev}")
    return pipeline


def _write_depth_analysis(cfg, pipeline, val_ds, sched, savedir: str) -> None:
    """The depth-analysis pass (eval_nerf.py:66-89): one figure per
    annotated ray and the pickled curves."""
    ray_plots_dir = os.path.join(savedir, "rays")
    os.makedirs(ray_plots_dir, exist_ok=True)
    da_o, da_d, da_r, da_depth, _ = val_ds.load_depth_analysis_rays(cfg)
    da_out = run_depth_analysis(cfg, pipeline, da_o, da_d, da_r, sched)
    for j in range(len(da_depth)):
        img = get_density_distribution_plots(
            da_out, j, da_depth, cfg.dataset.near, cfg.dataset.far,
            tb_mode=False)
        write_image(os.path.join(ray_plots_dir, f"ray_{j}.png"),
                    img.transpose(1, 2, 0))
    with open(os.path.join(savedir, "ray_dict.pkl"), "wb") as f:
        pickle.dump(da_out, f)


def eval_model(
    basedir: str,
    extract_ptc: bool = False,
    save_images: bool = True,
    lpips_weights: Optional[str] = None,
    max_images: int = MAX_VALIDATION_IMAGES,
    torch_checkpoint: Optional[str] = None,
    checkpoint_step: Optional[int] = None,
    device: str = "cuda",
):
    """Evaluate the run in ``basedir``.  ``torch_checkpoint``: a checkpoint
    file to load instead of the logdir's; ``checkpoint_step``: a retained
    step of the logdir (default: the newest).  ``save_images`` dumps the
    maps of each image and ``gt.png``; ``extract_ptc`` a point cloud per
    image; ``lpips_weights`` the LPIPS metrics.  Returns ``(summary,
    per_image)`` as the JAX ``eval_model`` (on rank 0; empty on the other
    ranks of a group)."""
    savedir = os.path.join(basedir, "validation")
    results_file = os.path.join(savedir, "results.txt")
    cfg = load_config_snapshot(basedir)
    mesh = maybe_mesh(cfg, device)
    dev = resolve_device(device) if mesh is None else mesh.device
    primary = mesh is None or mesh.primary
    if primary:
        os.makedirs(savedir, exist_ok=True)

    _, val_ds, cfg = get_datasets(cfg)
    pipeline = load_pipeline(basedir, cfg, dev, torch_checkpoint,
                             checkpoint_step, mesh)

    sched = ScheduleValues.for_eval(cfg)  # eval-time fixup, eval_nerf.py:53-55
    renderer = ImageRenderer(cfg, pipeline)
    if cfg.train_params.depth_analysis_rays and primary:
        _write_depth_analysis(cfg, pipeline, val_ds, sched, savedir)
    lpips = Lpips(lpips_weights if primary else None, dev)

    summary = defaultdict(list)
    per_image = {}
    n_images = min(max_images, len(val_ds))
    poses_gts = [val_ds.get_next_validation_pose() for _ in range(n_images)]
    outs = renderer.render_images_from_poses(
        [p for p, _ in poses_gts], val_ds.H, val_ds.W, val_ds.focal,
        sched=sched)
    model_time = []
    for i, (pose, gt) in enumerate(poses_gts):
        t0 = time.perf_counter()
        out = next(outs)  # maps arrive on the host: the device work is done
        model_time.append(time.perf_counter() - t0)
        if not primary:
            continue

        if extract_ptc:
            # xyz = rd * depth + ro (eval_nerf.py:113-122), from the same
            # (possibly NDC-projected) rays the render used.
            ro, rd, _ = val_ds._bundle(pose)
            xyz = rd * out[1]["depth"][..., None] + ro
            rgbs = np.clip(out[1]["rgb"], 0, 1)
            np.save(os.path.join(savedir, f"ptc_{i}.npy"),
                    np.concatenate([xyz.reshape(-1, 3), rgbs.reshape(-1, 3)],
                                   axis=-1))
        if save_images:
            img_dir = os.path.join(savedir, str(i))
            save_validation_images(out, img_dir)
            write_image(os.path.join(img_dir, "gt.png"),
                        (np.clip(gt, 0, 1) * 255).astype(np.uint8))

        res = {
            "psnr_coarse": psnr(out[0]["rgb"], gt),
            "psnr_fine": psnr(out[1]["rgb"], gt),
        }
        res["ssim_v1_coarse"], res["ssim_v2_coarse"] = calc_ssim(
            out[0]["rgb"], gt)
        res["ssim_v1_fine"], res["ssim_v2_fine"] = calc_ssim(out[1]["rgb"], gt)
        if lpips.available:
            res["lpips_coarse"] = lpips(out[0]["rgb"], gt)
            res["lpips_fine"] = lpips(out[1]["rgb"], gt)
        per_image[i] = res
        for k, v in res.items():
            summary[k].append(v)
        print(f"image {i}: " + " ".join(f"{k}={v:.4f}" for k, v in res.items()))

    if not primary:
        return {}, {}
    summary["model_time_sec"] = model_time
    write_dicts_to_a_file(summary, per_image, results_file)
    print(f"avg model time per image: {sum(model_time) / len(model_time):.2f}s"
          f" on {dev}")
    print(f"results written to {results_file}")
    return summary, per_image
