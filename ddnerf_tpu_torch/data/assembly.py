"""Dataset assembly: config -> (train, val) ray datasets.

Rewrite of ``get_datasets``/``load_blender_or_llff_datasets``
(``data_utils/data_utils.py:10-81``): dispatch on
``cfg.dataset.type`` ∈ {blender, llff, real360} (+ our ``synthetic`` test
scene), blender alpha compositing (white/black background), LLFF holdout
split, pose normalization.

The reference *mutates the config* when normalizing poses (rescaling
near/far/combined_split in place, data_utils.py:67-74).  Here the function
returns the updated frozen config alongside the datasets.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.data.blender import load_blender_data
from ddnerf_tpu_torch.data.datasets import TrainRayDataset, ValRayDataset
from ddnerf_tpu_torch.data.synthetic import generate_synthetic_blender


def get_datasets(cfg: Config) -> Tuple[TrainRayDataset, ValRayDataset, Config]:
    """Build train/val datasets.  Returns ``(train, val, cfg)`` where ``cfg``
    carries any pose-normalization rescale of near/far/combined_split."""
    ds_type = cfg.dataset.type.lower()

    if ds_type in ("blender", "synthetic"):
        if cfg.dataset.synthetic or ds_type == "synthetic" or not cfg.dataset.basedir:
            images, poses, render_poses, hwf, i_split = generate_synthetic_blender(
                seed=cfg.experiment.randomseed
            )
        else:
            images, poses, render_poses, hwf, i_split = load_blender_data(
                cfg.dataset.basedir,
                half_res=cfg.dataset.half_res,
                testskip=cfg.dataset.testskip,
            )
        i_train, i_val, i_test = i_split
        focal = hwf[2]

        # Alpha-composite onto white or black (data_utils.py:34-38).
        if cfg.nerf.train.white_background:
            images = images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
        else:
            images = images[..., :3] * images[..., -1:]

    elif ds_type in ("llff", "real360"):
        from ddnerf_tpu_torch.data.llff import load_llff_data

        images, poses, bds, render_poses, i_test = load_llff_data(cfg)
        hwf = poses[0, :3, -1]
        poses = poses[:, :3, :4]
        focal = hwf[-1]

        if not isinstance(i_test, (list, np.ndarray)):
            i_test = [i_test]
        if cfg.dataset.llffhold > 0:
            i_test = np.arange(images.shape[0])[:: cfg.dataset.llffhold]
        i_val = i_test
        i_train = np.array(
            [i for i in np.arange(images.shape[0]) if i not in i_test]
        )
        render_poses = render_poses[:, :3, :4]
    else:
        raise ValueError(f"unknown dataset type {cfg.dataset.type!r}")

    if cfg.dataset.normalize_poses:
        # Pose normalization + near/far rescale (data_utils.py:67-74) — the
        # reference mutates cfg; we return a new one.
        nf = cfg.dataset.normalize_factor
        poses = np.array(poses)
        poses[:, :, 3] = poses[:, :, 3] / nf
        cfg = cfg.replace_at("dataset.near", cfg.dataset.near / nf)
        cfg = cfg.replace_at("dataset.far", cfg.dataset.far / nf)
        cfg = cfg.replace_at("dataset.combined_split", cfg.dataset.combined_split / nf)

    train_dataset = TrainRayDataset(
        poses[i_train],
        images[i_train],
        focal,
        ndc_rays=cfg.dataset.ndc_rays,
        single_image_mode=cfg.dataset.single_image_mode,
    )
    val_dataset = ValRayDataset(
        poses[i_val],
        images[i_val],
        focal,
        ndc_rays=cfg.dataset.ndc_rays,
        cfg=cfg,
        render_poses=render_poses,
    )
    return train_dataset, val_dataset, cfg
