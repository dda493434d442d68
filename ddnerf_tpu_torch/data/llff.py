"""LLFF / real-world-360 dataset loader.

Rewrite of ``data_utils/load_llff.py``: reads
``poses_bounds.npy`` (auto-generating it from a COLMAP sparse model if
missing), loads factor-downsampled images (cached under ``images_{f}/`` —
produced with cv2 INTER_AREA instead of shelling out to ImageMagick
``mogrify``, load_llff.py:8-60), applies the colmap→llff axis swap and
``bd_factor`` rescale, recenters, and builds the render path (spiral for
forward-facing, spherical for 360).
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.data.blender import pose_spherical_for_real_world_360
from ddnerf_tpu_torch.data.images import read_image, write_image
from ddnerf_tpu_torch.data.poses import (
    gen_poses,
    normalize,
    poses_avg,
    recenter_poses,
    render_path_spiral,
    spherify_poses,
)

_IMG_EXTS = ("JPG", "jpg", "png", "jpeg", "PNG")


def _image_files(d):
    return [
        os.path.join(d, f)
        for f in sorted(os.listdir(d))
        if f.endswith(_IMG_EXTS)
    ]


def _minify(basedir: str, factor: int):
    """Downsampled image cache ``images_{factor}/`` (load_llff.py:8-60),
    built with cv2 INTER_AREA (no ImageMagick dependency).  It is written
    to a directory of this process's own and renamed into place, so that
    the ranks of a data-parallel run, which all load the scene, neither
    collide nor read a cache another rank is still writing."""
    outdir = os.path.join(basedir, f"images_{factor}")
    if os.path.exists(outdir):
        return
    import cv2

    tmp = tempfile.mkdtemp(prefix=f".images_{factor}.", dir=basedir)
    for f in _image_files(os.path.join(basedir, "images")):
        img = read_image(f)
        h, w = img.shape[:2]
        resized = cv2.resize(
            img, (int(w / factor), int(h / factor)), interpolation=cv2.INTER_AREA
        )
        name = os.path.splitext(os.path.basename(f))[0] + ".png"
        write_image(os.path.join(tmp, name), resized)
    try:
        os.rename(tmp, outdir)
    except OSError:  # another process's cache is in place: keep that one
        shutil.rmtree(tmp)


def _load_data(basedir: str, factor=None):
    """poses_bounds.npy + images -> (poses [3,5,N], bds [2,N], imgs
    [H,W,3,N]) (load_llff.py:63-135)."""
    if not os.path.exists(os.path.join(basedir, "poses_bounds.npy")):
        gen_poses(basedir)

    arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = arr[:, :-2].reshape(-1, 3, 5).transpose(1, 2, 0)
    bds = arr[:, -2:].transpose(1, 0)

    sfx = ""
    if factor is not None and factor != 1:
        sfx = f"_{factor}"
        _minify(basedir, factor)
    else:
        factor = 1

    imgdir = os.path.join(basedir, "images" + sfx)
    if not os.path.exists(imgdir):
        raise FileNotFoundError(f"{imgdir} does not exist")
    imgfiles = _image_files(imgdir)
    if poses.shape[-1] != len(imgfiles):
        raise ValueError(
            f"mismatch between {len(imgfiles)} images and {poses.shape[-1]} poses"
        )

    sh = read_image(imgfiles[0]).shape
    poses[:2, 4, :] = np.array(sh[:2]).reshape(2, 1)
    poses[2, 4, :] = poses[2, 4, :] / factor

    imgs = np.stack(
        [read_image(f)[..., :3] / 255.0 for f in imgfiles], axis=-1
    )
    return poses, bds, imgs


def load_llff_data(cfg: Config, recenter: bool = True):
    """(images [N,H,W,3], poses [N,3,5], bds, render_poses [M,3,5|4,4],
    i_test) — the contract of ``load_data_after_colmap``
    (load_llff.py:277-368)."""
    basedir = cfg.dataset.basedir
    poses, bds, imgs = _load_data(basedir, factor=cfg.dataset.downsample_factor)

    # colmap [-u, r, -t] -> nerf [r, u, -t]: rows [1, -0, 2]
    # (load_llff.py:295).
    poses = np.concatenate(
        [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], axis=1
    )
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    images = np.moveaxis(imgs, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    # bd_factor rescale (load_llff.py:302-304): None disables.
    sc = 1.0 if cfg.dataset.bd_factor is None else 1.0 / (
        bds.min() * cfg.dataset.bd_factor
    )
    poses[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        poses = recenter_poses(poses)

    if cfg.dataset.spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        c2w = poses_avg(poses)
        up = normalize(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        zdelta = close_depth * 0.2
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        render_poses = render_path_spiral(
            c2w, up, rads, focal, zdelta, zrate=0.5, rots=2, N=120
        )

    ds_type = cfg.dataset.type.lower()
    if ds_type == "llff":
        render_poses = np.asarray(render_poses, np.float32)
    elif ds_type == "real360":
        # Spherical path at phi=-10, r=0.89 (load_llff.py:342-352).
        dataset_name = basedir.rstrip("/").split("/")[-1]
        render_poses = np.stack(
            [
                pose_spherical_for_real_world_360(angle, -10.0, 0.89, dataset_name)
                for angle in np.linspace(0, 360, 181)[:-1]
            ]
        ).astype(np.float32)
    else:
        raise ValueError(f"dataset type {cfg.dataset.type!r} not supported")

    # Holdout: closest view to the average pose (load_llff.py:361-363).
    c2w = poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))

    return images, poses, bds, render_poses, i_test
