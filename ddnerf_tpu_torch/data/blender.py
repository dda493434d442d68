"""Blender-synthetic dataset loader.

Rewrite of ``data_utils/load_blender.py``: reads
``transforms_{train,val,test}.json`` + PNGs, computes focal from
``camera_angle_x``, builds the 360° spherical render path, and supports the
half-res and debug tiny-image modes.  Pure NumPy on the host.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ddnerf_tpu_torch.data.images import read_image
from ddnerf_tpu_torch.data.synthetic import pose_spherical


def pose_spherical_for_real_world_360(theta, phi, radius, dataset_name=None):
    """Spherical pose with the reference's hardcoded "beta"-scene warp
    (load_blender.py:44-65)."""
    if dataset_name == "beta":
        alpha = 0.7
        if theta <= 180:
            radius = alpha * radius + (abs(90 - theta) / 90) * (1 - alpha) * radius
        else:
            radius = alpha * radius + (abs(270 - theta) / 90) * (1 - alpha) * radius

    def trans(axis, t):
        m = np.eye(4, dtype=np.float32)
        m[axis, 3] = t
        return m

    def rot_phi(phi):
        m = np.eye(4, dtype=np.float32)
        m[1, 1] = m[2, 2] = np.cos(phi)
        m[1, 2] = -np.sin(phi)
        m[2, 1] = np.sin(phi)
        return m

    def rot_theta(th):
        m = np.eye(4, dtype=np.float32)
        m[0, 0] = m[2, 2] = np.cos(th)
        m[0, 2] = -np.sin(th)
        m[2, 0] = np.sin(th)
        return m

    c2w = trans(2, radius)
    c2w = rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = rot_theta(theta / 180.0 * np.pi) @ c2w
    if dataset_name == "beta":
        c2w = rot_phi(10 / 180.0 * np.pi) @ c2w
        c2w = trans(1, -0.30) @ c2w
        c2w = trans(2, -0.03) @ c2w
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32
    )
    return flip @ c2w


_SPLITS = ("train", "val", "test")


def _read_split(basedir: str, split: str, testskip: int):
    """Load one split's frames: (images [n,H,W,4] float in [0,1],
    poses [n,4,4], camera_angle_x)."""
    with open(os.path.join(basedir, f"transforms_{split}.json")) as fp:
        meta = json.load(fp)

    stride = testskip if (split != "train" and testskip > 0) else 1
    frames = meta["frames"][::stride]
    images = np.stack(
        [read_image(os.path.join(basedir, f["file_path"] + ".png"))
         for f in frames]
    ).astype(np.float32) / 255.0
    poses = np.stack(
        [np.asarray(f["transform_matrix"], np.float32) for f in frames]
    )
    return images, poses, float(meta["camera_angle_x"])


def _resize_stack(images: np.ndarray, dsize) -> np.ndarray:
    """Area-resample every image to ``dsize`` (cv2 wants (W, H))."""
    import cv2

    return np.stack(
        [cv2.resize(img, dsize=dsize, interpolation=cv2.INTER_AREA)
         for img in images]
    )


def load_blender_data(basedir, half_res=False, testskip=1, debug=False):
    """Returns (images [N,H,W,4] float32, poses [N,4,4], render_poses,
    [H, W, focal], i_split) — same contract as load_blender.py:68-145.

    Fixes the reference's half-res quirk of resizing to a hardcoded 400x400
    (load_blender.py:134-140) by using the actual W//2 x H//2.
    """
    per_split = [_read_split(basedir, s, testskip) for s in _SPLITS]

    edges = np.cumsum([0] + [imgs.shape[0] for imgs, _, _ in per_split])
    i_split = [np.arange(lo, hi) for lo, hi in zip(edges[:-1], edges[1:])]
    imgs = np.concatenate([s[0] for s in per_split], axis=0)
    poses = np.concatenate([s[1] for s in per_split], axis=0)

    H, W = imgs.shape[1:3]
    camera_angle_x = per_split[0][2]
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    # 360° orbit at -30° elevation, radius 4 — the standard blender demo path.
    orbit = np.linspace(-180, 180, 181)[:-1]
    render_poses = np.stack([pose_spherical(a, -30.0, 4.0) for a in orbit])

    if debug:
        # Tiny-image smoke mode (load_blender.py:115-128): 25x25 images with
        # intrinsics scaled as if //32.
        scale = 32
        imgs = _resize_stack(imgs, (25, 25))
        return imgs, poses, render_poses, [H // scale, W // scale, focal / scale], i_split

    if half_res:
        H, W, focal = H // 2, W // 2, focal / 2.0
        imgs = _resize_stack(imgs, (W, H))

    return imgs, poses, render_poses, [H, W, focal], i_split
