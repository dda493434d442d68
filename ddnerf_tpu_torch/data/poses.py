"""Pose pipeline: COLMAP sparse model -> ``poses_bounds.npy``, plus the pose
math used by the LLFF loader (average pose, recentering, spherification,
spiral render path).

Rewrite of ``data_utils/poses/pose_utils.py`` and the pose
helpers in ``load_llff.py:138-274`` — standard NeRF-lineage algorithms,
implemented fresh in NumPy.

``poses_bounds.npy`` is a cache that every rank of a data-parallel run may
build at once, so :func:`save_poses` writes it to a file of its own in the
scene directory and renames that into place: a reader finds either no file
or a whole one, never one another rank is still writing.
"""

from __future__ import annotations

import contextlib
import os
import uuid

import numpy as np

from ddnerf_tpu_torch.data import colmap


# --------------------------------------------------------------------------
# COLMAP -> poses_bounds.npy (pose_utils.py:10-89)
# --------------------------------------------------------------------------


def load_colmap_data(realdir: str):
    """Read the sparse model; return (poses [3,5,N] in LLFF convention,
    pts3d dict, perm) — name-sorted order via ``perm``
    (pose_utils.py:10-52)."""
    sparse = os.path.join(realdir, "sparse/0")
    cameras, images, pts3d = colmap.read_model(sparse)

    cam = next(iter(cameras.values()))
    hwf = np.array([cam.height, cam.width, cam.params[0]]).reshape(3, 1)

    names = [images[k].name for k in images]
    perm = np.argsort(names)

    w2c = []
    bottom = np.array([[0, 0, 0, 1.0]])
    for k in images:
        im = images[k]
        m = np.concatenate(
            [np.concatenate([im.rotmat(), im.tvec.reshape(3, 1)], axis=1), bottom],
            axis=0,
        )
        w2c.append(m)
    c2w = np.linalg.inv(np.stack(w2c))

    poses = c2w[:, :3, :4].transpose(1, 2, 0)  # [3, 4, N]
    poses = np.concatenate(
        [poses, np.tile(hwf[..., None], (1, 1, poses.shape[-1]))], axis=1
    )
    # COLMAP [r, -u, t] -> LLFF [-u, r, -t] axis convention
    # (pose_utils.py:49-50: rows [1, 0, -2] of the rotation block).
    poses = np.concatenate(
        [poses[:, 1:2], poses[:, 0:1], -poses[:, 2:3], poses[:, 3:4], poses[:, 4:5]],
        axis=1,
    )
    return poses, pts3d, perm


def save_poses(basedir: str, poses, pts3d, perm):
    """Per-image visible-point z-percentile bounds -> poses_bounds.npy
    (pose_utils.py:55-89)."""
    pts = np.stack([p.xyz for p in pts3d.values()])  # [P, 3]
    n_im = poses.shape[-1]
    vis = np.zeros((len(pts3d), n_im), dtype=bool)
    for row, p in enumerate(pts3d.values()):
        for ind in p.image_ids:
            vis[row, ind - 1] = True

    # z-depth of each point in each camera: dot(pt - c, -z_axis).
    zvals = np.sum(
        -(pts[:, None].transpose(2, 0, 1) - poses[:3, 3:4, :]) * poses[:3, 2:3, :],
        axis=0,
    )  # [P, N]

    rows = []
    for i in perm:
        zs = zvals[vis[:, i], i]
        close, inf = np.percentile(zs, 0.1), np.percentile(zs, 99.9)
        rows.append(np.concatenate([poses[..., i].ravel(), [close, inf]]))
    arr = np.array(rows)
    # A name no other writer takes, opened as np.save opens its file (the
    # permissions the umask gives).
    tmp = os.path.join(basedir, f".poses_bounds.{uuid.uuid4().hex}.npy")
    try:
        with open(tmp, "xb") as f:
            np.save(f, arr)
        # Ranks that both wrote the cache replace it with the same bytes.
        os.replace(tmp, os.path.join(basedir, "poses_bounds.npy"))
    except BaseException:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(tmp)
        raise
    return arr


def gen_poses(basedir: str):
    """Build poses_bounds.npy from an existing COLMAP reconstruction; the
    reference likewise refuses to *run* COLMAP itself
    (pose_utils.py:152-169)."""
    sparse = os.path.join(basedir, "sparse/0")
    try:
        colmap.detect_model_format(sparse)  # binary or text model
    except FileNotFoundError as e:
        raise FileNotFoundError(
            f"{basedir}: COLMAP output missing ({e}); run COLMAP "
            "first — automatic reconstruction is out of scope"
        ) from None
    poses, pts3d, perm = load_colmap_data(basedir)
    save_poses(basedir, poses, pts3d, perm)


# --------------------------------------------------------------------------
# Pose math (load_llff.py:138-274)
# --------------------------------------------------------------------------


def normalize(v):
    return v / np.linalg.norm(v)


def viewmatrix(z, up, pos):
    """Camera-to-world [right, up, forward, pos] from forward/up hints."""
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def poses_avg(poses):
    """Average pose: mean center, summed viewing direction and up
    (load_llff.py:156-165).  ``poses``: [N, 3, 5]."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], axis=1)


def recenter_poses(poses):
    """Rigidly transform all poses so the average pose is the identity
    (load_llff.py:184-196)."""
    out = poses.copy()
    bottom = np.array([[0, 0, 0, 1.0]])
    c2w = np.concatenate([poses_avg(poses)[:3, :4], bottom], axis=0)
    homog = np.concatenate(
        [poses[:, :3, :4], np.tile(bottom[None], (poses.shape[0], 1, 1))], axis=1
    )
    out[:, :3, :4] = (np.linalg.inv(c2w) @ homog)[:, :3, :4]
    return out


def render_path_spiral(c2w, up, rads, focal, zdelta, zrate, rots, N):
    """Spiral render path around the average pose (load_llff.py:168-181)."""
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = c2w[:3, :4] @ (
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0])
            * rads
        )
        z = normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        render_poses.append(np.concatenate([viewmatrix(z, up, c), hwf], axis=1))
    return np.stack(render_poses)


def spherify_poses(poses, bds):
    """For inward-facing 360 captures: recenter on the point minimizing
    distance to all camera axes, scale to unit radius, and build a circular
    render path (load_llff.py:199-274)."""

    def homog(p):
        last = np.tile(np.eye(4)[-1].reshape(1, 1, 4), (p.shape[0], 1, 1))
        return np.concatenate([p, last], axis=1)

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    # Closest point to all camera viewing axes (least squares).
    A_i = np.eye(3) - rays_d * np.transpose(rays_d, (0, 2, 1))
    b_i = -A_i @ rays_o
    pt_mindist = np.squeeze(
        -np.linalg.inv((np.transpose(A_i, (0, 2, 1)) @ A_i).mean(0)) @ b_i.mean(0)
    )

    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)

    vec0 = normalize(up)
    vec1 = normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], axis=1)

    poses_reset = np.linalg.inv(homog(c2w[None])) @ homog(poses[:, :3, :4])

    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad**2 - zh**2)

    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = normalize(camorigin)
        vec0 = normalize(np.cross(vec2, up))
        vec1 = normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, camorigin], axis=1))
    new_poses = np.stack(new_poses, 0)

    new_poses = np.concatenate(
        [new_poses, np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)],
        axis=-1,
    )
    poses_reset = np.concatenate(
        [
            poses_reset[:, :3, :4],
            np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape),
        ],
        axis=-1,
    )
    return poses_reset, new_poses, bds
