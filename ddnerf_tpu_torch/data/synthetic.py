"""Procedural synthetic scene for tests and benchmarks.

The reference repo assumes the NeRF-synthetic / LLFF datasets exist on disk
(its example-data link is "TBD", README.md:35).  This module generates a small
analytic scene — colored lambertian spheres on a transparent background —
ray-traced directly in NumPy, producing images + blender-convention poses that
flow through the exact same pipeline as real data.  It plays the role of the
reference's debug tiny-images mode (load_blender.py:115-128) but with real
geometry so training PSNR climbs measurably.
"""

from __future__ import annotations

import numpy as np

# (center xyz, radius, albedo rgb)
_SPHERES = [
    (np.array([0.0, 0.0, 0.0]), 0.9, np.array([0.9, 0.25, 0.2])),
    (np.array([0.9, 0.6, -0.4]), 0.45, np.array([0.2, 0.8, 0.3])),
    (np.array([-0.8, -0.5, 0.5]), 0.5, np.array([0.25, 0.35, 0.9])),
    (np.array([0.1, -0.9, -0.6]), 0.35, np.array([0.9, 0.85, 0.2])),
]
_LIGHT_DIR = np.array([0.5, 0.8, 0.3]) / np.linalg.norm([0.5, 0.8, 0.3])


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Blender-convention spherical camera pose (c2w, 4x4) — same composition
    as the reference's ``pose_spherical`` (load_blender.py:9-41)."""
    def trans_z(t):
        m = np.eye(4, dtype=np.float32)
        m[2, 3] = t
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

    c2w = trans_z(radius)
    c2w = rot_phi(phi_deg / 180.0 * np.pi) @ c2w
    c2w = rot_theta(theta_deg / 180.0 * np.pi) @ c2w
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32
    )
    return flip @ c2w


def _trace(origins: np.ndarray, directions: np.ndarray) -> np.ndarray:
    """Analytic ray-trace of the sphere scene -> RGBA float32 in [0, 1]."""
    d = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
    o = origins
    best_t = np.full(o.shape[:-1], np.inf, dtype=np.float32)
    color = np.zeros(o.shape[:-1] + (3,), dtype=np.float32)
    hit = np.zeros(o.shape[:-1], dtype=bool)

    for center, radius, albedo in _SPHERES:
        oc = o - center
        b = np.sum(oc * d, axis=-1)
        c = np.sum(oc * oc, axis=-1) - radius**2
        disc = b * b - c
        valid = disc > 0
        sq = np.sqrt(np.where(valid, disc, 0.0))
        t = -b - sq
        valid &= t > 1e-3
        closer = valid & (t < best_t)
        if not closer.any():
            continue
        p = o + t[..., None] * d
        n = (p - center) / radius
        lam = np.clip(np.sum(n * _LIGHT_DIR, axis=-1), 0.0, 1.0)
        shade = (0.25 + 0.75 * lam)[..., None] * albedo
        best_t = np.where(closer, t, best_t)
        color = np.where(closer[..., None], shade, color)
        hit |= closer

    alpha = hit.astype(np.float32)
    return np.concatenate([color, alpha[..., None]], axis=-1)


def generate_synthetic_blender(
    num_train: int = 12,
    num_val: int = 2,
    height: int = 64,
    width: int = 64,
    camera_radius: float = 4.0,
    seed: int = 0,
):
    """Produce ``(images [N,H,W,4], poses [N,4,4], render_poses, hwf,
    i_split)`` with the same contract as ``load_blender_data``
    (reference load_blender.py:68-145).  near/far of 2/6 (the blender config
    defaults) bracket the scene."""
    rng = np.random.default_rng(seed)
    n = num_train + num_val
    thetas = np.linspace(-180, 180, n, endpoint=False) + rng.uniform(-5, 5, n)
    phis = rng.uniform(-45, -15, n)

    focal = 0.5 * width / np.tan(0.5 * 0.6911)  # blender-lego-like FOV
    poses = np.stack([pose_spherical(t, p, camera_radius) for t, p in zip(thetas, phis)])

    images = []
    ii, jj = np.meshgrid(
        np.arange(width, dtype=np.float32),
        np.arange(height, dtype=np.float32),
        indexing="xy",
    )
    dirs_cam = np.stack(
        [(ii - width * 0.5) / focal, -(jj - height * 0.5) / focal, -np.ones_like(ii)],
        axis=-1,
    )
    for c2w in poses:
        rd = np.sum(dirs_cam[..., None, :] * c2w[:3, :3], axis=-1)
        ro = np.broadcast_to(c2w[:3, -1], rd.shape)
        images.append(_trace(ro, rd))
    images = np.stack(images).astype(np.float32)

    render_poses = np.stack(
        [pose_spherical(a, -30.0, camera_radius) for a in np.linspace(-180, 180, 40)[:-1]]
    )
    i_split = (
        np.arange(0, num_train),
        np.arange(num_train, n),
        np.arange(num_train, n),
    )
    return images, poses, render_poses, [height, width, focal], i_split


def write_synthetic_llff(outdir: str, size: int = 64, n: int = 12,
                         seed: int = 0) -> None:
    """Write the sphere scene as an on-disk forward-facing capture in the
    LLFF layout that ``load_llff_data`` reads: ``images/image%03d.png`` and
    ``poses_bounds.npy``.  ``n`` cameras jittered on a plane at z ~ +4 look
    down -z at a point near the origin and are traced with the pinhole
    model of :func:`generate_synthetic_blender`, composited on black.  Each
    pose is stored in the COLMAP column convention the loader swaps back
    (``[-u, r, b, t]`` and a fifth column ``[H, W, focal]``) with depth
    bounds that bracket the scene (z in [-1.1, 1.1])."""
    import os

    from ddnerf_tpu_torch.data.images import write_image

    h = w = size
    focal = 0.5 * w / np.tan(0.5 * 0.6911)
    rng = np.random.default_rng(seed)
    imgdir = os.path.join(outdir, "images")
    os.makedirs(imgdir, exist_ok=True)

    ii, jj = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32), indexing="xy")
    dirs_cam = np.stack(
        [(ii - w * 0.5) / focal, -(jj - h * 0.5) / focal, -np.ones_like(ii)],
        axis=-1,
    )
    rows = []
    for i in range(n):
        eye = np.array([rng.uniform(-0.8, 0.8), rng.uniform(-0.6, 0.6),
                        4.0 + rng.uniform(-0.2, 0.2)], np.float32)
        target = np.array([rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2),
                           0.0], np.float32)
        back = eye - target
        back /= np.linalg.norm(back)
        right = np.cross(np.array([0.0, 1.0, 0.0], np.float32), back)
        right /= np.linalg.norm(right)
        up = np.cross(back, right)
        c2w = np.stack([right, up, back, eye], axis=-1)  # [3, 4], [r u b t]

        rd = np.sum(dirs_cam[..., None, :] * c2w[:3, :3], axis=-1)
        ro = np.broadcast_to(c2w[:3, -1], rd.shape)
        rgba = _trace(ro, rd)
        rgb = rgba[..., :3] * rgba[..., 3:4]
        write_image(os.path.join(imgdir, f"image{i:03d}.png"),
                    (np.clip(rgb, 0, 1) * 255).astype(np.uint8))

        stored = np.concatenate(
            [np.stack([-up, right, back, eye], axis=-1),
             np.array([[h], [w], [focal]], np.float32)], axis=-1)
        near, far = eye[2] - 1.5, eye[2] + 1.5
        rows.append(np.concatenate([stored.ravel(), [near, far]]))
    np.save(os.path.join(outdir, "poses_bounds.npy"),
            np.stack(rows).astype(np.float64))
