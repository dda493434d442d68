"""Device ray generation from a camera pose.

Counterpart of ``ddnerf_tpu/core/rays.py``: :func:`get_ray_bundle` is its
``get_ray_bundle_device`` on torch tensors; the numpy forms that the ray
datasets use on the host (:func:`get_ray_bundle_np`,
:func:`ndc_mipnerf_rays`, :func:`switch_t_ndc_to_regular`) follow it, and
:func:`ndc_mipnerf_rays_device` is the NDC projection on tensors, for the
rays a pose is rendered with.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def get_ray_bundle(height: int, width: int, focal_length, c2w, device=None):
    """One ray per pixel plus the mip-NeRF base radius, on ``device``.

    Same quirks as the reference (nerf_helpers.py:67-125): a zero origin or
    direction component is nudged by 1e-5, and ``radii = dx * 2/sqrt(12)``
    from the distance between x-neighbour directions.  Returns
    (origins [H, W, 3], directions [H, W, 3], radii [H, W, 1]), float32.
    """
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
    device = c2w.device
    jj, ii = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    directions = torch.stack(
        [
            (ii - width * 0.5) / focal_length,
            -(jj - height * 0.5) / focal_length,
            -torch.ones_like(ii),
        ],
        dim=-1,
    )  # [H, W, 3] camera frame
    ray_directions = torch.sum(directions[..., None, :] * c2w[:3, :3], dim=-1)
    ray_origins = torch.broadcast_to(c2w[:3, -1], ray_directions.shape)

    epsilon = 1e-5
    ray_origins = torch.where(ray_origins == 0, epsilon, ray_origins)
    ray_directions = torch.where(ray_directions == 0, epsilon, ray_directions)

    dx = torch.sqrt(torch.sum((directions[:-1] - directions[1:]) ** 2, dim=-1))
    dx = torch.cat([dx, dx[-2:-1, :]], dim=0)
    radii = dx[..., None] * 2.0 / math.sqrt(12.0)
    return ray_origins, ray_directions, radii


def get_ray_bundle_np(height: int, width: int, focal_length, c2w: np.ndarray):
    """Host (numpy) twin of :func:`get_ray_bundle`, for the ray datasets:
    the same math and quirks (counterpart of
    ``ddnerf_tpu/core/rays.py::get_ray_bundle``).

    Returns (origins [H, W, 3], directions [H, W, 3], radii [H, W, 1]),
    float32.
    """
    c2w = np.asarray(c2w, dtype=np.float32)
    ii, jj = np.meshgrid(
        np.arange(width, dtype=np.float32),
        np.arange(height, dtype=np.float32),
        indexing="xy",
    )
    directions = np.stack(
        [
            (ii - width * 0.5) / focal_length,
            -(jj - height * 0.5) / focal_length,
            -np.ones_like(ii),
        ],
        axis=-1,
    )  # [H, W, 3] camera-frame
    ray_directions = np.sum(directions[..., None, :] * c2w[:3, :3], axis=-1)
    ray_origins = np.broadcast_to(c2w[:3, -1], ray_directions.shape).copy()

    epsilon = 1e-5
    ray_origins[ray_origins == 0] += epsilon
    ray_directions[ray_directions == 0] += epsilon

    dx = np.sqrt(np.sum((directions[:-1, :, :] - directions[1:, :, :]) ** 2, -1))
    dx = np.concatenate([dx, dx[-2:-1, :]], axis=0)
    radii = dx[..., None] * 2.0 / np.sqrt(12.0)

    return (
        ray_origins.astype(np.float32),
        ray_directions.astype(np.float32),
        radii.astype(np.float32),
    )


def ndc_mipnerf_rays(H, W, focal, rays_o, rays_d, near=1.0, xp=np):
    """Project rays to NDC space and recompute mip radii from x/y neighbor
    distances on the NDC origins (reference dataset_helpers.py:3-42).

    ``rays_o``/``rays_d``: [H, W, 3].  Returns (rays_o, rays_d, radii[H, W]).
    ``xp`` is the array module, numpy: the host loaders' form.
    """
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = (
        -1.0
        / (W / (2.0 * focal))
        * (rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    )
    d1 = (
        -1.0
        / (H / (2.0 * focal))
        * (rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    )
    d2 = -2.0 * near / rays_o[..., 2]

    rays_o = xp.stack([o0, o1, o2], axis=-1).astype(xp.float32)
    rays_d = xp.stack([d0, d1, d2], axis=-1).astype(xp.float32)

    mat = rays_o
    dx = xp.sqrt(xp.sum((mat[:-1, :, :] - mat[1:, :, :]) ** 2, -1))
    dx = xp.concatenate([dx, dx[-2:-1, :]], axis=0)
    dy = xp.sqrt(xp.sum((mat[:, :-1, :] - mat[:, 1:, :]) ** 2, -1))
    dy = xp.concatenate([dy, dy[:, -2:-1]], axis=1)
    radii = ((0.5 * (dx + dy)) * 2.0 / xp.sqrt(12.0)).astype(xp.float32)

    return rays_o, rays_d, radii


def ndc_mipnerf_rays_device(H, W, focal, rays_o, rays_d, near=1.0):
    """:func:`ndc_mipnerf_rays` on float32 tensors ``[H, W, 3]``, on their
    device -> (rays_o, rays_d, radii ``[H, W]``).

    The radii are neighbour differences over the whole ``[H, W]`` grid of
    NDC origins: project the full image, then flatten and chunk.  The
    projection divides by ``rays_d[..., 2]`` and stays plain float32
    arithmetic."""
    sx = -1.0 / (W / (2.0 * float(focal)))
    sy = -1.0 / (H / (2.0 * float(focal)))
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]
    origins = torch.stack(
        [sx * ox_oz, sy * oy_oz, 1.0 + 2.0 * near / rays_o[..., 2]], dim=-1)
    directions = torch.stack(
        [sx * (rays_d[..., 0] / rays_d[..., 2] - ox_oz),
         sy * (rays_d[..., 1] / rays_d[..., 2] - oy_oz),
         -2.0 * near / rays_o[..., 2]], dim=-1)

    dx = torch.sqrt(torch.sum((origins[:-1] - origins[1:]) ** 2, dim=-1))
    dx = torch.cat([dx, dx[-2:-1, :]], dim=0)
    dy = torch.sqrt(torch.sum((origins[:, :-1] - origins[:, 1:]) ** 2,
                              dim=-1))
    dy = torch.cat([dy, dy[:, -2:-1]], dim=1)
    radii = (0.5 * (dx + dy)) * 2.0 / math.sqrt(12.0)
    return origins, directions, radii


def switch_t_ndc_to_regular(ndc_depth, rays_o, rays_d):
    """NDC-space depth -> metric depth (reference dataset_helpers.py:45-48),
    used to un-warp validation depth maps (train_model.py:225-228).

    Pure arithmetic on numpy arrays.
    """
    return ndc_depth * rays_o[..., -1] / (rays_d[..., -1] - ndc_depth * rays_d[..., -1]) + 1.0
