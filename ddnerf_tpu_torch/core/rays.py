"""Device ray generation from a camera pose.

Counterpart of ``ddnerf_tpu/core/rays.py::get_ray_bundle_device``; the host
numpy :func:`ddnerf_tpu.core.rays.get_ray_bundle` is the same math and the
tests hold the two against each other.  NDC projection (forward-facing
scenes) comes with the LLFF slice.
"""

from __future__ import annotations

import math

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
