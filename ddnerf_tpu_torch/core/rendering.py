"""Differentiable volume rendering (alpha compositing).

Counterpart of ``ddnerf_tpu/core/rendering.py::volume_render``
(reference volume_rendering_utils.py:6-85), with the analytic adjoint of
the compositing weights (``_weights_from_alpha_analytic``, rendering.py
37-82) as a ``torch.autograd.Function``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


def cumprod_exclusive(x: torch.Tensor) -> torch.Tensor:
    return torch.cat(
        [torch.ones_like(x[..., :1]), torch.cumprod(x, dim=-1)[..., :-1]],
        dim=-1)


class _WeightsFromAlpha(torch.autograd.Function):
    """``w = a * T`` with the hand-derived adjoint

        dL/da_k = gw_k T_k - (sum_{i>k} gw_i w_i) / (1 - a_k + 1e-10)

    (dT_i/da_k = -T_i / (1 - a_k + e) for k < i), one reverse cumsum instead
    of autograd through the cumprod chain.  Two details are the JAX
    package's and matter: the suffix sum is STRICT, taken as
    shift-then-reverse-cumsum (an inclusive cumsum minus the own term
    cancels catastrophically when alpha saturates), and the divisor is
    clamped at 1e-10, so a saturated alpha == 1.0 never divides by 0
    (ROADMAP C2)."""

    @staticmethod
    def forward(ctx, alpha):
        trans = cumprod_exclusive(1.0 - alpha + 1e-10)
        w = alpha * trans
        ctx.save_for_backward(alpha, trans, w)
        return w

    @staticmethod
    def backward(ctx, gw):
        alpha, trans, w = ctx.saved_tensors
        gww = gw * w
        shifted = torch.cat([gww[..., 1:], torch.zeros_like(gww[..., :1])],
                            dim=-1)
        suffix = torch.flip(torch.cumsum(torch.flip(shifted, (-1,)), dim=-1),
                            (-1,))
        denom = torch.clamp(1.0 - alpha + 1e-10, min=1e-10)
        return gw * trans - suffix / denom


def weights_from_alpha(alpha: torch.Tensor,
                       analytic_vjp: bool = False) -> torch.Tensor:
    """``w_i = a_i * prod_{j<i} (1 - a_j + 1e-10)``.  ``analytic_vjp``
    (config ``parallel.composite_custom_vjp``) selects the analytic adjoint;
    otherwise autograd differentiates the cumprod."""
    if analytic_vjp:
        return _WeightsFromAlpha.apply(alpha)
    return alpha * cumprod_exclusive(1.0 - alpha + 1e-10)


class RenderOutput(NamedTuple):
    rgb: torch.Tensor  # [N, 3] composited color
    disp: torch.Tensor  # [N] disparity
    acc: torch.Tensor  # [N] accumulated opacity
    weights: torch.Tensor  # [N, S] compositing weights
    depth: torch.Tensor  # [N] expected depth (mu-corrected when mus given)
    corrected_disp: Optional[torch.Tensor]  # [N] or None
    rgb_raw: torch.Tensor  # [N, S, 3] per-sample colors


def volume_render(
    raw_rgb,
    raw_density,
    t_vals,
    ray_directions,
    *,
    generator: Optional[torch.Generator] = None,
    noise_std=0.0,
    white_background=False,
    mus=None,
    eps_mask_pdf=False,
    analytic_weights_vjp=False,
) -> RenderOutput:
    """Composite per-sample radiance into per-ray maps.

    ``raw_rgb [N, S, 3]`` / ``raw_density [N, S]`` are the network's raw
    heads, ``t_vals [N, S+1]`` the fenceposts, ``ray_directions [N, 3]``
    (unnormalized; their norm scales the section lengths).  Density noise
    ``N(0, noise_std²)`` is drawn from ``generator`` when both are given
    (the shipped configs validate with ``noise_std = 1``).  ``eps_mask_pdf``
    adds 1e-10 to the last section's weight before normalizing the depth
    pdf (blender scenes); ``mus`` switches the depth to the per-section
    expected depth ``t0 + μ (t1 - t0)`` (the DDNeRF μ-corrected depth).
    Differentiable into ``raw_rgb``, ``raw_density`` and ``mus``;
    ``analytic_weights_vjp`` picks the weights' adjoint.
    """
    mids = (t_vals[..., 1:] + t_vals[..., :-1]) / 2.0
    dists = t_vals[..., 1:] - t_vals[..., :-1]
    delta = dists * torch.linalg.norm(ray_directions, dim=-1, keepdim=True)

    rgb = torch.sigmoid(raw_rgb) * (1.0 + 2.0 * 0.001) - 0.001

    density = raw_density
    if noise_std > 0.0 and generator is not None:
        noise = torch.randn(density.shape, generator=generator,
                            dtype=density.dtype, device=density.device)
        density = density + noise * noise_std

    sigma_a = F.softplus(density - 1.0)
    alpha = 1.0 - torch.exp(-sigma_a * delta)
    weights = weights_from_alpha(alpha, analytic_weights_vjp)

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)

    if eps_mask_pdf:
        eps_mask = torch.zeros_like(weights)
        eps_mask[..., -1] = 1e-10
        weights = weights + eps_mask
        pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    else:
        pdf = weights

    depth_map = torch.sum(pdf * mids, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)

    if white_background:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])

    corrected_disp = None
    if mus is not None:
        section_mus = t_vals[..., :-1] + mus * dists
        depth_map = torch.sum(pdf * section_mus, dim=-1)
        corrected_disp = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)

    return RenderOutput(rgb=rgb_map, disp=disp_map, acc=acc_map,
                        weights=weights, depth=depth_map,
                        corrected_disp=corrected_disp, rgb_raw=rgb)
