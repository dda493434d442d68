"""Ray-section samplers: stratified first cycle and the DDNeRF
truncated-Gaussian resampler.

Counterpart of ``ddnerf_tpu/core/sampling.py``.  The JAX package locates
CDF intervals with one-hot contractions because gathers are slow on a TPU;
here the interval index comes from ``torch.searchsorted`` and the
per-interval values from ``gather``, with the same ``>=`` convention
(``interval_one_hot``, sampling.py:164-189): the index counts the interior
fenceposts ``<= u``, which is ``right=True`` on the S-1 inner fences and
lies in [0, S-1] by construction.

Random draws come from an explicit ``torch.Generator``; tests inject the
draws instead (``t_rand`` / ``jitter``) so both packages see the same
numbers.
"""

from __future__ import annotations

from typing import Optional

import torch

from ddnerf_tpu_torch.core import math as mmath


def combined_samples(num_coarse, near, far, combined_near, combined_split):
    """Half-uniform-then-log section spacing for unbounded scenes
    (reference samplers.py:6-27); ``far`` is read from row 0 as a
    scene-wide bound, like the JAX package."""
    t = torch.linspace(0.0, 1.0, num_coarse // 2 + 1, dtype=near.dtype,
                       device=near.device)
    t_uniform = combined_near * (1.0 - t) + combined_split * t
    min_d = combined_split
    max_d = far.reshape(-1)[0]
    d_i = min_d * (1.0 - t) + max_d * t
    t_nonuniform = min_d + torch.sort(
        1.0 - (torch.log2(d_i - min_d + 1.0) / torch.log2(max_d - min_d + 1.0))
    ).values * (max_d - min_d)
    t_vals = torch.cat([t_uniform, t_nonuniform[1:]])
    return torch.broadcast_to(t_vals, near.shape[:-1] + (num_coarse + 1,))


def sample_first_cycle(
    near,
    far,
    num_coarse,
    *,
    lindisp=False,
    perturb=True,
    combined=False,
    combined_near=None,
    combined_split=None,
    generator: Optional[torch.Generator] = None,
    t_rand: Optional[torch.Tensor] = None,
):
    """Coarse fenceposts ``[N, num_coarse+1]`` between ``near`` / ``far``
    (``[N, 1]``), optionally jittered inside each stratum with the
    endpoints pinned (reference samplers.py:30-62).  The jitter is
    ``t_rand`` if given, else a uniform draw from ``generator``."""
    t = torch.linspace(0.0, 1.0, num_coarse + 1, dtype=near.dtype,
                       device=near.device)
    if lindisp:
        t_vals = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    else:
        t_vals = near * (1.0 - t) + far * t
    if combined:
        t_vals = combined_samples(num_coarse, near, far, combined_near,
                                  combined_split)
    if perturb:
        mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        upper = torch.cat([mids, t_vals[..., -1:]], dim=-1)
        lower = torch.cat([t_vals[..., :1], mids], dim=-1)
        if t_rand is None:
            t_rand = torch.rand(t_vals.shape, generator=generator,
                                dtype=t_vals.dtype, device=t_vals.device)
        t_vals = lower + (upper - lower) * t_rand
        t_vals = torch.cat([near, t_vals[..., 1:-1], far], dim=-1)
    return t_vals


def _blur_and_pad_weights(weights, pdf_padding: bool):
    """mip-NeRF weight filter: max-pool + 0.5 blur while ``pdf_padding``,
    else the 0.8/0.1/0.1 neighbour mix; +0.01 either way."""
    weights_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]],
                            dim=-1)
    if pdf_padding:
        weights_max = torch.maximum(weights_pad[..., :-1], weights_pad[..., 1:])
        out = 0.5 * (weights_max[..., :-1] + weights_max[..., 1:])
    else:
        out = (0.8 * weights + 0.1 * weights_pad[..., :-2]
               + 0.1 * weights_pad[..., 2:])
    return out + 0.01


def _build_cdf(weights):
    """Normalized PDF -> the S+1 CDF fenceposts ``[0, ..., 1]``."""
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1.0)
    return torch.cat(
        [torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])],
        dim=-1)


def interval_index(x, fences, strict: bool = False):
    """Index of the interval of the sorted ``fences [..., S+1]`` that holds
    each ``x [..., M]``, clipped to [0, S-1]: the count of interior
    fenceposts ``<= x`` (the CDF-inverse convention, samplers.py:106-119),
    or ``< x`` with ``strict`` (the dp-loss convention of
    ``interval_one_hot(strict=True)``, dd_utils.py:43)."""
    inner = fences[..., 1:-1].contiguous()
    return torch.searchsorted(inner, x.contiguous(), right=not strict)


@torch.no_grad()
def sample_pdf_with_mu_sigma(
    bins,
    weights,
    mus,
    sigmas,
    part_inside_bins,
    left_tail,
    num_samples,
    *,
    near,
    far,
    pdf_padding: bool,
    det=True,
    generator: Optional[torch.Generator] = None,
    jitter: Optional[torch.Tensor] = None,
):
    """Resample ``num_samples`` fenceposts through each section's
    truncated-Gaussian inverse CDF (reference samplers.py:124-215):

    ``z = min(frac * part_inside + left_tail, 0.999)`` with ``frac`` the
    position of ``u`` inside its CDF interval clamped to [0, 1],
    ``t = clip(Φ⁻¹(z) σ + μ, 0, 0.99999)``, lerp inside the section, and
    the endpoints pinned to the scene ``near`` / ``far``.  The clamps are
    the reference's exactly.  The reference re-sorts the result; that sort
    is the identity (the JAX package proves and tests it, sampling.py
    375-387) and is skipped.

    ``det`` places ``u`` on ``linspace(0, 0.9999)``; otherwise on a
    stratified grid jittered by ``jitter`` (uniform [0, 1) draws of shape
    ``[..., num_samples]``, drawn from ``generator`` if not given).

    Runs under ``no_grad``: the fine fenceposts are detached from the
    coarse graph, as ``t1 = stop_gradient(t1)`` in the JAX pipeline
    (models/nerf.py:879) and the reference's ``nn.Parameter`` wrap
    (samplers.py:215).  The endpoint pins below write in place on that
    detached result, never on a graph tensor.
    """
    weights = _blur_and_pad_weights(weights, pdf_padding)
    cdf = _build_cdf(weights)
    shape = cdf.shape[:-1] + (num_samples,)
    dev, dt = weights.device, weights.dtype

    if det:
        u = torch.linspace(0.0, 0.9999, num_samples, dtype=dt, device=dev)
        u = torch.broadcast_to(u, shape)
    else:
        s = 1.0 / (num_samples - 1)
        u = torch.arange(num_samples, dtype=dt, device=dev) * s
        if jitter is None:
            jitter = torch.rand(shape, generator=generator, dtype=dt,
                                device=dev)
        u = torch.clamp(u + jitter / (num_samples + 1e-5), 0.0, 0.9999)

    if bins.shape[-1] == 2:  # a single coarse section (samplers.py:185-190)
        z = u * part_inside_bins + left_tail
        new_mus, new_sigmas = mus, sigmas
        bins_g0, bins_g1 = bins[..., 0:1], bins[..., 1:2]
    else:
        ind = interval_index(u, cdf)

        def take(x):
            return torch.gather(x, -1, ind)

        bins_g0, bins_g1 = take(bins[..., :-1]), take(bins[..., 1:])
        cdf_g0, cdf_g1 = take(cdf[..., :-1]), take(cdf[..., 1:])
        pib, lt = take(part_inside_bins), take(left_tail)
        new_mus, new_sigmas = take(mus), take(sigmas)

        denom = cdf_g1 - cdf_g0
        frac = torch.where(
            denom > 0, (u - cdf_g0) / torch.where(denom > 0, denom, 1.0), 0.0)
        frac = torch.clamp(frac, 0.0, 1.0)
        z = torch.clamp(frac * pib + lt, max=0.999)

    z = mmath.normal_inverse_cdf(z)
    t = torch.clamp(z * new_sigmas + new_mus, 0.0, 0.99999)
    samples = bins_g0 + t * (bins_g1 - bins_g0)
    samples[..., 0] = near
    samples[..., -1] = far
    return samples
