"""mip-NeRF / DDNeRF math on torch tensors.

Counterpart of ``ddnerf_tpu/core/math.py``; same conventions: ``t_vals``
are the S+1 fenceposts of S sections along a ray, per-ray sample axes are
``[..., S]``, and all trig of encodings goes through :func:`safe_sin` /
:func:`safe_cos` (wrap at 100π, reference math_utils.py:155-166).
"""

from __future__ import annotations

import functools
import math

import torch

_TRIG_THRESHOLD = 100.0 * math.pi
_SQRT2 = 1.4142135623730951


def _wrap(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < _TRIG_THRESHOLD, x,
                       torch.remainder(x, _TRIG_THRESHOLD))


def safe_sin(x: torch.Tensor) -> torch.Tensor:
    """sin with the argument wrapped past 100π (floor-mod, as ``jnp %``)."""
    return torch.sin(_wrap(x))


def safe_cos(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(_wrap(x))


# --------------------------------------------------------------------------
# Conical frustum / cylinder -> Gaussian (reference math_utils.py:7-110)
# --------------------------------------------------------------------------


def lift_gaussian(d, t_mean, t_var, r_var, diag=True):
    """Lift 1-D Gaussians along ``d [..., 3]`` to 3-D: means and diagonal
    (or full) covariances ``[..., S, 3(, 3)]``."""
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d**2, dim=-1, keepdim=True), min=1e-10)
    if diag:
        d_outer_diag = d**2
        null_outer_diag = 1.0 - d_outer_diag / d_mag_sq
        t_cov_diag = t_var[..., None] * d_outer_diag[..., None, :]
        xy_cov_diag = r_var[..., None] * null_outer_diag[..., None, :]
        return mean, t_cov_diag + xy_cov_diag
    d_outer = d[..., :, None] * d[..., None, :]
    eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device)
    null_outer = eye - d[..., :, None] * (d / d_mag_sq)[..., None, :]
    t_cov = t_var[..., None, None] * d_outer[..., None, :, :]
    xy_cov = r_var[..., None, None] * null_outer[..., None, :, :]
    return mean, t_cov + xy_cov


def conical_frustum_to_gaussian(d, t0, t1, base_radius, diag=True):
    """Stable Gaussian approximation of a conical frustum (mip-NeRF eq. 7)."""
    mu = (t0 + t1) / 2.0
    hw = (t1 - t0) / 2.0
    denom = 3.0 * mu**2 + hw**2
    t_mean = mu + (2.0 * mu * hw**2) / denom
    t_var = hw**2 / 3.0 - (4.0 / 15.0) * (
        (hw**4 * (12.0 * mu**2 - hw**2)) / denom**2)
    r_var = base_radius**2 * (
        mu**2 / 4.0 + (5.0 / 12.0) * hw**2 - (4.0 / 15.0) * hw**4 / denom)
    return lift_gaussian(d, t_mean, t_var, r_var, diag)


def cylinder_to_gaussian(d, t0, t1, radius, diag=True):
    t_mean = (t0 + t1) / 2.0
    r_var = radius**2 / 4.0
    t_var = (t1 - t0) ** 2 / 12.0
    return lift_gaussian(d, t_mean, t_var, r_var, diag)


def cast_rays(t_vals, origins, directions, radii, ray_shape="cone", diag=True):
    """Ray sections as Gaussians: ``t_vals [..., S+1]``, ``origins`` /
    ``directions [..., 3]``, ``radii [..., 1]`` -> (means, covs)
    ``[..., S, 3]``."""
    t0 = t_vals[..., :-1]
    t1 = t_vals[..., 1:]
    if ray_shape == "cone":
        gaussian_fn = conical_frustum_to_gaussian
    elif ray_shape == "cylinder":
        gaussian_fn = cylinder_to_gaussian
    else:
        raise ValueError(f"unknown ray_shape {ray_shape!r}")
    means, covs = gaussian_fn(directions, t0, t1, radii, diag)
    return means + origins[..., None, :], covs


# --------------------------------------------------------------------------
# Integrated positional encoding (reference math_utils.py:112-152)
# --------------------------------------------------------------------------


def expected_sin(x, x_var):
    """E[sin z], Var[sin z] for z ~ N(x, x_var)."""
    y = torch.exp(-0.5 * x_var) * safe_sin(x)
    y_var = torch.clamp(
        0.5 * (1.0 - torch.exp(-2.0 * x_var) * safe_cos(2.0 * x)) - y**2,
        min=0.0)
    return y, y_var


@functools.cache
def _level_scales(min_deg: int, max_deg: int, dtype, device):
    """``2^l`` for each level, exact, uploaded once per device: a copy from
    the host at every call would make the caller wait for the device, and
    cannot be recorded into a CUDA graph."""
    with torch.inference_mode(False):  # a normal tensor, whoever asks first
        return torch.tensor([2.0**i for i in range(min_deg, max_deg)],
                            dtype=dtype, device=device)


def integrated_pos_enc(means_covs, min_deg=0, max_deg=16, diag=True,
                       double_angle=True):
    """IPE over degrees ``[min_deg, max_deg)``: ``(means, covs) [..., 3]``
    -> ``[..., 6 * (max_deg - min_deg)]`` laid out as
    ``[sin(2^l x) by (l, dim) | cos(2^l x) by (l, dim)]``, each attenuated
    by ``exp(-0.5 * 4^l * cov)``.

    ``double_angle`` (the config default, ``parallel.ipe_double_angle``)
    evaluates one sin/cos pair at the base frequency and climbs the levels
    by ``sin 2a = 2 sin a cos a``, ``cos 2a = 1 - 2 sin² a``; otherwise each
    level is evaluated directly as ``sin(2^l x [+ π/2])``.
    """
    if not diag:
        raise NotImplementedError("full-covariance IPE is used by no config")
    x, x_cov_diag = means_covs
    shape = x.shape[:-1] + (-1,)
    if double_angle:
        base = x * (2.0**min_deg)
        s, c = safe_sin(base), safe_cos(base)
        sin_feats, cos_feats = [], []
        var_scale = 4.0**min_deg
        for deg in range(min_deg, max_deg):
            w = torch.exp((-0.5 * var_scale) * x_cov_diag)
            sin_feats.append(w * s)
            cos_feats.append(w * c)
            if deg + 1 < max_deg:
                s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
                var_scale = var_scale * 4.0
        sin_half = torch.stack(sin_feats, dim=-2).reshape(shape)
        cos_half = torch.stack(cos_feats, dim=-2).reshape(shape)
        return torch.cat([sin_half, cos_half], dim=-1)
    scales = _level_scales(min_deg, max_deg, x.dtype, x.device)
    y = (x[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (x_cov_diag[..., None, :] * scales[:, None] ** 2).reshape(shape)
    return expected_sin(
        torch.cat([y, y + 0.5 * math.pi], dim=-1),
        torch.cat([y_var, y_var], dim=-1),
    )[0]


def positional_encoding(x, num_freqs=4, include_input=True, log_sampling=True):
    """Classic NeRF PE of the view directions (nerf_helpers.py:127-171):
    ``[x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...]``."""
    if num_freqs == 0:
        return x
    if log_sampling:
        freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    else:
        freqs = torch.linspace(1.0, 2.0 ** (num_freqs - 1), num_freqs,
                               dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]  # [..., F, D]
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)
    enc = enc.reshape(x.shape[:-1] + (-1,))
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc


# --------------------------------------------------------------------------
# Truncated-Gaussian CDF machinery (reference math_utils.py:193-208)
# --------------------------------------------------------------------------


def normal_cdf(x):
    return 0.5 * (1.0 + torch.erf(x / _SQRT2))


def normal_inverse_cdf(x):
    return _SQRT2 * torch.erfinv(2.0 * x - 1.0)


def truncated_gaussian_tails(mus, sigmas):
    """``(Φ(-μ/σ), Φ((1-μ)/σ) - Φ(-μ/σ))``: the left tail and the mass of
    the per-section N(μ, σ) inside [0, 1] (reference models.py:254-258)."""
    left_tail = normal_cdf((0.0 - mus) / sigmas)
    part_inside_bins = normal_cdf((1.0 - mus) / sigmas) - left_tail
    return left_tail, part_inside_bins


# --------------------------------------------------------------------------
# Losses and metrics (reference nerf_helpers.py)
# --------------------------------------------------------------------------


def img2mse(img_src, img_tgt):
    return torch.mean((img_src - img_tgt) ** 2)


def mse2psnr(mse):
    """PSNR of an MSE, floored at 1e-5 (50 dB) as the JAX package."""
    mse = torch.clamp(torch.as_tensor(mse), min=1e-5)
    return -10.0 * torch.log10(mse)


def bins_for_percentage(weights, percentage):
    """Number of bins holding ``percentage`` of each ray's probability mass
    (reference math_utils.py:169-181): the pdf sorted in descending order,
    its running sum without the last bin, the bins below ``percentage``,
    plus one.  ``weights [N, S]`` -> ``[N]`` (an info-concentration
    diagnostic)."""
    pdf = weights / torch.sum(weights, dim=1, keepdim=True)
    info_sorted = torch.flip(torch.sort(pdf, dim=-1).values, dims=(-1,))
    info_sum = torch.cumsum(info_sorted[..., :-1], dim=-1)
    return torch.sum(info_sum < percentage, dim=1) + 1
