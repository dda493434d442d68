"""The DDNeRF depth-prediction loss, and the densified per-ray pdfs of the
depth-analysis figures (:func:`uniform_incell_pdf`,
:func:`gaussian_incell_pdf`; ``ddnerf_tpu/core/dd.py:128-170``).

Counterpart of ``ddnerf_tpu/core/dd.py::estimate_dp_loss`` (reference
dd_utils.py:6-78) in the JAX package's row-aligned form: empty rays are
masked out of the mean instead of being dropped (which keeps every row
aligned; see the JAX docstring for the reference's misaligned
``left_tails`` under its filter).  The per-fencepost section values come
from ``torch.gather`` on the strict interval index where the JAX package
contracts a one-hot: a gather is exact, as the ``mixed``/``highest``
one-hot fetch is.  Its backward is the one-hot contraction itself
(:class:`_Take`), a sum in a fixed order: ``torch.gather``'s own backward
is a scatter-add by float atomics, whose result depends on the order the
device happens to run them in, and a train step must give the same bits
whether it runs eagerly or as a replayed CUDA graph.
"""

from __future__ import annotations

import torch

from ddnerf_tpu_torch.core.math import normal_cdf
from ddnerf_tpu_torch.core.sampling import interval_index

_EPS = 1e-12


class _Take(torch.autograd.Function):
    """``torch.gather(x, -1, ind)`` for ``x [N, S]`` and ``ind [N, M]``
    whose backward sums each section's cotangents through the one-hot mask
    ``ind == s`` (``[N, M, S]``, given by the caller, who shares it between
    the gathers of one index): deterministic, where a scatter-add is not."""

    @staticmethod
    def forward(ctx, x, ind, mask):
        ctx.save_for_backward(mask)
        return torch.gather(x, -1, ind)

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return torch.sum(torch.where(mask, g[..., None], 0.0), dim=-2), \
            None, None


def estimate_dp_loss(t_vals_1, t_vals_0, pdf_1, pdf_0, mus_0, sigmas_0,
                     left_tails_0, part_inside_cells_0, *,
                     filter_empty_rays: bool, variant: str = "kl"):
    """KL (or Jensen-Shannon) divergence between the fine weight
    distribution and the coarse truncated-Gaussian depth distribution
    evaluated at the fine fenceposts.

    ``t_vals_1 [N, M+1]`` fine fenceposts, ``t_vals_0 [N, S+1]`` coarse
    fenceposts, ``pdf_1 [N, M]`` fine weights (the target, detached here),
    ``pdf_0 [N, S]`` coarse weights, ``mus_0`` / ``sigmas_0`` /
    ``left_tails_0`` / ``part_inside_cells_0 [N, S]`` the section-space
    truncated Gaussians.  The caller detaches what the JAX pipeline
    stop-gradients.  Returns the mean over (kept rays x fine sections) of
    the divergence, which the caller multiplies by M (models.py:288).
    """
    keep = torch.sum(pdf_1, dim=1) > 1e-10  # [N]

    pdf_0 = (pdf_0 + _EPS) / torch.sum(pdf_0 + _EPS, dim=-1, keepdim=True)
    pdf_1 = (pdf_1 + _EPS) / torch.sum(pdf_1 + _EPS, dim=-1, keepdim=True)

    # mu, sigma from section space to ray space (dd_utils.py:34-36)
    seg = t_vals_0[..., 1:] - t_vals_0[..., :-1]
    mus_ray = t_vals_0[..., :-1] + mus_0 * seg
    sigmas_ray = sigmas_0 * seg

    # torch.minimum / maximum split the gradient at a tie as jnp's do
    # (torch.clamp would pass all of it).
    # Made on the device (a copy from the host would wait for it).
    one, zero = pdf_0.new_ones(()), pdf_0.new_zeros(())
    cdf = torch.minimum(torch.cumsum(pdf_0[..., :-1], dim=-1), one)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf,
                     torch.ones_like(cdf[..., :1])], dim=-1)  # [N, S+1]

    # The coarse section holding each fine fencepost (strict ">").
    ind = interval_index(t_vals_1, t_vals_0, strict=True)  # [N, M+1]

    mask = ind[..., None] == torch.arange(pdf_0.shape[-1], device=ind.device)

    def take(x):
        return _Take.apply(x, ind, mask)

    est_cdf = take(cdf[..., :-1])  # cdf at the section's start fencepost
    mus, sigmas = take(mus_ray), take(sigmas_ray)
    part_inside, left_tails = take(part_inside_cells_0), take(left_tails_0)
    pdf_sec = take(pdf_0)

    x = (t_vals_1 - mus) / sigmas
    additional = ((normal_cdf(x) - left_tails) / part_inside) * pdf_sec
    est_cdf = torch.minimum(est_cdf + additional, one)

    est_pdf_1 = torch.maximum(est_cdf[..., 1:] - est_cdf[..., :-1], zero)
    est_pdf_1 = (est_pdf_1 + _EPS) / torch.sum(est_pdf_1 + _EPS, dim=-1,
                                               keepdim=True)

    tgt = pdf_1.detach()
    if variant == "kl":
        kl = tgt * (torch.log(tgt) - torch.log(est_pdf_1))  # [N, M]
    elif variant == "js":
        # KL(m||target) + KL(m||estimate), m = (estimate + target) / 2
        # (reference loss.py:468-470).
        m = (est_pdf_1 + tgt) / 2.0
        kl = (m * (torch.log(m) - torch.log(tgt))
              + m * (torch.log(m) - torch.log(est_pdf_1)))
    else:
        raise ValueError(f"unknown dp loss variant {variant!r}")
    per_ray = torch.mean(kl, dim=-1)

    if filter_empty_rays:
        count = torch.clamp(torch.sum(keep), min=1)
        return torch.sum(torch.where(keep, per_ray, 0.0)) / count
    return torch.mean(per_ray)


# --------------------------------------------------------------------------
# Densified pdfs for the depth-analysis plots (math_utils.py:210-278)
# --------------------------------------------------------------------------


def uniform_incell_pdf(t_vals, weights, near, far, num_bins: int = 1000):
    """Densify a per-section histogram (``t_vals [N, S+1]``, ``weights
    [N, S]``) into ``num_bins`` uniform cells between ``near`` and ``far``
    -> ``[N, B]``: each section's mass is spread evenly over the bins that
    start inside it (reference math_utils.py:210-233)."""
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)  # [N, S]
    bins = torch.linspace(near, far, num_bins, dtype=t_vals.dtype,
                          device=t_vals.device)  # [B]
    start = t_vals[..., :-1, None]  # [N, S, 1]
    end = t_vals[..., 1:, None]
    relevant = (bins >= start) & (bins < end)  # [N, S, B]
    divided_by = torch.clamp(torch.sum(relevant, dim=-1, keepdim=True), min=1)
    return torch.sum(relevant * pdf[..., None] / divided_by, dim=-2)


def gaussian_incell_pdf(t_vals, weights, mus, sigmas, part_inside_cells,
                        near, far, num_bins: int = 1000):
    """Densify the truncated-Gaussian in-cell distribution onto ``num_bins``
    partitions between ``near`` and ``far`` -> ``[N, B]`` (reference
    math_utils.py:236-278).  A cell that comes out zero takes the mean of
    its neighbours (a shift by one with the ends pinned)."""
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)  # [N, S]
    seg = t_vals[..., 1:] - t_vals[..., :-1]
    mus_ray = t_vals[..., :-1] + mus * seg  # [N, S]
    sigmas_ray = sigmas * seg

    partitions = torch.linspace(near, far, num_bins + 1, dtype=t_vals.dtype,
                                device=t_vals.device)  # [B+1]
    x0, x1 = partitions[:-1], partitions[1:]  # [B]
    start = t_vals[..., :-1, None]  # [N, S, 1]
    end = t_vals[..., 1:, None]
    relevant = (x0 >= start) & (x1 <= end)  # [N, S, B]

    z0 = (x0 - mus_ray[..., None]) / sigmas_ray[..., None]
    z1 = (x1 - mus_ray[..., None]) / sigmas_ray[..., None]
    cells_cdf = (normal_cdf(z1) - normal_cdf(z0)) / part_inside_cells[..., None]
    est = torch.sum(relevant * cells_cdf * pdf[..., None], dim=-2)  # [N, B]

    left = torch.cat([est[..., :1], est[..., :-1]], dim=-1)
    right = torch.cat([est[..., 1:], est[..., -1:]], dim=-1)
    return torch.where(est == 0, (left + right) / 2.0, est)
