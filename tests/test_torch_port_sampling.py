"""Port parity: core/sampling.py and core/rendering.py of ddnerf_tpu_torch
against the JAX package.  Random draws are injected: the port receives the
exact uniforms JAX draws from the same key."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddnerf_tpu.core import math as jm
from ddnerf_tpu.core import rendering as jr
from ddnerf_tpu.core import sampling as js
from ddnerf_tpu_torch.core import math as tm
from ddnerf_tpu_torch.core import rendering as tr
from ddnerf_tpu_torch.core import sampling as ts

# float32 on both sides; the resampler's inverse normal CDF (erfinv)
# differs by a few ulp between libraries.
RTOL = ATOL = 1e-5


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _bounds(n=10):
    near = np.full((n, 1), 2.0, np.float32)
    far = np.full((n, 1), 6.0, np.float32)
    return near, far


@pytest.mark.parametrize("lindisp,combined", [(False, False), (True, False),
                                              (False, True)])
def test_first_cycle_det_matches_jax(lindisp, combined):
    near, far = _bounds()
    kw = dict(lindisp=lindisp, perturb=False, combined=combined,
              combined_near=2.0, combined_split=3.0)
    got = ts.sample_first_cycle(_t(near), _t(far), 8, **kw)
    want = js.sample_first_cycle(jax.random.PRNGKey(0), jnp.asarray(near),
                                 jnp.asarray(far), 8, **kw)
    assert tuple(got.shape) == (10, 9)
    _close(got, want)


def test_first_cycle_perturbed_matches_jax_with_injected_jitter():
    near, far = _bounds()
    key = jax.random.PRNGKey(3)
    t_rand = np.asarray(jax.random.uniform(key, (10, 9), jnp.float32))
    got = ts.sample_first_cycle(_t(near), _t(far), 8, t_rand=_t(t_rand))
    want = js.sample_first_cycle(key, jnp.asarray(near), jnp.asarray(far), 8)
    _close(got, want)
    # A generator draw: sorted, inside [near, far], endpoints pinned.
    g = torch.Generator().manual_seed(0)
    t = ts.sample_first_cycle(_t(near), _t(far), 8, generator=g)
    assert (t.diff(dim=-1) >= 0).all()
    assert (t[:, 0] == 2.0).all() and (t[:, -1] == 6.0).all()


def _resampler_inputs(n=12, s=9, seed=0):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(2.0, 6.0, (n, s + 1)), -1).astype(np.float32)
    bins[:, 0], bins[:, -1] = 2.0, 6.0
    weights = (rng.uniform(0, 1, (n, s)) ** 3).astype(np.float32)
    mus = rng.uniform(0.02, 0.98, (n, s)).astype(np.float32)
    sigmas = rng.uniform(0.01, 0.6, (n, s)).astype(np.float32)
    left, inside = jm.truncated_gaussian_tails(jnp.asarray(mus),
                                               jnp.asarray(sigmas))
    return bins, weights, mus, sigmas, np.asarray(inside), np.asarray(left)


@pytest.mark.parametrize("pdf_padding", [True, False])
@pytest.mark.parametrize("det", [True, False])
def test_mu_sigma_resampler_matches_jax(pdf_padding, det):
    bins, weights, mus, sigmas, inside, left = _resampler_inputs()
    m = 11
    key = jax.random.PRNGKey(5)
    jitter = None if det else _t(jax.random.uniform(key, (12, m), jnp.float32))
    got = ts.sample_pdf_with_mu_sigma(
        *map(_t, (bins, weights, mus, sigmas, inside, left)), m, near=2.0,
        far=6.0, pdf_padding=pdf_padding, det=det, jitter=jitter)
    want = js.sample_pdf_with_mu_sigma(
        key, *map(jnp.asarray, (bins, weights, mus, sigmas, inside, left)), m,
        near=2.0, far=6.0, pdf_padding=jnp.asarray(pdf_padding), det=det,
        fetch_precision="highest", skip_sort=True)
    assert tuple(got.shape) == (12, m)
    _close(got, want, rtol=1e-5, atol=2e-5)
    assert (got.diff(dim=-1) >= 0).all()  # sorted without the sort


def test_mu_sigma_resampler_single_section_matches_jax():
    bins, weights, mus, sigmas, inside, left = _resampler_inputs(s=1)
    args = (bins, weights, mus, sigmas, inside, left)
    got = ts.sample_pdf_with_mu_sigma(*map(_t, args), 5, near=2.0, far=6.0,
                                      pdf_padding=False)
    want = js.sample_pdf_with_mu_sigma(
        jax.random.PRNGKey(0), *map(jnp.asarray, args), 5, near=2.0, far=6.0,
        pdf_padding=jnp.asarray(False))
    _close(got, want, atol=2e-5)


def test_interval_index_uses_the_inclusive_convention():
    """u equal to a fencepost lands in the interval that starts there
    (``>=``, interval_one_hot), and the index stays in [0, S-1]."""
    cdf = torch.tensor([[0.0, 0.25, 0.5, 1.0]])
    u = torch.tensor([[0.0, 0.25, 0.3, 0.5, 0.9999, 1.0]])
    assert ts.interval_index(u, cdf).tolist() == [[0, 1, 1, 2, 2, 2]]
    oh = js.interval_one_hot(jnp.asarray(u.numpy()), jnp.asarray(cdf.numpy()))
    assert np.argmax(np.asarray(oh), -1).tolist() == [[0, 1, 1, 2, 2, 2]]


@pytest.mark.parametrize("white_background", [False, True])
@pytest.mark.parametrize("with_mus", [False, True])
def test_volume_render_matches_jax(white_background, with_mus):
    rng = np.random.default_rng(7)
    n, s = 10, 8
    raw_rgb = rng.standard_normal((n, s, 3)).astype(np.float32)
    raw_density = (rng.standard_normal((n, s)) * 3).astype(np.float32)
    raw_density[0] = -30.0  # an empty ray: the eps-mask pdf path
    raw_density[1, 2] = 80.0  # a saturated alpha
    t_vals = np.sort(rng.uniform(2, 6, (n, s + 1)), -1).astype(np.float32)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    mus = rng.uniform(0, 1, (n, s)).astype(np.float32) if with_mus else None
    kw = dict(white_background=white_background, eps_mask_pdf=True)
    got = tr.volume_render(_t(raw_rgb), _t(raw_density), _t(t_vals), _t(dirs),
                           mus=None if mus is None else _t(mus), **kw)
    want = jr.volume_render(jnp.asarray(raw_rgb), jnp.asarray(raw_density),
                            jnp.asarray(t_vals), jnp.asarray(dirs),
                            mus=None if mus is None else jnp.asarray(mus), **kw)
    for name in ("rgb", "disp", "acc", "weights", "depth", "rgb_raw"):
        _close(getattr(got, name), getattr(want, name), rtol=1e-5, atol=1e-6)
    assert (got.corrected_disp is None) == (not with_mus)
    if with_mus:
        _close(got.corrected_disp, want.corrected_disp, rtol=1e-5, atol=1e-6)


def test_volume_render_noise_comes_from_the_generator():
    rng = np.random.default_rng(8)
    raw_rgb = _t(rng.standard_normal((4, 5, 3)).astype(np.float32))
    dens = _t(rng.standard_normal((4, 5)).astype(np.float32))
    t_vals = _t(np.sort(rng.uniform(2, 6, (4, 6)), -1).astype(np.float32))
    dirs = _t(rng.standard_normal((4, 3)).astype(np.float32))

    def run(seed, std):
        g = torch.Generator().manual_seed(seed)
        return tr.volume_render(raw_rgb, dens, t_vals, dirs, generator=g,
                                noise_std=std).rgb

    assert torch.equal(run(0, 1.0), run(0, 1.0))
    assert not torch.equal(run(0, 1.0), run(1, 1.0))
    quiet = tr.volume_render(raw_rgb, dens, t_vals, dirs, noise_std=1.0).rgb
    assert torch.equal(run(0, 0.0), quiet)  # no generator or std 0: no noise


def test_tails_feed_the_resampler_like_jax():
    """The resampler's tail inputs, computed by the port, match JAX's."""
    _, _, mus, sigmas, inside, left = _resampler_inputs()
    got_left, got_inside = tm.truncated_gaussian_tails(_t(mus), _t(sigmas))
    _close(got_left, left)
    _close(got_inside, inside)
