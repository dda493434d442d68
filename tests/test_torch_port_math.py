"""Port parity: core/math.py and core/rays.py of ddnerf_tpu_torch against
the JAX package on the same seeded numpy inputs (CPU, float32)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddnerf_tpu.core import math as jm
from ddnerf_tpu.core import rays as jrays
from ddnerf_tpu_torch.core import math as tm
from ddnerf_tpu_torch.core import rays as trays

# Same float32 formulas on both sides; differences are the last-ulp
# rounding of exp/sin/erf implementations.
RTOL = ATOL = 1e-5


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_safe_trig_wraps_past_100_pi():
    rng = np.random.default_rng(0)
    t = 100.0 * np.pi
    x = np.concatenate([
        rng.uniform(-4 * t, 4 * t, 200),  # wrapped
        rng.uniform(-t, t, 200),  # not wrapped
        np.array([t - 1e-3, t + 1e-3, -t - 1e-3, 3.5 * t]),
    ]).astype(np.float32)
    _close(tm.safe_sin(_t(x)), jm.safe_sin(jnp.asarray(x)), atol=1e-4)
    _close(tm.safe_cos(_t(x)), jm.safe_cos(jnp.asarray(x)), atol=1e-4)
    # Past the threshold the argument is reduced modulo 100π (floor-mod).
    big = np.array([3.5 * t, -2.25 * t], np.float32)
    wrapped = np.mod(big.astype(np.float64), np.float32(t))
    _close(tm.safe_sin(_t(big)), np.sin(wrapped), atol=1e-4)


def _rays(n=9, s=7, seed=0):
    rng = np.random.default_rng(seed)
    t_vals = np.sort(rng.uniform(2.0, 6.0, (n, s + 1)), -1).astype(np.float32)
    origins = rng.standard_normal((n, 3)).astype(np.float32)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    radii = np.abs(rng.standard_normal((n, 1))).astype(np.float32) * 0.01
    return t_vals, origins, dirs, radii


@pytest.mark.parametrize("ray_shape", ["cone", "cylinder"])
def test_cast_rays_matches_jax(ray_shape):
    args = _rays()
    got = tm.cast_rays(*map(_t, args), ray_shape)
    want = jm.cast_rays(*map(jnp.asarray, args), ray_shape)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (9, 7, 3)
        _close(g, w)


def test_lift_gaussian_full_covariance_matches_jax():
    rng = np.random.default_rng(1)
    d = rng.standard_normal((5, 3)).astype(np.float32)
    tm_, tv, rv = (np.abs(rng.standard_normal((5, 4))).astype(np.float32)
                   for _ in range(3))
    got = tm.lift_gaussian(*map(_t, (d, tm_, tv, rv)), diag=False)
    want = jm.lift_gaussian(*map(jnp.asarray, (d, tm_, tv, rv)), diag=False)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("double_angle", [True, False])
def test_integrated_pos_enc_matches_jax(double_angle):
    """Means up to ±3 put 2^l x past 100π from degree 7 on, so the direct
    form runs the wrap; small covariances keep those degrees unattenuated."""
    rng = np.random.default_rng(2)
    means = rng.uniform(-3, 3, (6, 5, 3)).astype(np.float32)
    covs = (10.0 ** rng.uniform(-9, -1, (6, 5, 3))).astype(np.float32)
    got = tm.integrated_pos_enc((_t(means), _t(covs)),
                                double_angle=double_angle)
    want = jm.integrated_pos_enc((jnp.asarray(means), jnp.asarray(covs)),
                                 double_angle=double_angle)
    assert tuple(got.shape) == want.shape == (6, 5, 96)
    # Degrees 0..7 (columns l*3+j of each half) agree to float32 rounding.
    low = np.r_[0:24, 48:72]
    _close(got[..., low], np.asarray(want)[..., low])
    # High degrees amplify a last-ulp difference of the two libraries'
    # sin/cos: the recurrence by up to 2x per level (2^15 * 6e-8 ≈ 2e-3),
    # the direct form through its argument 2^15 x, whose f32 ulp is ~4e-3
    # rad at |x| = 3.  Both stay far below the bf16 rounding (2^-8) the
    # features get before the MLP.
    _close(got, want, atol=2e-3 if double_angle else 2e-2)


def test_positional_encoding_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((11, 3)).astype(np.float32)
    for log_sampling in (True, False):
        got = tm.positional_encoding(_t(x), 4, log_sampling=log_sampling)
        want = jm.positional_encoding(jnp.asarray(x), 4,
                                      log_sampling=log_sampling)
        assert tuple(got.shape) == (11, 27)
        _close(got, want)


def test_normal_cdf_inverse_and_tails_match_jax():
    rng = np.random.default_rng(4)
    x = rng.uniform(-5, 5, 500).astype(np.float32)
    u = rng.uniform(0.001, 0.999, 500).astype(np.float32)
    _close(tm.normal_cdf(_t(x)), jm.normal_cdf(jnp.asarray(x)))
    _close(tm.normal_inverse_cdf(_t(u)), jm.normal_inverse_cdf(jnp.asarray(u)),
           rtol=1e-4, atol=1e-5)
    mus = rng.uniform(0, 1, (7, 9)).astype(np.float32)
    sig = rng.uniform(0.001, 1.0, (7, 9)).astype(np.float32)
    for g, w in zip(tm.truncated_gaussian_tails(_t(mus), _t(sig)),
                    jm.truncated_gaussian_tails(jnp.asarray(mus),
                                                jnp.asarray(sig))):
        _close(g, w)


def test_device_ray_bundle_matches_host_and_jax_bundles():
    from ddnerf_tpu.data.synthetic import pose_spherical

    pose = pose_spherical(40.0, -30.0, 4.0)
    h, w, focal = 12, 10, 13.5
    got = trays.get_ray_bundle(h, w, focal, pose)
    host = jrays.get_ray_bundle(h, w, focal, pose)
    dev = jrays.get_ray_bundle_device(h, w, focal, pose)
    for g, a, b in zip(got, host, dev):
        assert tuple(g.shape) == a.shape
        _close(g, a, atol=1e-6)
        _close(g, b, atol=1e-6)
    # The epsilon nudge of zero components (nerf_helpers.py:114-115).
    eye = np.eye(4, dtype=np.float32)
    ro, rd, _ = trays.get_ray_bundle(4, 4, 2.0, eye)
    assert (ro != 0).all() and (rd != 0).all()
    _close(rd, jrays.get_ray_bundle(4, 4, 2.0, eye)[1], atol=1e-7)
