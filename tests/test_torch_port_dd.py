"""Port parity for the training slice's loss pieces: the compositing
weights' analytic adjoint, the strict interval index and the DDNeRF
depth-prediction loss of ddnerf_tpu_torch against the JAX package, on the
same numpy inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddnerf_tpu.core import dd as jdd
from ddnerf_tpu.core import math as jmath
from ddnerf_tpu.core.rendering import _weights_from_alpha_analytic
from ddnerf_tpu.core.sampling import interval_one_hot
from ddnerf_tpu_torch.core import dd, rendering
from ddnerf_tpu_torch.core import math as tmath
from ddnerf_tpu_torch.core.sampling import interval_index

F32_TOL = 1e-5  # f32 on both sides, same formulas: summation order only


def _alpha(rng, n=8, s=6, saturate=True):
    alpha = rng.uniform(0.0, 1.0, (n, s)).astype(np.float32)
    if saturate:
        alpha[0, 2] = 1.0  # exp underflow: a fully opaque section
        alpha[1, :] = 1.0
        alpha[2, -1] = 1.0
        alpha[3, 0] = 0.0
    return alpha


@pytest.mark.parametrize("saturate", [False, True])
def test_weights_from_alpha_adjoint_matches_jax(saturate):
    rng = np.random.default_rng(0)
    alpha = _alpha(rng, saturate=saturate)
    gw = rng.standard_normal(alpha.shape).astype(np.float32)
    w_jax, vjp = jax.vjp(_weights_from_alpha_analytic, jnp.asarray(alpha))
    (ga_jax,) = vjp(jnp.asarray(gw))

    a = torch.tensor(alpha, requires_grad=True)
    w = rendering.weights_from_alpha(a, analytic_vjp=True)
    w.backward(torch.tensor(gw))
    assert torch.isfinite(a.grad).all()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(w_jax),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ga_jax),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("saturate", [False, True])
def test_weights_from_alpha_adjoint_matches_f64_autograd(saturate):
    """The analytic adjoint is the gradient of the cumprod formula: held
    against float64 autograd of the plain form (f32 vs f64 rounding)."""
    rng = np.random.default_rng(1)
    alpha = _alpha(rng, saturate=saturate)
    gw = rng.standard_normal(alpha.shape).astype(np.float32)
    a = torch.tensor(alpha, requires_grad=True)
    rendering.weights_from_alpha(a, analytic_vjp=True).backward(
        torch.tensor(gw))
    a64 = torch.tensor(alpha, dtype=torch.float64, requires_grad=True)
    rendering.weights_from_alpha(a64, analytic_vjp=False).backward(
        torch.tensor(gw, dtype=torch.float64))
    assert torch.isfinite(a.grad).all()
    np.testing.assert_allclose(a.grad.numpy(), a64.grad.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_volume_render_differentiates_into_the_raw_heads():
    rng = np.random.default_rng(2)
    n, s = 5, 4
    raw_rgb = torch.tensor(rng.standard_normal((n, s, 3)).astype(np.float32),
                           requires_grad=True)
    raw_density = torch.tensor(rng.standard_normal((n, s)).astype(np.float32),
                               requires_grad=True)
    t = torch.tensor(np.sort(rng.uniform(2, 6, (n, s + 1)), -1)
                     .astype(np.float32))
    rd = torch.tensor(rng.standard_normal((n, 3)).astype(np.float32))
    grads = []
    for analytic in (True, False):
        out = rendering.volume_render(raw_rgb, raw_density, t, rd,
                                      eps_mask_pdf=True,
                                      analytic_weights_vjp=analytic)
        g = torch.autograd.grad((out.rgb.sum() + out.depth.sum()),
                                (raw_rgb, raw_density))
        grads.append(g)
    for a, b in zip(*grads):
        assert a.abs().sum() > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_strict_interval_index_matches_the_one_hot():
    """``interval_index(strict=True)`` is ``interval_one_hot(strict=True)``'s
    hot column, ties on interior fenceposts included."""
    rng = np.random.default_rng(3)
    fences = np.sort(rng.uniform(2, 6, (6, 9)), -1).astype(np.float32)
    x = np.sort(rng.uniform(1.5, 6.5, (6, 11)), -1).astype(np.float32)
    x[0, 3] = fences[0, 4]  # exactly on an interior fencepost
    x[1, 0] = fences[1, 0]
    x[2, -1] = fences[2, -1]
    for strict in (True, False):
        oh = np.asarray(interval_one_hot(jnp.asarray(x), jnp.asarray(fences),
                                         strict=strict))
        got = interval_index(torch.tensor(x), torch.tensor(fences),
                             strict=strict).numpy()
        np.testing.assert_array_equal(got, oh.argmax(-1))


def _dp_inputs(seed, n=10, s=5, m=6, empty_rows=()):
    rng = np.random.default_rng(seed)
    t0 = np.sort(rng.uniform(2, 6, (n, s + 1)), -1).astype(np.float32)
    t0[:, 0], t0[:, -1] = 2.0, 6.0
    t1 = np.sort(rng.uniform(2, 6, (n, m + 1)), -1).astype(np.float32)
    t1[:, 0], t1[:, -1] = 2.0, 6.0
    pdf1 = rng.uniform(0, 1, (n, m)).astype(np.float32)
    for r in empty_rows:
        pdf1[r] = 0.0
    # Wide in-cell Gaussians keep every estimated fine-section mass well
    # above f32 resolution: the loss takes log(mass), and a mass near 1e-7
    # is decided by the rounding of the coarse CDF's cumsum, whose
    # association differs between XLA and torch.
    pdf0 = rng.uniform(0.2, 1, (n, s)).astype(np.float32)
    mus = rng.uniform(0.2, 0.8, (n, s)).astype(np.float32)
    sigmas = rng.uniform(0.3, 0.9, (n, s)).astype(np.float32)
    left, inside = jmath.truncated_gaussian_tails(jnp.asarray(mus),
                                                  jnp.asarray(sigmas))
    return (t1, t0, pdf1, pdf0, mus, sigmas, np.asarray(left),
            np.asarray(inside))


@pytest.mark.parametrize("filter_empty", [False, True])
@pytest.mark.parametrize("empty_rows", [(), (2, 7)])
@pytest.mark.parametrize("variant", ["kl", "js"])
def test_dp_loss_value_and_gradients_match_jax(variant, empty_rows,
                                               filter_empty):
    args = _dp_inputs(4, empty_rows=empty_rows)
    diff = (3, 4, 5)  # pdf_0, mus_0, sigmas_0 carry gradients in training

    def jax_loss(*d):
        a = list(map(jnp.asarray, args))
        for i, v in zip(diff, d):
            a[i] = v
        return jdd.estimate_dp_loss(*a, filter_empty_rays=filter_empty,
                                    variant=variant)

    want, want_g = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(args[i]) for i in diff))
    t = [torch.tensor(a) for a in args]
    for i in diff:
        t[i].requires_grad_(True)
    got = dd.estimate_dp_loss(*t, filter_empty_rays=filter_empty,
                              variant=variant)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=F32_TOL,
                               atol=F32_TOL)
    for i, g in zip(diff, want_g):
        np.testing.assert_allclose(t[i].grad.numpy(), np.asarray(g),
                                   rtol=F32_TOL, atol=F32_TOL)


def test_dp_loss_rejects_an_unknown_variant():
    t = [torch.tensor(a) for a in _dp_inputs(5)]
    with pytest.raises(ValueError, match="variant"):
        dd.estimate_dp_loss(*t, filter_empty_rays=False, variant="l2")


def test_mse_and_psnr_match_jax():
    rng = np.random.default_rng(6)
    a, b = rng.uniform(0, 1, (2, 7, 3)).astype(np.float32)
    mse = tmath.img2mse(torch.tensor(a), torch.tensor(b))
    np.testing.assert_allclose(mse.item(),
                               float(jmath.img2mse(jnp.asarray(a),
                                                   jnp.asarray(b))),
                               rtol=F32_TOL)
    for v in (mse.item(), 1e-7, 0.25):
        np.testing.assert_allclose(tmath.mse2psnr(torch.tensor(v)).item(),
                                   float(jmath.mse2psnr(jnp.float32(v))),
                                   rtol=F32_TOL)
