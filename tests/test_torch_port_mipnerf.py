"""Port parity for the mip-NeRF path (``nerf.type: GeneralMipNerfModel``):
the plain inverse-CDF resampler, ``_render_mipnerf`` in its three modes,
the train loss and its gradient through the shared network (which appears
twice in one autograd graph), ten co-trained Adam steps, and the shipped
mip-NeRF configs, against the JAX package on the CPU with seeded numpy
inputs and transplanted weights."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddnerf_tpu.config import Config, load_config
from ddnerf_tpu.core import sampling as js
from ddnerf_tpu.models.nerf import NerfPipeline as JaxPipeline
from ddnerf_tpu.models.nerf import RayBatch as JaxRays
from ddnerf_tpu.models.nerf import ScheduleValues as JaxSched
from ddnerf_tpu.train.state import create_train_state
from ddnerf_tpu.train.step import compute_loss as jax_compute_loss
from ddnerf_tpu.train.step import make_train_step
from ddnerf_tpu.train.step import schedule_values as jax_schedule_values
from ddnerf_tpu_torch.core import sampling as ts
from ddnerf_tpu_torch.kernels import fused_mlp as fk
from ddnerf_tpu_torch.models.mlp import MipMLP
from ddnerf_tpu_torch.models.nerf import NerfPipeline, RayBatch, ScheduleValues
from ddnerf_tpu_torch.train.state import TrainState
from ddnerf_tpu_torch.train.step import compute_loss, schedule_values, train_step
from ddnerf_tpu_torch.utils.weights import (
    params_to_state_dict,
    pipeline_state_from_params,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 end to end: resampled fenceposts move with the coarse weights'
# summation order, and the fine cycle sees that (as
# tests/test_torch_port_pipeline.py).
TOL = 2e-3
# bf16 operands on both sides: an order change can flip one rounding (as
# tests/test_torch_port_enc.py).
BF16_TOL = 2e-2
KEYS = ("rgb", "disp", "acc", "weights", "depth", "t_vals")


def _t(x):
    return torch.tensor(np.asarray(x))


# -------------------------------------------------------------- the resampler

def _histograms(n=12, s=9, seed=0):
    """Seeded histograms; ray 0 has all-zero weights, ray 1 one spike."""
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(2.0, 6.0, (n, s + 1)), -1).astype(np.float32)
    bins[:, 0], bins[:, -1] = 2.0, 6.0
    weights = (rng.uniform(0, 1, (n, s)) ** 3).astype(np.float32)
    weights[0] = 0.0
    weights[1] = 0.0
    weights[1, 4] = 1.0
    return bins, weights


@pytest.mark.parametrize("pdf_padding", [True, False])
@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf_matches_jax(pdf_padding, det):
    """Deterministic ``u`` (whose last value, 1.0, meets the last fence)
    and the jittered grid fed the uniforms JAX draws from the same key.
    f32 on both sides, a gather against an exact one-hot fetch: 1e-6."""
    bins, weights = _histograms()
    m = 11
    key = jax.random.PRNGKey(5)
    jitter = None if det else _t(jax.random.uniform(key, (12, m), jnp.float32))
    got = ts.sample_pdf(_t(bins), _t(weights), m, pdf_padding=pdf_padding,
                        det=det, jitter=jitter)
    want = js.sample_pdf(key, jnp.asarray(bins), jnp.asarray(weights), m,
                         pdf_padding=jnp.asarray(pdf_padding), det=det,
                         fetch_precision="highest")
    assert tuple(got.shape) == (12, m) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert (got.diff(dim=-1) >= 0).all() and torch.isfinite(got).all()
    assert (got >= 2.0).all() and (got <= 6.0).all()


def test_sample_pdf_draws_from_the_generator_and_is_detached():
    bins, weights = _histograms()
    w = _t(weights).requires_grad_()
    a = ts.sample_pdf(_t(bins), w, 7, pdf_padding=False, det=False,
                      generator=torch.Generator().manual_seed(3))
    b = ts.sample_pdf(_t(bins), w, 7, pdf_padding=False, det=False,
                      generator=torch.Generator().manual_seed(3))
    c = ts.sample_pdf(_t(bins), w, 7, pdf_padding=False, det=False,
                      generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not a.requires_grad
    # Half-precision inputs are gathered in float32.
    half = ts.sample_pdf(_t(bins).bfloat16(), _t(weights).bfloat16(), 7,
                         pdf_padding=False)
    assert half.dtype == torch.float32


# --------------------------------------------------------------- the pipeline

def _cfg(**parallel):
    return Config.from_dict({
        "experiment": {"train_iters": 100},
        "train_params": {"loss_coeficients": [1.0, 0.1]},
        "optimizer": {"lr_init": 1e-3, "lr_final": 1e-4, "lr_delay_steps": 0},
        "nerf": {
            "type": "GeneralMipNerfModel", "coarse_hidden_size": 32,
            "fine_hidden_size": 32,
            "train": {"num_coarse": 6, "num_fine": 6, "num_random_rays": 16,
                      "perturb": False, "radiance_field_noise_std": 0.0},
            "validation": {"num_coarse": 6, "num_fine": 6, "perturb": False,
                           "radiance_field_noise_std": 0.0, "chunksize": 50},
        },
        "dataset": {"type": "blender", "near": 2.0, "far": 6.0},
        "parallel": {"compute_dtype": "float32", "num_devices": 1,
                     "microbatch_rays": 0, **parallel},
    }).resolved()


def _rays(n=16, seed=0):
    rng = np.random.default_rng(seed)
    ro = rng.standard_normal((n, 3)).astype(np.float32)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True) * 0.8  # non-unit norms
    radii = np.abs(rng.standard_normal((n, 1))).astype(np.float32) * 0.01
    target = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return ro, rd, radii, target


def _pipelines(jcfg, cfg):
    jpipe = JaxPipeline(jcfg)
    params = jpipe.init_params(jax.random.PRNGKey(0))
    assert set(params) == {"coarse"}
    pipe = NerfPipeline(cfg, "cpu")
    pipe.load_state_dicts(**pipeline_state_from_params(params))
    return jpipe, params, pipe


def _render_both(jcfg, cfg, mode, step=30):
    jpipe, params, pipe = _pipelines(jcfg, cfg)
    ro, rd, radii, _ = _rays()
    want = jpipe.render_rays(
        params, JaxRays.create(*map(jnp.asarray, (ro, rd, radii)), 2.0, 6.0),
        jax.random.PRNGKey(1), jax_schedule_values(jcfg, step), mode)
    got = pipe.render_rays(
        RayBatch.create(*map(torch.tensor, (ro, rd, radii)), 2.0, 6.0),
        schedule_values(cfg, step), mode)
    return got, want


@pytest.mark.parametrize("mode", ["render", "validation", "train"])
def test_render_mipnerf_matches_jax(mode):
    """f32, ``pallas_mlp: off`` on both sides; the returned keys are
    exactly JAX's (no μ-corrected disparity, no μ/σ, no dp loss)."""
    cfg = _cfg(pallas_mlp="off")
    got, want = _render_both(cfg, cfg, mode)
    for i in (0, 1):
        assert set(got[i]) == set(want[i]) == set(KEYS)
        for key in KEYS:
            np.testing.assert_allclose(
                got[i][key].detach().numpy(), np.asarray(want[i][key]),
                rtol=TOL, atol=TOL, err_msg=f"{mode} cycle {i} {key}")
    assert got[1]["rgb"].requires_grad == (mode == "train")
    assert not got[1]["t_vals"].requires_grad


@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("variant,mode", [("mlp", "render"),
                                          ("ipe2", "render"),
                                          ("mlp", "train")])
def test_mipnerf_through_kernel_wrappers_matches_jax_pallas_interpret(
        dtype, tol, variant, mode):
    """``use_pallas_mlp: true``: the JAX side runs its Pallas kernels in
    interpret mode (B1 or B3 to render, B1s + B2's forward to train), the
    port the wrappers' plain versions, both cycles on the one net."""
    cfg = _cfg(use_pallas_mlp=True, compute_dtype=dtype,
               render_kernel_variant=variant, kernel_per_ray_dirs=True)
    got, want = _render_both(cfg, cfg, mode)
    for i in (0, 1):
        for key in ("rgb", "acc", "depth"):
            np.testing.assert_allclose(
                got[i][key].detach().numpy(), np.asarray(want[i][key]),
                rtol=tol, atol=tol, err_msg=f"cycle {i} {key}")


def test_generator_draw_order_is_jitter_noise_resample_noise():
    """The documented order of the four draws: two pipelines from one seed
    agree, and the stream's position after a render is that of the four
    draws made by hand in that order."""
    cfg = _cfg(pallas_mlp="off")
    cfg = cfg.replace_at("nerf.validation", cfg.nerf.validation.__class__(
        num_coarse=6, num_fine=6, perturb=True, radiance_field_noise_std=1.0))
    pipe = NerfPipeline(cfg, "cpu", seed=1)
    ro, rd, radii, _ = _rays(5)
    rays = RayBatch.create(*map(torch.tensor, (ro, rd, radii)), 2.0, 6.0)
    sched = ScheduleValues.for_eval(cfg)
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    a = pipe.render_rays(rays, sched, "render", g1)
    b = pipe.render_rays(rays, sched, "render", g2)
    assert torch.equal(a[1]["rgb"], b[1]["rgb"])
    by_hand = torch.Generator().manual_seed(9)
    for shape, draw in (((5, 7), torch.rand), ((5, 6), torch.randn),
                        ((5, 7), torch.rand), ((5, 6), torch.randn)):
        draw(shape, generator=by_hand)
    assert torch.equal(g1.get_state(), by_hand.get_state())
    with pytest.raises(ValueError, match="Generator"):
        pipe.render_rays(rays, sched, "render")


# ------------------------------------------------------------------ training

def _shared_grads(pipe):
    return {n: p.grad for n, p in pipe.coarse.named_parameters()}


def test_parameters_list_each_tensor_once_and_adam_accepts_them():
    pipe = NerfPipeline(_cfg(), "cpu")
    params = pipe.parameters()
    assert len({id(p) for p in params}) == len(params) == 24
    assert pipe.networks() == [pipe.coarse] and isinstance(pipe.coarse, MipMLP)
    state = TrainState(pipe.cfg, pipe)  # Adam refuses duplicates
    assert sum(len(g["params"]) for g in state.optimizer.param_groups) == 24


def test_train_loss_and_gradients_match_jax_fused_train_kernels():
    """Port ``pallas_mlp: auto`` (CPU: the training Function's plain
    versions, twice in one graph on the same parameters) against JAX
    ``pallas_mlp: train`` with per-ray dirs (``fused_mlp_train_apply`` in
    interpret mode), f32, loss weights [1, 0.1], no jitter or noise.  The
    two cycles' gradients sum on the same leaves.  2e-4 on each gradient
    (norm-relative, as tests/test_fused_mlp_bwd.py holds the kernel)."""
    jcfg = _cfg(pallas_mlp="train", kernel_per_ray_dirs=True)
    cfg = _cfg(pallas_mlp="auto")
    jpipe, params, pipe = _pipelines(jcfg, cfg)
    assert pipe.use_train_kernel
    ro, rd, radii, target = _rays()
    sched = jax_schedule_values(jcfg, 10)

    def loss_fn(p):
        return jax_compute_loss(
            jcfg, jpipe, p,
            JaxRays.create(*map(jnp.asarray, (ro, rd, radii)), 2.0, 6.0),
            jnp.asarray(target), jax.random.PRNGKey(3), sched)

    (want_loss, want_m), want_g = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    loss, m = compute_loss(
        cfg, pipe, RayBatch.create(*map(torch.tensor, (ro, rd, radii)), 2.0,
                                   6.0),
        torch.tensor(target), schedule_values(cfg, 10))
    loss.backward()
    assert set(m) == set(want_m) == {"loss", "loss_coarse", "loss_fine"}
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for key in m:
        np.testing.assert_allclose(m[key].item(), float(want_m[key]),
                                   rtol=1e-4, atol=1e-7, err_msg=key)
    want = params_to_state_dict(want_g["coarse"])
    for name, g in _shared_grads(pipe).items():
        rel = ((g - want[name]).norm() / want[name].norm()).item()
        assert rel <= 2e-4, (name, rel)


def test_two_calls_in_one_graph_sum_on_the_shared_leaves():
    """The summed gradient equals the sum of the two cycles' own gradients
    (each taken with the other cycle's loss weight at zero), and both calls
    of the training Function see the same network object."""
    ro, rd, radii, target = _rays(8, seed=2)

    def grads(coefs):
        cfg = _cfg(pallas_mlp="auto").replace_at(
            "train_params.loss_coeficients", coefs)
        pipe = NerfPipeline(cfg, "cpu", seed=5)
        loss, _ = compute_loss(
            cfg, pipe, RayBatch.create(*map(torch.tensor, (ro, rd, radii)),
                                       2.0, 6.0),
            torch.tensor(target), schedule_values(cfg, 0))
        nodes, stack = [], [loss.grad_fn]
        while stack:
            fn = stack.pop()
            if fn is None or fn in nodes:
                continue
            nodes.append(fn)
            stack += [nxt for nxt, _ in fn.next_functions]
        fused = [fn for fn in nodes if "FusedMLPTrain" in type(fn).__name__]
        assert len(fused) == 2 and fused[0].net is fused[1].net is pipe.coarse
        loss.backward()
        return _shared_grads(pipe)

    both, first, second = grads([1.0, 0.1]), grads([1.0, 0.0]), grads([0.0, 0.1])
    for name in both:
        np.testing.assert_allclose(
            both[name].numpy(), (first[name] + second[name]).numpy(),
            rtol=1e-4, atol=1e-7, err_msg=name)
        assert second[name].abs().sum() > 0  # the fine cycle reaches the net


def test_cotrained_trajectory_matches_jax_train_step():
    """Ten Adam steps on identical injected batches from identical weights,
    as tests/test_torch_port_trajectory.py does for DDNeRF (its
    tolerances: losses to summation order; a weight may differ by up to lr
    per step, each tensor as a whole to 1e-3 norm-relative)."""
    steps = 10
    jcfg = _cfg(pallas_mlp="off")
    jpipe = JaxPipeline(jcfg)
    jstate = create_train_state(jcfg, jpipe, jax.random.PRNGKey(0))
    step = jax.jit(make_train_step(jcfg, jpipe))
    cfg = _cfg(pallas_mlp="auto")
    pipe = NerfPipeline(cfg, "cpu")
    pipe.load_state_dicts(**pipeline_state_from_params(jstate.params))
    state = TrainState(cfg, pipe)
    rng = np.random.default_rng(0)
    for i in range(steps):
        n = 16
        rd = rng.standard_normal((n, 3)).astype(np.float32)
        batch = {
            "origins": rng.standard_normal((n, 3)).astype(np.float32) * 0.3,
            "directions": rd / np.linalg.norm(rd, axis=-1, keepdims=True),
            "radii": np.full((n, 1), 0.003, np.float32),
            "rgb": rng.uniform(0, 1, (n, 3)).astype(np.float32)}
        jstate, jm = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        m = train_step(cfg, pipe, state,
                       {k: torch.tensor(v) for k, v in batch.items()})
        assert "dp_loss" not in m and "dp_loss" not in jm
        for key in ("loss", "loss_coarse", "loss_fine", "psnr_fine", "lr"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=1e-4, err_msg=f"{i} {key}")
    assert state.step == int(jstate.step) == steps
    want = params_to_state_dict(jstate.params["coarse"])
    for name, p in pipe.coarse.named_parameters():
        diff = p.detach() - want[name]
        assert (diff.norm() / want[name].norm()).item() <= 1e-3, name
        assert diff.abs().max().item() <= steps * 1e-3, name


def test_training_launch_counts_stay_zero_on_cpu():
    cfg = _cfg(pallas_mlp="auto")
    pipe = NerfPipeline(cfg, "cpu")
    ro, rd, radii, target = _rays()
    before = dict(fk.LAUNCHES)
    loss, _ = compute_loss(cfg, pipe, RayBatch.create(
        *map(torch.tensor, (ro, rd, radii)), 2.0, 6.0), torch.tensor(target),
        schedule_values(cfg, 0))
    loss.backward()
    assert fk.LAUNCHES == before
    assert all(p.grad is not None for p in pipe.parameters())


# ------------------------------------------------------------ shipped configs

@pytest.mark.parametrize("name", ["blender_mipnerf.yml", "ff_mipnerf.yml",
                                  "real360_mipnerf.yml"])
def test_shipped_mipnerf_config_constructs_a_pipeline(name):
    cfg = load_config(os.path.join(REPO, "configs", name))
    pipe = NerfPipeline(cfg, "cpu")
    assert pipe.shared_net and pipe.fine is None
    assert pipe.coarse.hidden_size == cfg.nerf.coarse_hidden_size == 256
    assert pipe.coarse.out_dim == 4
    assert pipe.use_kernel and pipe.use_train_kernel
    assert JaxSched.for_eval(cfg) == tuple(ScheduleValues.for_eval(cfg))
