"""Port parity over several steps and whole images: a co-trained
trajectory of Adam steps (the port's train step against the JAX package's
jitted ``make_train_step`` on identical injected batches from identical
weights), and the validation-mode renderer (maps and the chunk-weighted
``dp_loss``) against the JAX renderer."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from ddnerf_tpu.config import Config
from ddnerf_tpu.data.synthetic import pose_spherical
from ddnerf_tpu.models.nerf import NerfPipeline as JaxPipeline
from ddnerf_tpu.render.renderer import ImageRenderer as JaxRenderer
from ddnerf_tpu.train.state import create_train_state
from ddnerf_tpu.train.step import make_train_step
from ddnerf_tpu.train.step import schedule_values as jax_schedule_values
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.render.renderer import VALIDATION_KEYS, ImageRenderer
from ddnerf_tpu_torch.train.state import TrainState
from ddnerf_tpu_torch.train.step import schedule_values, train_step
from ddnerf_tpu_torch.utils.weights import params_to_state_dict

STEPS = 10
# f32 on both sides.  Losses: the same function of weights that agree to
# ~1e-6, summation order only.  Weights: each Adam step moves a weight by
# about lr (1e-3) in the sign of m / sqrt(v); a gradient near zero, whose
# f32 summation noise is comparable to its size, can turn that step, so a
# few weights may differ by up to lr per step (bounded by STEPS * lr), while
# each tensor as a whole agrees to summation order (norm-relative).
LOSS_RTOL = 1e-4
# The dp loss takes the log of estimated fine-section masses; where a mass
# is small, the f32 rounding of the coarse CDF's cumsum (associated
# differently by XLA and torch) moves it by a larger relative amount.
DP_LOSS_RTOL = 1e-3
WEIGHT_NORM_REL_TOL = 1e-3
WEIGHT_MAX_ABS = STEPS * 1e-3


def _cfg(coarse=32, fine=32, **parallel):
    return Config.from_dict({
        "experiment": {"train_iters": 100},
        "optimizer": {"lr_init": 1e-3, "lr_final": 1e-4, "lr_delay_steps": 0},
        "nerf": {
            "type": "DDNerfModel", "coarse_hidden_size": coarse,
            "fine_hidden_size": fine,
            "train": {"num_coarse": 6, "num_fine": 6, "num_random_rays": 16,
                      "perturb": False, "radiance_field_noise_std": 0.0},
            "validation": {"num_coarse": 6, "num_fine": 6, "perturb": False,
                           "radiance_field_noise_std": 0.0, "chunksize": 40},
        },
        "dataset": {"type": "blender", "near": 2.0, "far": 6.0},
        "parallel": {"compute_dtype": "float32", "num_devices": 1,
                     "microbatch_rays": 0, **parallel},
    }).resolved()


def _batches(n_steps, n=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        ro = rng.standard_normal((n, 3)).astype(np.float32) * 0.3
        rd = rng.standard_normal((n, 3)).astype(np.float32)
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
        radii = np.full((n, 1), 0.003, np.float32)
        rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        out.append({"origins": ro, "directions": rd, "radii": radii,
                    "rgb": rgb})
    return out


def _cotrain(coarse=32, fine=32):
    jcfg = _cfg(coarse, fine, pallas_mlp="off")
    jpipe = JaxPipeline(jcfg)
    jstate = create_train_state(jcfg, jpipe, jax.random.PRNGKey(0))
    step = jax.jit(make_train_step(jcfg, jpipe))

    cfg = _cfg(coarse, fine, pallas_mlp="auto")
    pipe = NerfPipeline(cfg, "cpu")
    pipe.load_state_dicts(params_to_state_dict(jstate.params["coarse"]),
                          params_to_state_dict(jstate.params["fine"]))
    state = TrainState(cfg, pipe)

    for i, batch in enumerate(_batches(STEPS)):
        jstate, jm = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        m = train_step(cfg, pipe, state,
                       {k: torch.tensor(v) for k, v in batch.items()})
        for key in ("loss", "loss_fine", "dp_loss", "psnr_fine", "lr"):
            np.testing.assert_allclose(
                m[key].item(), float(jm[key]), err_msg=f"{i} {key}",
                rtol=DP_LOSS_RTOL if key == "dp_loss" else LOSS_RTOL)
    assert state.step == int(jstate.step) == STEPS
    for net, module in (("coarse", pipe.coarse), ("fine", pipe.fine)):
        want = params_to_state_dict(jstate.params[net])
        for name, p in module.named_parameters():
            diff = p.detach() - want[name]
            rel = (diff.norm() / want[name].norm()).item()
            assert rel <= WEIGHT_NORM_REL_TOL, (net, name, rel)
            assert diff.abs().max().item() <= WEIGHT_MAX_ABS, (net, name)
    return pipe


def test_cotrained_trajectory_matches_jax_train_step():
    """Port ``pallas_mlp: auto`` (CPU: the training Function's plain
    versions) against the JAX XLA step (``pallas_mlp: off``, a short jit;
    the kernel policy's gradients are held against the Pallas kernels in
    tests/test_torch_port_train.py)."""
    _cotrain()


def test_cotrained_trajectory_with_two_widths_matches_jax_train_step():
    """The same with a coarse and a fine network of different widths, each
    its own (the reference's separate hidden sizes; neither is a kernel
    width, so on a card each runs zero-padded to its own)."""
    pipe = _cotrain(coarse=24, fine=40)
    assert (pipe.coarse.hidden_size, pipe.fine.hidden_size) == (24, 40)


def test_validation_renderer_matches_jax_renderer():
    """A 9x10 image in chunks of 40 rays (a ragged last chunk): the maps,
    the μ/σ maps and the chunk-weighted dp_loss."""
    cfg = _cfg()
    jpipe = JaxPipeline(cfg)
    params = jpipe.init_params(jax.random.PRNGKey(0))
    pipe = NerfPipeline(cfg, "cpu")
    pipe.load_state_dicts(params_to_state_dict(params["coarse"]),
                          params_to_state_dict(params["fine"]))
    pose, h, w, focal = pose_spherical(20.0, -30.0, 4.0), 9, 10, 11.0
    want = JaxRenderer(cfg, jpipe, extract_keys=VALIDATION_KEYS,
                       mode="validation").render_image_from_pose(
        params, pose, h, w, focal, sched=jax_schedule_values(cfg, 30))
    got = ImageRenderer(cfg, pipe, mode="validation").render_image_from_pose(
        pose, h, w, focal, sched=schedule_values(cfg, 30))
    tol = 2e-3  # as tests/test_torch_port_pipeline.py (resampled fenceposts)
    for i in (0, 1):
        for key in VALIDATION_KEYS:
            if key not in want[i]:
                assert key not in got[i], (i, key)
                continue
            np.testing.assert_allclose(np.asarray(got[i][key]),
                                       np.asarray(want[i][key]), rtol=tol,
                                       atol=tol, err_msg=f"cycle {i} {key}")
    assert isinstance(got[1]["dp_loss"], float)
    assert got[0]["weights"].shape == (h, w, 6)
