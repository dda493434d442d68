"""Port parity for the whole render slice: NerfPipeline.render_rays
(mode="render") and the pose-to-image renderer of ddnerf_tpu_torch against
the JAX package, with transplanted weights, no density noise and no
stratified jitter.  The JAX side runs its fused Pallas kernel in interpret
mode (``parallel.use_pallas_mlp: true``), as tests/test_pipeline_pallas.py
does."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddnerf_tpu.config import Config
from ddnerf_tpu.data.synthetic import pose_spherical
from ddnerf_tpu.models.nerf import NerfPipeline as JaxPipeline
from ddnerf_tpu.models.nerf import RayBatch as JaxRays
from ddnerf_tpu.models.nerf import ScheduleValues as JaxSched
from ddnerf_tpu.render.renderer import ImageRenderer as JaxRenderer
from ddnerf_tpu_torch.models.nerf import NerfPipeline, RayBatch, ScheduleValues
from ddnerf_tpu_torch.render.renderer import ImageRenderer
from ddnerf_tpu_torch.utils.weights import params_to_state_dict

# float32 end to end; as tests/test_pipeline_pallas.py (the fused kernel
# vs the XLA path): resampled fenceposts move with the coarse weights'
# summation order, and the fine cycle sees that.
TOL = 2e-3


def _cfg(**parallel):
    return Config.from_dict({
        "nerf": {
            "type": "DDNerfModel", "coarse_hidden_size": 32,
            "fine_hidden_size": 32,
            "validation": {"num_coarse": 6, "num_fine": 6, "perturb": False,
                           "radiance_field_noise_std": 0.0, "chunksize": 50},
        },
        "dataset": {"type": "blender", "near": 2.0, "far": 6.0},
        "parallel": {"compute_dtype": "float32", "num_devices": 1,
                     **parallel},
    }).resolved()


def _pipelines(**parallel):
    cfg = _cfg(use_pallas_mlp=True, **parallel)
    jpipe = JaxPipeline(cfg)
    params = jpipe.init_params(jax.random.PRNGKey(0))
    pipe = NerfPipeline(cfg, "cpu")
    pipe.load_state_dicts(params_to_state_dict(params["coarse"]),
                          params_to_state_dict(params["fine"]))
    return cfg, jpipe, params, pipe


def _rays(n=16, seed=0):
    rng = np.random.default_rng(seed)
    ro = rng.standard_normal((n, 3)).astype(np.float32)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True) * 0.8  # non-unit norms
    radii = np.abs(rng.standard_normal((n, 1))).astype(np.float32) * 0.01
    return ro, rd, radii


KEYS = {0: ("rgb", "disp", "acc", "weights", "depth", "corrected_disp_map",
            "t_vals"),
        1: ("rgb", "disp", "acc", "weights", "depth", "t_vals")}


def test_render_rays_matches_jax_pallas_interpret():
    cfg, jpipe, params, pipe = _pipelines()
    ro, rd, radii = _rays()
    want = jpipe.render_rays(
        params, JaxRays.create(*map(jnp.asarray, (ro, rd, radii)), 2.0, 6.0),
        jax.random.PRNGKey(1), JaxSched.for_eval(cfg), "render")
    got = pipe.render_rays(
        RayBatch.create(*map(torch.tensor, (ro, rd, radii)), 2.0, 6.0),
        ScheduleValues.for_eval(cfg), "render")
    for i, keys in KEYS.items():
        for key in keys:
            np.testing.assert_allclose(
                got[i][key].numpy(), np.asarray(want[i][key]), rtol=TOL,
                atol=TOL, err_msg=f"cycle {i} {key}")


def test_policies_off_and_auto_agree_on_cpu():
    """On the CPU the kernel wrapper runs the plain version, so the
    kernel policies and ``off`` compute the same thing."""
    ro, rd, radii = _rays(8)
    outs = []
    for policy in ("auto", "off"):
        pipe = NerfPipeline(_cfg(pallas_mlp=policy), "cpu")
        assert pipe.use_kernel == (policy == "auto")
        outs.append(pipe.render_rays(
            RayBatch.create(*map(torch.tensor, (ro, rd, radii)), 2.0, 6.0),
            ScheduleValues.for_eval(pipe.cfg)))
    for i in (0, 1):
        assert torch.equal(outs[0][i]["rgb"], outs[1][i]["rgb"])


def test_pipeline_rejects_what_it_cannot_render():
    with pytest.raises(ValueError, match="pallas_mlp"):
        NerfPipeline(_cfg(pallas_mlp="sometimes"), "cpu")
    pipe = NerfPipeline(_cfg(), "cpu")
    ro, rd, radii = _rays(4)
    rays = RayBatch.create(*map(torch.tensor, (ro, rd, radii)), 2.0, 6.0)
    # mip-NeRF is no longer refused: the config renders, through one
    # shared network, and takes no second network's weights.
    mip = NerfPipeline(_cfg().replace_at("nerf.type", "GeneralMipNerfModel"))
    assert mip.shared_net and mip.fine is None
    out = mip.render_rays(rays, ScheduleValues.for_eval(mip.cfg))
    assert out[1]["rgb"].shape == (4, 3) and "mus" not in out[0]
    with pytest.raises(ValueError, match="model_2_state_dict"):
        mip.load_state_dicts(pipe.coarse.state_dict(), pipe.fine.state_dict())
    with pytest.raises(ValueError, match="model_1_state_dict only"):
        pipe.load_state_dicts(pipe.coarse.state_dict())
    with pytest.raises(ValueError, match="mode="):
        pipe.render_rays(rays, ScheduleValues.for_eval(pipe.cfg), "predict")
    perturbed = NerfPipeline(_cfg().replace_at(
        "nerf.validation", _cfg().nerf.validation.__class__(perturb=True)))
    with pytest.raises(ValueError, match="Generator"):
        perturbed.render_rays(rays, ScheduleValues.for_eval(perturbed.cfg))


def test_image_from_pose_matches_jax_renderer():
    """Device ray generation + chunking (a ragged last chunk: 10x9 = 90
    rays in chunks of 50) against the JAX pose renderer."""
    cfg, jpipe, params, pipe = _pipelines()
    pose = pose_spherical(25.0, -30.0, 4.0)
    h, w, focal = 10, 9, 12.0
    want = JaxRenderer(cfg, jpipe, mode="render").render_image_from_pose(
        params, pose, h, w, focal)
    got = ImageRenderer(cfg, pipe).render_image_from_pose(pose, h, w, focal)
    for i in (0, 1):
        for key in ("rgb", "disp", "acc", "depth"):
            assert got[i][key].dtype == np.float32
            assert got[i][key].shape == np.asarray(want[i][key]).shape
            np.testing.assert_allclose(got[i][key], np.asarray(want[i][key]),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"cycle {i} {key}")
    np.testing.assert_allclose(got[0]["corrected_disp_map"],
                               np.asarray(want[0]["corrected_disp_map"]),
                               rtol=TOL, atol=TOL)
