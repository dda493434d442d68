"""Quality against the JAX package: both packages co-trained from the same
weights on the same batches of a written blender scene's rays for 300
steps, then evaluated on the scene's validation views.  The fine PSNRs
must agree to 0.5 dB, and each must have risen at least 3 dB above the
untrained nets' PSNR, so that two untrained nets are never what agrees.
Both families: DDNeRF (``configs/blender_dd.yml``) and mip-NeRF
(``configs/blender_mipnerf.yml``), narrowed.  JAX trains through its XLA
step (``pallas_mlp: off``, as tests/test_torch_port_trajectory.py), the
port under ``pallas_mlp: auto``, whose training Function runs its plain
versions on the CPU."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddnerf_tpu.config import load_config as jax_load_config
from ddnerf_tpu.data.assembly import get_datasets as jax_get_datasets
from ddnerf_tpu.models.nerf import NerfPipeline as JaxPipeline
from ddnerf_tpu.render.renderer import ImageRenderer as JaxRenderer
from ddnerf_tpu.train.state import create_train_state
from ddnerf_tpu.train.step import make_train_step
from ddnerf_tpu.train.step import schedule_values as jax_schedule_values
from ddnerf_tpu_torch.config import load_config
from ddnerf_tpu_torch.data.assembly import get_datasets
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.render.renderer import ImageRenderer
from ddnerf_tpu_torch.train.state import TrainState
from ddnerf_tpu_torch.train.step import schedule_values, train_step
from ddnerf_tpu_torch.utils.weights import pipeline_state_from_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"dd": "blender_dd.yml", "mipnerf": "blender_mipnerf.yml"}
STEPS, RAYS = 300, 256
PSNR_GAP_DB = 0.5  # ROADMAP A8
MIN_RISE_DB = 3.0
# 32 x 32, 8 training views, 2 validation views; 8 + 8 samples, f32, no
# noise, no jitter; the rate from the first step and annealed over the
# run, the schedules of the 3k-iteration rehearsal scaled to 300 steps.
NARROW = ["dataset.synthetic", "false", "dataset.single_image_mode", "false",
          "nerf.coarse_hidden_size", "32", "nerf.fine_hidden_size", "32",
          "nerf.train.num_coarse", "8", "nerf.train.num_fine", "8",
          "nerf.train.num_random_rays", str(RAYS),
          "nerf.train.perturb", "false",
          "nerf.train.radiance_field_noise_std", "0.0",
          "nerf.validation.num_coarse", "8", "nerf.validation.num_fine", "8",
          "nerf.validation.radiance_field_noise_std", "0.0",
          "nerf.validation.chunksize", "1024",
          "parallel.compute_dtype", "float32", "parallel.fetch_dtype",
          "float32", "experiment.train_iters", str(STEPS),
          "optimizer.lr_delay_steps", "0", "optimizer.lr_init", "5e-3",
          "optimizer.lr_final", "5e-4",
          "train_params.max_pdf_pad_iters", str(STEPS // 4),
          "train_params.finnish_smooth", str(STEPS // 4)]


@pytest.fixture(autouse=True)
def _two_threads():
    """Thousands of tiny steps: more threads than two only spin, and take
    the cores of the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("quality") / "blender")
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_dataset_torch",
        os.path.join(REPO, "scripts", "make_synthetic_dataset_torch.py"))
    writer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(writer)
    writer.main([path, "--size", "32", "--train", "8", "--val", "2",
                 "--test", "1", "--seed", "1"])
    return path


def _psnr(images, gts):
    mse = np.mean([np.mean((im - gt) ** 2) for im, gt in zip(images, gts)])
    return -10.0 * np.log10(mse)


def _jax_psnr(cfg, pipe, params, val, step):
    renderer = JaxRenderer(cfg, pipe, mode="validation")
    sched = jax_schedule_values(cfg, step)
    images = [np.asarray(renderer.render_image_from_pose(
        params, pose, val.H, val.W, val.focal, sched=sched)[1]["rgb"])
        for pose in val.poses]
    return _psnr(images, val.images)


def _port_psnr(cfg, pipe, val, step):
    renderer = ImageRenderer(cfg, pipe, mode="validation")
    sched = schedule_values(cfg, step)
    images = [renderer.render_image_from_pose(
        pose, val.H, val.W, val.focal, sched=sched)[1]["rgb"]
        for pose in val.poses]
    return _psnr(images, val.images)


def cotrain(config, opts, steps=STEPS, rays=RAYS, seed=11):
    """``configs/{config}`` under ``opts`` in both packages (JAX on its XLA
    step, the port under ``pallas_mlp: auto``), one JAX initialization
    carried across, ``steps`` steps on the same host batches of ``rays``
    rays drawn by ``default_rng(seed)`` -> (the untrained nets' fine PSNR
    on the validation views, the port's after training, the JAX package's,
    the port's validation dataset)."""
    name = os.path.join(REPO, "configs", config)
    jcfg = jax_load_config(name).merge_from_list(
        opts + ["parallel.pallas_mlp", "off"]).resolved()
    cfg = load_config(name).merge_from_list(
        opts + ["parallel.pallas_mlp", "auto"]).resolved()
    jtrain, jval, jcfg = jax_get_datasets(jcfg)
    train, val, cfg = get_datasets(cfg)
    np.testing.assert_array_equal(train.images, jtrain.images)
    np.testing.assert_array_equal(val.images, jval.images)

    jpipe = JaxPipeline(jcfg)
    jstate = create_train_state(jcfg, jpipe, jax.random.PRNGKey(0))
    pipe = NerfPipeline(cfg, "cpu")
    pipe.load_state_dicts(**pipeline_state_from_params(jstate.params))
    state = TrainState(cfg, pipe)
    untrained = _port_psnr(cfg, pipe, val, 0)
    assert untrained == pytest.approx(
        _jax_psnr(jcfg, jpipe, jstate.params, jval, 0), abs=1e-3)

    jstep = jax.jit(make_train_step(jcfg, jpipe))
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        ro, rd, radii, rgb = train.sample_batch(rng, rays)
        jstate, _ = jstep(jstate, {
            "origins": jnp.asarray(ro), "directions": jnp.asarray(rd),
            "radii": jnp.asarray(radii), "rgb": jnp.asarray(rgb)})
        train_step(cfg, pipe, state, {
            "origins": torch.from_numpy(ro), "directions": torch.from_numpy(rd),
            "radii": torch.from_numpy(radii), "rgb": torch.from_numpy(rgb)})
    assert state.step == int(jstate.step) == steps
    return (untrained, _port_psnr(cfg, pipe, val, steps),
            _jax_psnr(jcfg, jpipe, jstate.params, jval, steps), val)


def assert_quality(what, untrained, got, want, steps=STEPS):
    """The gates: each package at least MIN_RISE_DB above the untrained
    nets, and the two within PSNR_GAP_DB."""
    print(f"{what}: psnr_fine untrained {untrained:.3f}, after {steps} "
          f"steps port {got:.3f}, JAX {want:.3f}")
    assert got >= untrained + MIN_RISE_DB and want >= untrained + MIN_RISE_DB
    assert abs(got - want) <= PSNR_GAP_DB


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_cotrained_psnr_matches_jax(scene, family):
    untrained, got, want, val = cotrain(
        CONFIGS[family], ["dataset.basedir", scene, *NARROW])
    assert (val.H, val.W) == (32, 32) and len(val.poses) == 2
    assert_quality(family, untrained, got, want)
