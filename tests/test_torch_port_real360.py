"""The real-360 path of the port against the JAX package's, both families
(``configs/real360_dd.yml``, ``configs/real360_mipnerf.yml``), on a ring
of cameras written to disk by ``write_synthetic_real360`` (10 views of 64²,
minified 4x by the configs' ``downsample_factor``): the datasets after
``normalize_poses`` (poses, focal, near / far / ``combined_split``, the 180
spherical render poses), 6 training steps from the same weights on the
host batches both loops draw, the train loop's validation and a spherical
video frame of the trained weights; and the port's three CLIs on that
scene."""

import json
import os
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ddnerf_tpu.config import load_config as jax_load_config
from ddnerf_tpu.data.assembly import get_datasets as jax_get_datasets
from ddnerf_tpu.models.nerf import NerfPipeline as JaxPipeline
from ddnerf_tpu.render.renderer import ImageRenderer as JaxRenderer
from ddnerf_tpu.train import loop as jax_loop
from ddnerf_tpu.train.state import create_train_state
from ddnerf_tpu.train.step import make_train_step
from ddnerf_tpu_torch.cli import eval as eval_cli
from ddnerf_tpu_torch.cli import render_video as video_cli
from ddnerf_tpu_torch.cli import train as train_cli
from ddnerf_tpu_torch.config import load_config
from ddnerf_tpu_torch.data.assembly import get_datasets
from ddnerf_tpu_torch.data.datasets import PrefetchedHostBatches
from ddnerf_tpu_torch.data.synthetic import write_synthetic_real360
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.render.media import read_avi
from ddnerf_tpu_torch.render.renderer import VALIDATION_KEYS, ImageRenderer
from ddnerf_tpu_torch.train import loop as port_loop
from ddnerf_tpu_torch.train.state import TrainState
from ddnerf_tpu_torch.train.step import EagerTrainStep
from ddnerf_tpu_torch.utils.weights import (
    params_to_state_dict,
    pipeline_state_from_params,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"dd": "real360_dd.yml", "mipnerf": "real360_mipnerf.yml"}
STEPS, RAYS = 6, 64
POSE_TOL = 1e-6  # the same numpy arithmetic on both sides, f32 poses
TOL = 2e-3  # the f32 slice, as tests/test_torch_port_pipeline.py
# As tests/test_torch_port_trajectory.py: f32 on both sides, summation
# order only; the dp loss takes logs of small masses; an Adam step moves a
# weight by about lr in the sign of m / sqrt(v).
LOSS_RTOL, DP_LOSS_RTOL = 1e-4, 1e-3
WEIGHT_NORM_REL_TOL = 1e-3
# Narrow widths, deterministic draws, f32; the rate from the first step
# (the configs' 2500-step delay would keep 6 steps at 1% of it).
NARROW = ["nerf.coarse_hidden_size", "32", "nerf.fine_hidden_size", "32",
          "nerf.train.num_coarse", "8", "nerf.train.num_fine", "8",
          "nerf.train.num_random_rays", str(RAYS),
          "nerf.train.perturb", "false",
          "nerf.train.radiance_field_noise_std", "0.0",
          "nerf.validation.num_coarse", "8", "nerf.validation.num_fine", "8",
          "nerf.validation.radiance_field_noise_std", "0.0",
          "nerf.validation.chunksize", "100",
          "parallel.compute_dtype", "float32", "parallel.fetch_dtype",
          "float32", "optimizer.lr_delay_steps", "0"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("real360")
    path = str(root / "ring")
    write_synthetic_real360(path, size=64, n=10, seed=4)
    return path


def _cfgs(scene, family):
    """The JAX config on its XLA step (``pallas_mlp: off``, as
    tests/test_torch_port_trajectory.py) and the port's under the shipped
    ``auto``, whose training Function runs its plain versions on the CPU."""
    opts = ["dataset.basedir", scene, *NARROW]
    name = os.path.join(REPO, "configs", CONFIGS[family])
    return (jax_load_config(name).merge_from_list(
                opts + ["parallel.pallas_mlp", "off"]).resolved(),
            load_config(name).merge_from_list(opts).resolved())


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def trained(request, scene):
    """Both packages' datasets of the scene, and 6 host-sampled steps on
    each side from one JAX initialization: the port through
    ``PrefetchedHostBatches`` and the eager stepper, JAX through its jitted
    step on its own dataset's ``sample_batch`` with ``default_rng(seed)``
    (the batches ``tests/test_torch_port_loop.py`` holds equal)."""
    family = request.param
    jcfg, cfg = _cfgs(scene, family)
    jtrain, jval, jcfg = jax_get_datasets(jcfg)
    train, val, cfg = get_datasets(cfg)
    jpipe = JaxPipeline(jcfg)
    jstate = create_train_state(jcfg, jpipe, jax.random.PRNGKey(0))
    init = pipeline_state_from_params(jstate.params)
    jstep = jax.jit(make_train_step(jcfg, jpipe))
    pipe = NerfPipeline(cfg, "cpu")
    pipe.load_state_dicts(**init)
    state = TrainState(cfg, pipe)
    seed = cfg.experiment.randomseed
    batches = PrefetchedHostBatches(train, RAYS, seed, "cpu",
                                    steps_expected=STEPS)
    stepper = EagerTrainStep(cfg, pipe, state, batches.take, None,
                             after_dispatch=batches.prefetch)
    rows = stepper.run(STEPS)
    jrng, jrows = np.random.default_rng(seed), []
    for _ in range(STEPS):
        ro, rd, radii, rgb = jtrain.sample_batch(jrng, RAYS)
        jstate, jm = jstep(jstate, {
            "origins": jnp.asarray(ro), "directions": jnp.asarray(rd),
            "radii": jnp.asarray(radii), "rgb": jnp.asarray(rgb)})
        jrows.append({k: float(v) for k, v in jm.items()})
    return types.SimpleNamespace(
        family=family, cfg=cfg, jcfg=jcfg, train=train, jtrain=jtrain,
        val=val, jval=jval, pipe=pipe, jpipe=jpipe, jstate=jstate,
        state=state, init=init, rows=rows, names=stepper.names, jrows=jrows)


def test_datasets_after_pose_normalization_match_jax(trained):
    r = trained
    cfg, jcfg, train, jtrain, val, jval = (r.cfg, r.jcfg, r.train, r.jtrain,
                                           r.val, r.jval)
    assert cfg.dataset.type == "real360" and cfg.dataset.normalize_poses
    assert cfg.dataset.bd_factor is None and not cfg.dataset.ndc_rays
    for key, value in (("near", 0.2), ("far", 2.8), ("combined_split", 0.4)):
        assert getattr(cfg.dataset, key) == pytest.approx(value)
        assert getattr(cfg.dataset, key) == pytest.approx(
            getattr(jcfg.dataset, key), rel=POSE_TOL)
    assert (val.H, val.W) == (jval.H, jval.W) == (16, 16)
    assert val.focal == pytest.approx(jval.focal, rel=POSE_TOL)
    assert len(val) == len(jval) == 2 and len(train.poses) == 8
    for got, want in ((train.poses, jtrain.poses), (val.poses, jval.poses),
                      (val.render_poses, jval.render_poses)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=POSE_TOL, atol=POSE_TOL)
    assert np.asarray(val.render_poses).shape == (180, 3, 4)
    np.testing.assert_array_equal(train.images, jtrain.images)
    # normalize_factor 5: the ring of radius 4 lies inside near / far.
    dist = np.linalg.norm(np.asarray(train.poses)[:, :3, 3], axis=-1)
    assert (dist > cfg.dataset.near).all() and (dist < cfg.dataset.far).all()


def test_six_steps_match_jax(trained):
    r = trained
    assert r.state.step == int(r.jstate.step) == STEPS
    keys = ["loss", "loss_fine", "psnr_fine", "lr"]
    if r.family == "dd":
        keys.append("dp_loss")
    assert set(r.names) == set(r.jrows[0])
    for i, jm in enumerate(r.jrows):
        for key in keys:
            np.testing.assert_allclose(
                r.rows[i, r.names.index(key)].item(), jm[key],
                err_msg=f"{i} {key}",
                rtol=DP_LOSS_RTOL if key == "dp_loss" else LOSS_RTOL)
    assert r.jrows[-1]["loss"] < r.jrows[0]["loss"]
    nets = [("coarse", r.pipe.coarse)] + (
        [("fine", r.pipe.fine)] if r.family == "dd" else [])
    for net, module in nets:
        want = params_to_state_dict(r.jstate.params[net])
        moved = 0.0
        for name, p in module.named_parameters():
            diff = p.detach() - want[name]
            rel = (diff.norm() / want[name].norm()).item()
            assert rel <= WEIGHT_NORM_REL_TOL, (net, name, rel)
            assert diff.abs().max().item() <= STEPS * r.cfg.optimizer.lr_init
            moved = max(moved, (want[name] - r.init[net][name]).abs().max()
                        .item())
        assert moved > 10 * r.cfg.optimizer.lr_final, net  # they trained


class _Recorder:
    """Stands in for the Documenter: keeps what a validation hands it."""

    def write_valid_iter(self, idx, metrics, output, target, is_ddnerf):
        self.metrics, self.output = metrics, output


def _on_jax_weights(r):
    """The port's pipeline holding the JAX run's trained weights."""
    pipe = NerfPipeline(r.cfg, "cpu")
    pipe.load_state_dicts(**pipeline_state_from_params(r.jstate.params))
    return pipe


def test_validation_of_the_trained_weights_matches_jax_loop(trained):
    r = trained
    for ds in (r.val, r.jval):
        ds.current_idx = 1
    want = _Recorder()
    jax_loop._make_validation_cb(
        r.jcfg, want, JaxRenderer(r.jcfg, r.jpipe, mode="validation",
                                  extract_keys=VALIDATION_KEYS),
        r.jval, False, False, r.jpipe)(STEPS - 1, r.jstate)
    got = _Recorder()
    port_loop._validate(
        r.cfg, STEPS - 1, types.SimpleNamespace(step=STEPS),
        ImageRenderer(r.cfg, _on_jax_weights(r), mode="validation"), r.val,
        got, verbose=False)
    for i in (0, 1):
        keys = ("rgb", "disp", "depth") + (
            ("mus", "sigmas") if i == 0 and r.family == "dd" else ())
        for key in keys:
            np.testing.assert_allclose(got.output[i][key], want.output[i][key],
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"cycle {i} {key}")
    assert set(got.metrics) == set(want.metrics)
    for key in want.metrics:
        np.testing.assert_allclose(got.metrics[key], want.metrics[key],
                                   rtol=TOL, atol=TOL, err_msg=key)
    assert got.output[1]["rgb"].std() > 0


def test_spherical_video_frame_matches_jax(trained):
    """A pose of the 180-pose spherical path, uint8 levels as
    tests/test_torch_port_video.py: rgb within 1, disparity within 2."""
    r = trained
    pose = np.asarray(r.val.render_poses[45])
    h, w, focal = r.val.H, r.val.W, r.val.focal
    want = JaxRenderer(r.jcfg, r.jpipe, mode="render",
                       extract_keys=("rgb", "disp")
                       ).render_video_frame_from_pose(r.jstate.params, pose,
                                                      h, w, focal)
    got = ImageRenderer(r.cfg, _on_jax_weights(r)
                        ).render_video_frame_from_pose(pose, h, w, focal)
    for g, wnt, levels in zip(got, want, (1, 2)):
        wnt = np.asarray(wnt)
        assert g.dtype == np.uint8 and g.shape == wnt.shape
        assert np.abs(g.astype(int) - wnt.astype(int)).max() <= levels
    assert got[0].std() > 0


def test_port_clis_train_evaluate_and_film_real360(scene, tmp_path, capsys):
    """The user's flow through the three CLIs on the CPU for DDNeRF (the
    mip-NeRF family's training, validation and frame are held against JAX
    above): the config's normalized near / far in the snapshot,
    results.txt, and frames of the spherical path."""
    config = os.path.join(REPO, "configs", CONFIGS["dd"])
    train_cli.main(["--config", config, "--max-iters", "4", "--device", "cpu",
                    "dataset.basedir", scene, "experiment.logdir",
                    str(tmp_path), "experiment.id", "run",
                    "experiment.validate_every", "3",
                    "experiment.save_every", "3", *NARROW])
    logdir = os.path.join(str(tmp_path), "run")
    out = capsys.readouterr().out
    assert "[VAL] iter 3 " in out and "step mode: eager" in out
    snapshot = load_config(os.path.join(logdir, "config.yml"))
    assert snapshot.dataset.near == pytest.approx(0.2)
    assert snapshot.dataset.far == pytest.approx(2.8)
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        losses = [r["loss"] for r in map(json.loads, f)
                  if r["kind"] == "train"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    eval_cli.main(["--logdir", logdir, "--max-images", "1", "--device",
                   "cpu"])
    with open(os.path.join(logdir, "validation", "results.txt")) as f:
        text = f.read()
    assert "psnr_fine:" in text and "nan" not in text
    video_cli.main(["--logdir", logdir, "--max-frames", "2", "--device",
                    "cpu"])
    frames, _ = read_avi(os.path.join(logdir, "video", "video.avi"))
    assert frames.shape == (2, 16, 32, 3) and frames.std() > 0
    assert not np.array_equal(frames[0], frames[1])  # the camera moved
