"""The NDC path of the port: the device NDC projection against the numpy
form, and both families' LLFF configs (``configs/ff_dd.yml``,
``configs/ff_mipnerf.yml``: mip-NeRF under NDC), narrowed, on the
synthetic LLFF scene written to disk: the train loop's validation (maps,
the un-warped depth, for DDNeRF the depth-analysis curves), a video frame
and six co-trained steps against the JAX package's, with weights carried
across."""

import os
import types

import numpy as np
import pytest
import torch

import jax

from ddnerf_tpu.config import load_config
from ddnerf_tpu.core import rays as jax_rays
from ddnerf_tpu.data.assembly import get_datasets as jax_get_datasets
from ddnerf_tpu.models.nerf import NerfPipeline as JaxPipeline
import jax.numpy as jnp

from ddnerf_tpu.models.nerf import RayBatch as JaxRays
from ddnerf_tpu.render.renderer import ImageRenderer as JaxRenderer
from ddnerf_tpu.train import loop as jax_loop
from ddnerf_tpu.train.state import create_train_state
from ddnerf_tpu.train.step import compute_loss as jax_compute_loss
from ddnerf_tpu.train.step import make_train_step
from ddnerf_tpu.train.step import schedule_values as jax_schedule_values
from ddnerf_tpu_torch.core import rays as port_rays
from ddnerf_tpu_torch.data.assembly import get_datasets
from ddnerf_tpu_torch.data.datasets import PrefetchedHostBatches
from ddnerf_tpu_torch.data.synthetic import pose_spherical, write_synthetic_llff
from ddnerf_tpu_torch.models.nerf import NerfPipeline, RayBatch
from ddnerf_tpu_torch.render.renderer import VALIDATION_KEYS, ImageRenderer
from ddnerf_tpu_torch.train import loop as port_loop
from ddnerf_tpu_torch.train.state import TrainState
from ddnerf_tpu_torch.train.step import EagerTrainStep, compute_loss, schedule_values
from ddnerf_tpu_torch.utils.weights import (
    params_to_state_dict,
    pipeline_state_from_params,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"dd": "ff_dd.yml", "mipnerf": "ff_mipnerf.yml"}
TOL = 2e-3  # the f32 slice, as tests/test_torch_port_pipeline.py
# The six co-trained steps, under tests/test_torch_port_real360.py's
# tolerances: f32 on both sides, summation order only; the dp loss takes
# logs of small masses; an Adam step moves a weight by about lr in the sign
# of m / sqrt(v); the first step's gradients as tests/test_torch_port_train.py.
STEPS, RAYS = 6, 64
LOSS_RTOL, DP_LOSS_RTOL = 1e-4, 1e-3
WEIGHT_NORM_REL_TOL = 1e-3
GRAD_RTOL = 5e-3


@pytest.mark.parametrize("h,w", [(9, 11), (16, 16)])
def test_device_ndc_rays_match_the_numpy_form(h, w):
    """f32 on both sides; the projection divides by the rays' z, and the
    radii come from neighbour differences over the whole grid: 1e-6."""
    rng = np.random.default_rng(5)
    pose = pose_spherical(*rng.uniform(-20, 20, 2), 4.0)
    pose[:3, 3] += rng.uniform(-0.3, 0.3, 3).astype(np.float32)
    focal = 13.5
    ro, rd, _ = port_rays.get_ray_bundle_np(h, w, focal, pose)
    want = jax_rays.ndc_mipnerf_rays(h, w, focal, ro, rd)
    got = port_rays.ndc_mipnerf_rays_device(h, w, focal, torch.tensor(ro),
                                            torch.tensor(rd))
    for g, wnt, name in zip(got, want, ("origins", "directions", "radii")):
        assert g.dtype == torch.float32 and tuple(g.shape) == wnt.shape
        np.testing.assert_allclose(g.numpy(), wnt, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    # Projected per chunk, the radii at a chunk's edge would differ: the
    # whole-grid radii are not those of the image's upper half alone.
    half = port_rays.ndc_mipnerf_rays_device(
        h, w, focal, torch.tensor(ro[:h // 2]), torch.tensor(rd[:h // 2]))
    assert not torch.equal(half[2][-1], got[2][h // 2 - 1])


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def ff_run(request, tmp_path_factory):
    """``configs/ff_dd.yml`` or ``configs/ff_mipnerf.yml`` narrowed (width
    32, 6 + 6 samples at validation, 8 + 8 deterministic samples of 64 rays
    in training, the rate from the first step, f32, no noise) on a 24 x 24
    synthetic LLFF scene written by the port's helper, for DDNeRF with a
    keypoint file for the depth analysis; both packages' datasets and
    pipelines with the same weights."""
    family = request.param
    root = tmp_path_factory.mktemp("ff")
    scene = str(root / "scene")
    write_synthetic_llff(scene, size=48, n=9, seed=3)
    opts = [
        "dataset.basedir", scene, "dataset.downsample_factor", "2",
        "nerf.coarse_hidden_size", "32", "nerf.fine_hidden_size", "32",
        "nerf.validation.num_coarse", "6", "nerf.validation.num_fine", "6",
        "nerf.validation.radiance_field_noise_std", "0.0",
        "nerf.validation.chunksize", "250",
        "nerf.train.num_coarse", "8", "nerf.train.num_fine", "8",
        "nerf.train.num_random_rays", str(RAYS),
        "nerf.train.perturb", "false",
        "nerf.train.radiance_field_noise_std", "0.0",
        "optimizer.lr_delay_steps", "0",
        "parallel.compute_dtype", "float32", "parallel.pallas_mlp", "off",
        "parallel.fetch_dtype", "float32"]
    if family == "dd":
        keypoints = root / "keypoints.yml"
        keypoints.write_text("img_idx: 0\nresized_by: 2\npixels_and_depth:\n"
                             "  0: [5, 6, 3.2]\n  1: [12, 12, 4.0]\n"
                             "  2: [20, 9, 3.6]\n")
        opts += ["train_params.depth_analysis_path", str(keypoints)]
    cfg = load_config(os.path.join(REPO, "configs", CONFIGS[family]))
    cfg = cfg.merge_from_list(opts).resolved()
    assert cfg.dataset.ndc_rays
    assert cfg.train_params.depth_analysis_rays == (family == "dd")
    assert cfg.is_ddnerf() == (family == "dd")
    jtrain, jval, jcfg = jax_get_datasets(cfg)
    train, val, pcfg = get_datasets(cfg)
    assert (val.H, val.W) == (24, 24) and len(val) == len(jval) == 2
    assert (pcfg.dataset.near, pcfg.dataset.far) == (0.0, 1.0)
    jpipe = JaxPipeline(jcfg)
    params = jpipe.init_params(jax.random.PRNGKey(0))
    pipe = NerfPipeline(pcfg, "cpu")
    pipe.load_state_dicts(**pipeline_state_from_params(params))
    return types.SimpleNamespace(family=family, cfg=pcfg, jcfg=jcfg, val=val,
                                 jval=jval, train=train, jtrain=jtrain,
                                 pipe=pipe, jpipe=jpipe, params=params)


class _Recorder:
    """Stands in for the Documenter: keeps what a validation hands it."""

    def write_valid_iter(self, idx, metrics, output, target, is_ddnerf):
        self.metrics, self.output = metrics, output

    def write_depth_analysis_rays(self, idx, output, da_depth, near, far):
        self.rays, self.da_depth = output, da_depth


@pytest.mark.parametrize("fixed", [False, True])
def test_validation_under_ndc_matches_jax_loop(ff_run, fixed, capsys):
    """One validation of the train loop on each side: rgb, disparity and,
    for DDNeRF, the μ/σ maps, the depth un-warped to metric depth (through
    the next image's rays, or with ``fix_validation_unwarp_rays`` the
    served image's), for DDNeRF the dp loss and the depth-analysis curves
    of the keypoint rays."""
    r = ff_run
    dd = r.family == "dd"
    cfg = r.cfg.replace_at("dataset.fix_validation_unwarp_rays", fixed)
    jcfg = r.jcfg.replace_at("dataset.fix_validation_unwarp_rays", fixed)
    for ds in (r.val, r.jval):
        ds.current_idx = 0
    want = _Recorder()
    state = types.SimpleNamespace(params=r.params, step=30)
    jax_loop._make_validation_cb(
        jcfg, want, JaxRenderer(jcfg, r.jpipe, mode="validation",
                                extract_keys=VALIDATION_KEYS),
        r.jval, True, dd, r.jpipe)(7, state)
    got = _Recorder()
    port_loop._validate(
        cfg, 7, types.SimpleNamespace(step=30),
        ImageRenderer(cfg, r.pipe, mode="validation"), r.val, got,
        r.val.load_depth_analysis_rays(cfg) if dd else None)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[VAL]")]
    # The JAX package's line, then the port's: the same format, and for
    # DDNeRF the port appends the dp loss.
    assert len(lines) == 2 and lines[1].split()[:6] == lines[0].split()[:6]
    assert (lines[1].split()[-2] == "dp_loss") == dd
    for i in (0, 1):
        for key in ("rgb", "disp", "depth") + (("mus", "sigmas")
                                                if i == 0 and dd else ()):
            np.testing.assert_allclose(got.output[i][key], want.output[i][key],
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"cycle {i} {key}")
    assert set(got.metrics) == set(want.metrics)
    assert ("dp_loss" in got.metrics) == dd
    for key in want.metrics:
        np.testing.assert_allclose(got.metrics[key], want.metrics[key],
                                   rtol=TOL, atol=TOL, err_msg=key)
    if dd:
        assert got.da_depth == pytest.approx(want.da_depth)
        for i in (0, 1):
            assert set(got.rays[i]) == set(want.rays[i])
            for key in ("t_vals", "weights", "uniform_incell_pdf"):
                np.testing.assert_allclose(got.rays[i][key],
                                           want.rays[i][key], rtol=TOL,
                                           atol=TOL, err_msg=key)
    else:
        assert not hasattr(got, "rays") and not hasattr(want, "rays")
    if fixed:
        return
    # The rays were NDC-projected: world-space rays against near 0, far 1
    # (the fault) give another image.
    world = r.cfg.replace_at("dataset.ndc_rays", False)
    r.val.current_idx = 0
    pose, _ = r.val.get_next_validation_pose()
    wrong = ImageRenderer(world, r.pipe).render_image_from_pose(
        pose, r.val.H, r.val.W, r.val.focal)
    assert np.abs(wrong[1]["rgb"] - want.output[1]["rgb"]).max() > 10 * TOL
    # And the depth map was un-warped: it is not the render's NDC depth.
    ndc = ImageRenderer(r.cfg, r.pipe).render_image_from_pose(
        pose, r.val.H, r.val.W, r.val.focal)
    assert np.abs(ndc[1]["depth"] - got.output[1]["depth"]).max() > 10 * TOL


def test_video_frame_under_ndc_matches_jax(ff_run):
    """uint8 levels, as tests/test_torch_port_video.py: rgb within 1,
    the normalized disparity within 2."""
    r = ff_run
    pose = np.asarray(r.val.render_poses[3])
    h, w, focal = r.val.H, r.val.W, r.val.focal
    want = JaxRenderer(r.jcfg, r.jpipe, mode="render",
                       extract_keys=("rgb", "disp")
                       ).render_video_frame_from_pose(r.params, pose, h, w,
                                                      focal)
    got = ImageRenderer(r.cfg, r.pipe).render_video_frame_from_pose(
        pose, h, w, focal)
    for g, wnt, levels in zip(got, want, (1, 2)):
        wnt = np.asarray(wnt)
        assert g.dtype == np.uint8 and g.shape == wnt.shape
        assert np.abs(g.astype(int) - wnt.astype(int)).max() <= levels
    assert got[0].std() > 0


@pytest.fixture(scope="module")
def ff_trained(ff_run):
    """Six host-sampled steps on each side from the fixture's JAX
    initialization: the port through ``PrefetchedHostBatches`` and the
    eager stepper under ``pallas_mlp: auto`` (the training Function's
    plain versions on the CPU), JAX through its jitted XLA step on its own
    dataset's ``sample_batch`` with ``default_rng(seed)`` (the batches
    tests/test_torch_port_loop.py holds equal).  Both schedules step from
    each package's own counter, which the test holds equal."""
    r = ff_run
    cfg = r.cfg.replace_at("parallel.pallas_mlp", "auto")
    jstate = create_train_state(r.jcfg, r.jpipe, jax.random.PRNGKey(0))
    init = pipeline_state_from_params(jstate.params)
    jstep = jax.jit(make_train_step(r.jcfg, r.jpipe))
    pipe = NerfPipeline(cfg, "cpu")
    pipe.load_state_dicts(**init)
    assert pipe.use_train_kernel
    state = TrainState(cfg, pipe)
    seed = cfg.experiment.randomseed
    batches = PrefetchedHostBatches(r.train, RAYS, seed, "cpu",
                                    steps_expected=STEPS)
    stepper = EagerTrainStep(cfg, pipe, state, batches.take, None,
                             after_dispatch=batches.prefetch)
    rows = stepper.run(STEPS)
    jrng, jrows, first = np.random.default_rng(seed), [], None
    for _ in range(STEPS):
        batch = r.jtrain.sample_batch(jrng, RAYS)
        first = batch if first is None else first
        ro, rd, radii, rgb = batch
        jstate, jm = jstep(jstate, {
            "origins": jnp.asarray(ro), "directions": jnp.asarray(rd),
            "radii": jnp.asarray(radii), "rgb": jnp.asarray(rgb)})
        jrows.append({k: float(v) for k, v in jm.items()})
    return types.SimpleNamespace(
        cfg=cfg, jstate=jstate, state=state, init=init, rows=rows,
        names=stepper.names, jrows=jrows, pipe=pipe, first=first)


def test_first_step_gradients_under_ndc_match_jax(ff_run, ff_trained):
    """The loss and every gradient leaf of the first batch from the shared
    initialization: ``loss_coeficients`` weigh the two cycles (mip-NeRF's
    [1, 0.1]), the pdf padding is on (``max_pdf_pad_iters``), and
    mip-NeRF's one net sums both cycles' gradients."""
    r, t = ff_run, ff_trained
    near, far = r.cfg.dataset.near, r.cfg.dataset.far
    ro, rd, radii, rgb = t.first
    jparams = create_train_state(r.jcfg, r.jpipe,
                                 jax.random.PRNGKey(0)).params
    jsched = jax_schedule_values(r.jcfg, 0)
    assert bool(jsched.pdf_padding)

    def loss_fn(p):
        return jax_compute_loss(
            r.jcfg, r.jpipe, p,
            JaxRays.create(*map(jnp.asarray, (ro, rd, radii)), near, far),
            jnp.asarray(rgb), jax.random.PRNGKey(3), jsched, "train")

    (want_loss, want_m), want_g = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    pipe = NerfPipeline(t.cfg, "cpu")
    pipe.load_state_dicts(**t.init)
    loss, m = compute_loss(
        t.cfg, pipe,
        RayBatch.create(*map(torch.tensor, (ro, rd, radii)), near, far),
        torch.tensor(rgb), schedule_values(t.cfg, 0))
    loss.backward()
    coefs = r.cfg.train_params.loss_coeficients
    np.testing.assert_allclose(
        loss.item(), coefs[0] * m["loss_coarse"].item()
        + coefs[1] * m["loss_fine"].item()
        + (r.cfg.train_params.dp_coeficient * m["dp_loss"].item()
           if r.family == "dd" else 0.0), rtol=1e-6)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    for key in want_m:
        np.testing.assert_allclose(
            m[key].item(), float(want_m[key]), atol=1e-7, err_msg=key,
            rtol=DP_LOSS_RTOL if key == "dp_loss" else LOSS_RTOL)
    nets = [("coarse", pipe.coarse)] + (
        [("fine", pipe.fine)] if r.family == "dd" else [])
    assert set(want_g) == {net for net, _ in nets}
    for net, module in nets:
        want = params_to_state_dict(want_g[net])
        for name, p in module.named_parameters():
            b = want[name].numpy()
            np.testing.assert_allclose(
                p.grad.numpy(), b, rtol=GRAD_RTOL,
                atol=5e-5 * max(1.0, float(np.abs(b).max())),
                err_msg=f"{net} {name}")


def test_six_steps_under_ndc_match_jax(ff_run, ff_trained):
    r, t = ff_run, ff_trained
    assert t.state.step == int(t.jstate.step) == STEPS
    keys = ["loss", "loss_coarse", "loss_fine", "psnr_fine", "lr"]
    if r.family == "dd":
        keys.append("dp_loss")
    assert set(t.names) == set(t.jrows[0])
    for i, jm in enumerate(t.jrows):
        for key in keys:
            np.testing.assert_allclose(
                t.rows[i, t.names.index(key)].item(), jm[key],
                err_msg=f"{i} {key}",
                rtol=DP_LOSS_RTOL if key == "dp_loss" else LOSS_RTOL)
    # Under single_image_mode each step draws from one image, so the step
    # losses are of different images: the first batch's loss fell instead.
    near, far = r.cfg.dataset.near, r.cfg.dataset.far
    ro, rd, radii, rgb = t.first
    after, _ = compute_loss(
        t.cfg, t.pipe,
        RayBatch.create(*map(torch.tensor, (ro, rd, radii)), near, far),
        torch.tensor(rgb), schedule_values(t.cfg, STEPS))
    assert after.item() < t.rows[0, t.names.index("loss")].item()
    nets = [("coarse", t.pipe.coarse)] + (
        [("fine", t.pipe.fine)] if r.family == "dd" else [])
    for net, module in nets:
        want = params_to_state_dict(t.jstate.params[net])
        moved = 0.0
        for name, p in module.named_parameters():
            diff = p.detach() - want[name]
            rel = (diff.norm() / want[name].norm()).item()
            assert rel <= WEIGHT_NORM_REL_TOL, (net, name, rel)
            assert diff.abs().max().item() <= STEPS * t.cfg.optimizer.lr_init
            moved = max(moved, (want[name] - t.init[net][name]).abs().max()
                        .item())
        assert moved > 10 * t.cfg.optimizer.lr_final, net  # they trained
