"""The NDC path of the port: the device NDC projection against the numpy
form, and ``configs/ff_dd.yml`` (narrowed) on the synthetic LLFF scene
written to disk: the train loop's validation (maps, the un-warped depth,
the depth-analysis curves) and a video frame against the JAX package's,
with weights carried across."""

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
from ddnerf_tpu.render.renderer import ImageRenderer as JaxRenderer
from ddnerf_tpu.train import loop as jax_loop
from ddnerf_tpu_torch.core import rays as port_rays
from ddnerf_tpu_torch.data.assembly import get_datasets
from ddnerf_tpu_torch.data.synthetic import pose_spherical, write_synthetic_llff
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.render.renderer import VALIDATION_KEYS, ImageRenderer
from ddnerf_tpu_torch.train import loop as port_loop
from ddnerf_tpu_torch.utils.weights import pipeline_state_from_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-3  # the f32 slice, as tests/test_torch_port_pipeline.py


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


@pytest.fixture(scope="module")
def ff_run(tmp_path_factory):
    """``configs/ff_dd.yml`` narrowed (width 32, 6 + 6 samples, f32, no
    noise) on a 24 x 24 synthetic LLFF scene written by the port's helper,
    with a keypoint file for the depth analysis; both packages' datasets
    and pipelines with the same weights."""
    root = tmp_path_factory.mktemp("ff")
    scene = str(root / "scene")
    write_synthetic_llff(scene, size=48, n=9, seed=3)
    keypoints = root / "keypoints.yml"
    keypoints.write_text("img_idx: 0\nresized_by: 2\npixels_and_depth:\n"
                         "  0: [5, 6, 3.2]\n  1: [12, 12, 4.0]\n"
                         "  2: [20, 9, 3.6]\n")
    cfg = load_config(os.path.join(REPO, "configs", "ff_dd.yml"))
    cfg = cfg.merge_from_list([
        "dataset.basedir", scene, "dataset.downsample_factor", "2",
        "train_params.depth_analysis_path", str(keypoints),
        "nerf.coarse_hidden_size", "32", "nerf.fine_hidden_size", "32",
        "nerf.validation.num_coarse", "6", "nerf.validation.num_fine", "6",
        "nerf.validation.radiance_field_noise_std", "0.0",
        "nerf.validation.chunksize", "250",
        "parallel.compute_dtype", "float32", "parallel.pallas_mlp", "off",
        "parallel.fetch_dtype", "float32"]).resolved()
    assert cfg.dataset.ndc_rays and cfg.train_params.depth_analysis_rays
    _, jval, jcfg = jax_get_datasets(cfg)
    _, val, pcfg = get_datasets(cfg)
    assert (val.H, val.W) == (24, 24) and len(val) == len(jval) == 2
    jpipe = JaxPipeline(jcfg)
    params = jpipe.init_params(jax.random.PRNGKey(0))
    pipe = NerfPipeline(pcfg, "cpu")
    pipe.load_state_dicts(**pipeline_state_from_params(params))
    return types.SimpleNamespace(cfg=pcfg, jcfg=jcfg, val=val, jval=jval,
                                 pipe=pipe, jpipe=jpipe, params=params)


class _Recorder:
    """Stands in for the Documenter: keeps what a validation hands it."""

    def write_valid_iter(self, idx, metrics, output, target, is_ddnerf):
        self.metrics, self.output = metrics, output

    def write_depth_analysis_rays(self, idx, output, da_depth, near, far):
        self.rays, self.da_depth = output, da_depth


@pytest.mark.parametrize("fixed", [False, True])
def test_validation_under_ndc_matches_jax_loop(ff_run, fixed, capsys):
    """One validation of the train loop on each side: rgb, disparity and
    the μ/σ maps, the depth un-warped to metric depth (through the next
    image's rays, or with ``fix_validation_unwarp_rays`` the served
    image's), the dp loss and the depth-analysis curves of the keypoint
    rays."""
    r = ff_run
    cfg = r.cfg.replace_at("dataset.fix_validation_unwarp_rays", fixed)
    jcfg = r.jcfg.replace_at("dataset.fix_validation_unwarp_rays", fixed)
    for ds in (r.val, r.jval):
        ds.current_idx = 0
    want = _Recorder()
    state = types.SimpleNamespace(params=r.params, step=30)
    jax_loop._make_validation_cb(
        jcfg, want, JaxRenderer(jcfg, r.jpipe, mode="validation",
                                extract_keys=VALIDATION_KEYS),
        r.jval, True, True, r.jpipe)(7, state)
    got = _Recorder()
    port_loop._validate(
        cfg, 7, types.SimpleNamespace(step=30),
        ImageRenderer(cfg, r.pipe, mode="validation"), r.val, got,
        r.val.load_depth_analysis_rays(cfg))
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[VAL]")]
    # The JAX package's line, then the port's: the same format, and the
    # port appends the dp loss.
    assert len(lines) == 2 and lines[1].split()[:6] == lines[0].split()[:6]
    assert lines[1].split()[-2] == "dp_loss"
    for i in (0, 1):
        for key in ("rgb", "disp", "depth") + (("mus", "sigmas") if i == 0
                                                else ()):
            np.testing.assert_allclose(got.output[i][key], want.output[i][key],
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"cycle {i} {key}")
    for key in want.metrics:
        np.testing.assert_allclose(got.metrics[key], want.metrics[key],
                                   rtol=TOL, atol=TOL, err_msg=key)
    assert got.da_depth == pytest.approx(want.da_depth)
    for i in (0, 1):
        assert set(got.rays[i]) == set(want.rays[i])
        for key in ("t_vals", "weights", "uniform_incell_pdf"):
            np.testing.assert_allclose(got.rays[i][key], want.rays[i][key],
                                       rtol=TOL, atol=TOL, err_msg=key)
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
