"""Files in and out of the port, without imageio and without matplotlib:
the image reader and writer, the on-disk loaders (blender and LLFF, with
the minify cache) against the JAX package's, the synthetic LLFF scene
writer against the dataset script, the densified depth-analysis pdfs, and
what eval writes (image dumps, point clouds, depth-analysis figures,
results.txt) against the JAX eval."""

import os
import pickle
import shutil
import subprocess
import sys

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddnerf_tpu.config import Config
from ddnerf_tpu.core import dd as jax_dd
from ddnerf_tpu.core.math import truncated_gaussian_tails as jax_tails
from ddnerf_tpu.data.blender import load_blender_data as jax_load_blender
from ddnerf_tpu.data.llff import load_llff_data as jax_load_llff
from ddnerf_tpu.eval.evaluate import eval_model as jax_eval_model
from ddnerf_tpu.train.checkpoint import save_config_snapshot
from ddnerf_tpu.viz import visualization as jax_viz
from ddnerf_tpu_torch.cli import eval as eval_cli
from ddnerf_tpu_torch.core import dd as port_dd
from ddnerf_tpu_torch.data.blender import load_blender_data
from ddnerf_tpu_torch.data.images import read_image, write_image
from ddnerf_tpu_torch.data.llff import load_llff_data
from ddnerf_tpu_torch.data.synthetic import write_synthetic_llff
from ddnerf_tpu_torch.eval.evaluate import eval_model
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.utils.weights import save_checkpoint
from ddnerf_tpu_torch.viz import visualization as port_viz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "make_synthetic_dataset.py")


def _make_dataset(outdir, fmt):
    """The JAX package's dataset script: a 16 x 16 scene of 4 + 1 + 1
    views, written through imageio."""
    proc = subprocess.run(
        [sys.executable, SCRIPT, str(outdir), "--format", fmt, "--size", "16",
         "--train", "4", "--val", "1", "--test", "1", "--seed", "3"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]


# ---------------------------------------------------------------- image files

@pytest.mark.parametrize("shape,ext", [((7, 9), "png"), ((7, 9, 3), "png"),
                                       ((7, 9, 4), "png"), ((8, 8, 3), "jpg")])
def test_read_image_equals_imageio(tmp_path, shape, ext):
    """Grey, RGB and RGBA PNGs and a JPEG written by imageio decode to the
    arrays imageio itself reads back."""
    pixels = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / f"a.{ext}")
    imageio.imwrite(path, pixels)
    got = read_image(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, imageio.imread(path))
    if ext == "png":
        np.testing.assert_array_equal(got, pixels)


@pytest.mark.parametrize("shape", [(7, 9), (7, 9, 3), (7, 9, 4)])
def test_write_image_decodes_everywhere(tmp_path, shape):
    pixels = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "a.png")
    write_image(path, pixels)
    np.testing.assert_array_equal(imageio.imread(path), pixels)
    np.testing.assert_array_equal(read_image(path), pixels)
    with pytest.raises(ValueError, match="PNG"):
        write_image(str(tmp_path / "a.jpg"), pixels)
    with pytest.raises(ValueError, match="uint8"):
        write_image(path, pixels.astype(np.float32))


# ------------------------------------------------------------------- loaders

def test_blender_loader_equals_jax_loader(tmp_path):
    _make_dataset(tmp_path / "scene", "blender")
    for kw in ({}, {"half_res": True}, {"testskip": 2}):
        want = jax_load_blender(str(tmp_path / "scene"), **kw)
        got = load_blender_data(str(tmp_path / "scene"), **kw)
        for a, b in zip(got[:4], want[:4]):  # images, poses, render, hwf
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(got[4], want[4]):
            np.testing.assert_array_equal(a, b)
    assert got[0].shape[1:] == (16, 16, 4)


def _llff_cfg(basedir, factor):
    return Config.from_dict({"dataset": {
        "type": "llff", "basedir": str(basedir), "downsample_factor": factor,
        "bd_factor": 0.75, "spherify": False}}).resolved()


@pytest.mark.parametrize("factor", [1, 2])
def test_llff_loader_and_minify_cache_equal_jax_loader(tmp_path, factor):
    """Each loader on its own copy of the scene (the minify cache is
    written into it): equal arrays, and equal decoded pixels in the
    ``images_{factor}`` cache files."""
    _make_dataset(tmp_path / "jax", "llff")
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    want = jax_load_llff(_llff_cfg(tmp_path / "jax", factor))
    got = load_llff_data(_llff_cfg(tmp_path / "port", factor))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert got[0].shape[1:] == (16 // factor, 16 // factor, 3)
    cache = f"images_{factor}"
    assert os.path.isdir(tmp_path / "port" / cache) == (factor != 1)
    if factor != 1:
        names = sorted(os.listdir(tmp_path / "jax" / cache))
        assert sorted(os.listdir(tmp_path / "port" / cache)) == names
        for name in names:
            np.testing.assert_array_equal(
                read_image(str(tmp_path / "port" / cache / name)),
                imageio.imread(tmp_path / "jax" / cache / name))


def test_synthetic_llff_writer_equals_the_dataset_script(tmp_path):
    _make_dataset(tmp_path / "script", "llff")
    write_synthetic_llff(str(tmp_path / "port"), size=16, n=6, seed=3)
    np.testing.assert_array_equal(
        np.load(tmp_path / "port" / "poses_bounds.npy"),
        np.load(tmp_path / "script" / "poses_bounds.npy"))
    names = sorted(os.listdir(tmp_path / "script" / "images"))
    assert sorted(os.listdir(tmp_path / "port" / "images")) == names
    assert len(names) == 6
    for name in names:
        np.testing.assert_array_equal(
            imageio.imread(tmp_path / "port" / "images" / name),
            imageio.imread(tmp_path / "script" / "images" / name))


# ------------------------------------------------------- validation artifacts

def _maps(seed=0, h=6, w=7):
    rng = np.random.default_rng(seed)
    out = {i: {"rgb": rng.uniform(-0.1, 1.1, (h, w, 3)).astype(np.float32),
               "disp": rng.uniform(0.1, 3, (h, w)).astype(np.float32),
               "depth": rng.uniform(2, 6, (h, w)).astype(np.float32)}
           for i in (0, 1)}
    out[0]["disp"][0, 0] = np.nan
    return out


@pytest.mark.parametrize("ddnerf", [True, False])
def test_save_validation_images_equals_jax(tmp_path, ddnerf):
    """The same file names and equal decoded pixels; mip-NeRF has no
    μ-corrected disparity and so no ``mus.png``."""
    out = _maps()
    if ddnerf:
        out[0]["corrected_disp_map"] = out[0]["disp"] * 0.9
    jax_viz.save_validation_images(out, str(tmp_path / "jax"))
    port_viz.save_validation_images(out, str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert ("mus.png" in names) == ddnerf and len(names) == 6 + ddnerf
    for name in names:
        np.testing.assert_array_equal(
            read_image(str(tmp_path / "port" / name)),
            imageio.imread(tmp_path / "jax" / name), err_msg=name)


# ------------------------------------------------------------ depth analysis

def _sections(n=5, s=8, seed=4):
    rng = np.random.default_rng(seed)
    t_vals = np.sort(rng.uniform(2.0, 6.0, (n, s + 1)), -1).astype(np.float32)
    t_vals[:, 0], t_vals[:, -1] = 2.0, 6.0
    weights = (rng.uniform(0, 1, (n, s)) ** 2).astype(np.float32)
    mus = rng.uniform(0.05, 0.95, (n, s)).astype(np.float32)
    sigmas = rng.uniform(0.05, 0.5, (n, s)).astype(np.float32)
    return t_vals, weights, mus, sigmas


def test_incell_pdfs_match_jax():
    """The three densified pdf arrays on seeded sections, f32: 1e-5."""
    t_vals, weights, mus, sigmas = _sections()
    t = [torch.tensor(a) for a in (t_vals, weights, mus, sigmas)]
    j = [jnp.asarray(a) for a in (t_vals, weights, mus, sigmas)]
    got = port_dd.uniform_incell_pdf(t[0], t[1], 2.0, 6.0)
    want = jax_dd.uniform_incell_pdf(j[0], j[1], 2.0, 6.0)
    assert tuple(got.shape) == (5, 1000)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-3)
    for scale in (1.0, 1.7):  # the plain and the smoothed in-cell Gaussians
        _, inside = jax_tails(j[2], j[3] * scale)
        want = jax_dd.gaussian_incell_pdf(j[0], j[1], j[2], j[3] * scale,
                                          inside, 2.0, 6.0)
        got = port_dd.gaussian_incell_pdf(
            t[0], t[1], t[2], t[3] * scale, torch.tensor(np.asarray(inside)),
            2.0, 6.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        # Cells that straddle a fencepost come out zero and take the mean
        # of their neighbours; what stays zero is a far tail's underflow.
        assert (got > 0).float().mean() > 0.95


def test_density_plot_draws_without_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    t_vals, weights, mus, sigmas = _sections()
    pdf = port_dd.uniform_incell_pdf(torch.tensor(t_vals),
                                     torch.tensor(weights), 2.0, 6.0).numpy()
    out = {0: {"uniform_incell_pdf": pdf, "t_vals": t_vals},
           1: {"uniform_incell_pdf": pdf[::-1], "gaussian_incell_pdf": pdf,
               "t_vals": t_vals}}
    for tb_mode, hw in ((True, (750, 1050)), (False, (900, 1350))):
        img = port_viz.get_density_distribution_plots(
            out, 1, [3.0, 0.0, 3.5, 4.0, 2.5], 2.0, 6.0, i=3, tb_mode=tb_mode)
        assert img.dtype == np.uint8 and img.shape == (3, *hw)
        # White paper with the three curves' colours on it.
        assert img.max() == 255 and len(np.unique(img.reshape(3, -1).T,
                                                  axis=0)) >= 5


# ----------------------------------------------------------------------- eval

@pytest.fixture(scope="module")
def logdirs(tmp_path_factory):
    """Two copies of a tiny DDNeRF run (config snapshot with depth analysis
    on + the port's seeded checkpoint), one per package, so that neither
    sees the other's files."""
    root = tmp_path_factory.mktemp("eval")
    keypoints = root / "keypoints.yml"
    keypoints.write_text("img_idx: 0\nresized_by: 1\npixels_and_depth:\n"
                         "  0: [10, 12, 3.1]\n  1: [40, 40, 4.0]\n")
    cfg = Config.from_dict({
        "train_params": {"depth_analysis_rays": True,
                         "depth_analysis_path": str(keypoints)},
        "nerf": {
            "type": "DDNerfModel", "coarse_hidden_size": 16,
            "fine_hidden_size": 16,
            "train": {"num_coarse": 4, "num_fine": 4},
            "validation": {"num_coarse": 4, "num_fine": 4, "perturb": False,
                           "radiance_field_noise_std": 0.0,
                           "chunksize": 1500},
        },
        "dataset": {"type": "blender", "synthetic": True,
                    "downsample_factor": 1, "single_image_mode": False},
        "parallel": {"num_devices": 1, "compute_dtype": "float32"},
    }).resolved()
    pipe = NerfPipeline(cfg, "cpu", seed=4)
    paths = {}
    for name in ("jax", "port"):
        paths[name] = str(root / name)
        save_config_snapshot(cfg, paths[name])
        save_checkpoint(os.path.join(paths[name], "checkpoint.ckpt"),
                        pipe.coarse, pipe.fine, step=7)
    return paths


def _tree(path):
    return sorted(os.path.relpath(os.path.join(base, n), path)
                  for base, _, names in os.walk(path) for n in names)


def test_eval_artifacts_match_jax_eval(logdirs):
    """One image with ``save_images`` and ``extract_ptc``: the same files;
    the PNG maps within 1 uint8 level (2 for the normalized disparity and
    depth maps), the point cloud and the depth-analysis curves at the f32
    slice tolerance; ``results.txt`` with the same lines."""
    ckpt = os.path.join(logdirs["jax"], "checkpoint.ckpt")
    jax_eval_model(logdirs["jax"], extract_ptc=True, save_images=True,
                   max_images=1, torch_checkpoint=ckpt)
    eval_model(logdirs["port"], extract_ptc=True, save_images=True,
               max_images=1, device="cpu")
    want_dir, got_dir = (os.path.join(logdirs[k], "validation")
                         for k in ("jax", "port"))
    files = _tree(want_dir)
    assert _tree(got_dir) == files
    assert {"0/gt.png", "0/rgb_fine.png", "0/mus.png", "ptc_0.npy",
            "rays/ray_0.png", "rays/ray_1.png", "ray_dict.pkl",
            "results.txt"} <= set(files)
    for name in (f for f in files if f.startswith("0/")):
        got = read_image(os.path.join(got_dir, name)).astype(int)
        want = imageio.imread(os.path.join(want_dir, name)).astype(int)
        levels = 1 if "rgb" in name or name == "0/gt.png" else 2
        assert got.shape == want.shape and np.abs(got - want).max() <= levels
    np.testing.assert_allclose(np.load(os.path.join(got_dir, "ptc_0.npy")),
                               np.load(os.path.join(want_dir, "ptc_0.npy")),
                               rtol=2e-3, atol=2e-3)
    for j in (0, 1):  # a figure of the standalone size, drawn on white
        fig = read_image(os.path.join(got_dir, "rays", f"ray_{j}.png"))
        assert fig.shape == (900, 1350, 3) and fig.std() > 0
    with open(os.path.join(got_dir, "ray_dict.pkl"), "rb") as f:
        got = pickle.load(f)
    with open(os.path.join(want_dir, "ray_dict.pkl"), "rb") as f:
        want = pickle.load(f)
    for i in (0, 1):
        assert set(got[i]) == set(want[i])
        for key in ("uniform_incell_pdf", "t_vals"):
            np.testing.assert_allclose(got[i][key], want[i][key], rtol=2e-3,
                                       atol=2e-3, err_msg=key)
    assert {"gaussian_incell_pdf", "smoothed_gaussian_incell_pdf"} <= set(
        got[1])

    def result_lines(path):
        with open(os.path.join(path, "results.txt")) as f:
            return [ln.split(":")[0] for ln in f if "model_time" not in ln]

    assert result_lines(got_dir) == result_lines(want_dir)


def test_eval_cli_flags(logdirs, tmp_path, capsys):
    """Without ``--save_images`` / ``--extract_ptc`` the CLI writes neither
    (the JAX CLI's defaults); ``--checkpoint`` of an absent step raises;
    ``--lpips-weights`` of an unreadable file warns and leaves LPIPS out."""
    run = str(tmp_path / "run")
    shutil.copytree(logdirs["port"], run, ignore=shutil.ignore_patterns(
        "validation"))
    eval_cli.main(["--logdir", run, "--max-images", "1", "--device", "cpu"])
    assert sorted(os.listdir(os.path.join(run, "validation"))) == [
        "ray_dict.pkl", "rays", "results.txt"]
    with pytest.raises(FileNotFoundError, match=r"step 3 .*available: \[\]"):
        eval_cli.main(["--logdir", run, "--checkpoint", "3", "--device",
                       "cpu"])
    with pytest.warns(UserWarning, match="alex.npz.* unreadable"):
        eval_cli.main(["--logdir", run, "--lpips-weights", "alex.npz",
                       "--max-images", "1", "--device", "cpu"])
    with open(os.path.join(run, "validation", "results.txt")) as f:
        text = f.read()
    assert "psnr_fine" in text and "lpips" not in text
    capsys.readouterr()
