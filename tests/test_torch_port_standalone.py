"""The port's own copies of the framework-free modules (config, data
loaders and ray datasets, PSNR/SSIM, results writer, documenter) against
their originals in the JAX package, on the CPU at small sizes with numpy
inputs from a seed; and a source scan: no file of the port imports
``ddnerf_tpu``."""

import glob
import json
import os
import re

import numpy as np
import pytest

import ddnerf_tpu_torch
from ddnerf_tpu import config as jax_config
from ddnerf_tpu.core import rays as jax_rays
from ddnerf_tpu.data import poses as jax_poses
from ddnerf_tpu.data import synthetic as jax_synthetic
from ddnerf_tpu.data.assembly import get_datasets as jax_get_datasets
from ddnerf_tpu.eval import metrics as jax_metrics
from ddnerf_tpu.viz import visualization as jax_viz
from ddnerf_tpu.viz.documentation import Documenter as JaxDocumenter
from ddnerf_tpu_torch import config as port_config
from ddnerf_tpu_torch.core import rays as port_rays
from ddnerf_tpu_torch.data import poses as port_poses
from ddnerf_tpu_torch.data import synthetic as port_synthetic
from ddnerf_tpu_torch.data.assembly import get_datasets as port_get_datasets
from ddnerf_tpu_torch.eval import metrics as port_metrics
from ddnerf_tpu_torch.viz import visualization as port_viz
from ddnerf_tpu_torch.viz.documentation import Documenter as PortDocumenter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p)
                 for p in glob.glob(os.path.join(REPO, "configs", "*.yml")))


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("name", CONFIGS)
def test_config_file_loads_to_equal_dicts(name):
    """Every shipped config means the same to both packages, raw and
    resolved, and survives the port's dump / reload."""
    path = os.path.join(REPO, "configs", name)
    want, got = jax_config.Config.from_yaml(path), port_config.Config.from_yaml(path)
    assert got.to_dict() == want.to_dict()
    assert got.resolved().to_dict() == want.resolved().to_dict()
    assert port_config.load_config(path).to_dict() == \
        jax_config.load_config(path).to_dict()
    assert got.dump() == want.dump()
    assert port_config.Config.from_dict(got.to_dict()).to_dict() == got.to_dict()


def test_config_defaults_and_tpu_only_switches():
    """Same fields and defaults; the TPU-only switches are accepted."""
    assert port_config.Config().to_dict() == jax_config.Config().to_dict()
    d = {"parallel": {"bwd_block_rows": 512, "scoped_vmem_limit_kib": 1,
                      "alpha_vpu": True, "pallas_mlp": False,
                      "fetch_dtype": "bfloat16", "num_devices": 4}}
    got = port_config.Config.from_dict(d)
    assert got.to_dict() == jax_config.Config.from_dict(d).to_dict()
    assert got.parallel.pallas_mlp == "off" and got.parallel.alpha_vpu


OVERRIDES = [
    ["parallel.pallas_mlp", "off"],
    ["nerf.train.num_coarse", "8", "experiment.id", "123"],
    ["optimizer.lr_init", "1e-3", "dataset.near", "1"],
    ["train_params.loss_coeficients", "[0.5, 2.0]",
     "train_params.set_automatic_dist_reg_coeficient", "false"],
    ["dataset.bd_factor", "0.75", "dataset.synthetic", "true"],
]


@pytest.mark.parametrize("opts", OVERRIDES, ids=lambda o: o[0])
def test_config_dotted_overrides_agree(opts):
    want = jax_config.Config().merge_from_list(opts).resolved()
    got = port_config.Config().merge_from_list(opts).resolved()
    assert got.to_dict() == want.to_dict()
    key = opts[0]
    assert got.replace_at(key, getattr_path(got, key)).to_dict() == got.to_dict()


def getattr_path(cfg, path):
    for part in path.split("."):
        cfg = getattr(cfg, part)
    return cfg


@pytest.mark.parametrize("opts", [["parallel.pallas_mlp"],
                                  ["dataset.synthetic", "maybe"],
                                  ["nerf.train.num_coarse", "x"],
                                  ["nerf.no_such_key", "1"]],
                         ids=["odd", "bool", "int", "typo"])
def test_config_bad_overrides_raise_in_both(opts):
    for mod in (jax_config, port_config):
        with pytest.raises((ValueError, AttributeError, TypeError)):
            mod.Config().merge_from_list(opts)


# -------------------------------------------------------------------- data

def _synthetic_cfg(mod, **dataset):
    return mod.Config.from_dict({
        "dataset": {"type": "blender", "synthetic": True, **dataset},
        "nerf": {"train": {"white_background": False}},
    }).resolved()


@pytest.mark.parametrize("single_image_mode", [True, False])
def test_get_datasets_synthetic_equal(single_image_mode):
    """The synthetic scene through both packages: exact equality of the
    images, poses, precomputed rays, render poses and the returned config."""
    want_t, want_v, want_c = jax_get_datasets(
        _synthetic_cfg(jax_config, single_image_mode=single_image_mode))
    got_t, got_v, got_c = port_get_datasets(
        _synthetic_cfg(port_config, single_image_mode=single_image_mode))
    assert got_c.to_dict() == want_c.to_dict()
    for name in ("images", "poses", "origins", "directions", "radii",
                 "target"):
        np.testing.assert_array_equal(getattr(got_t, name),
                                      getattr(want_t, name), err_msg=name)
    np.testing.assert_array_equal(got_t.device_store(), want_t.device_store())
    assert (got_t.focal, got_t.H, got_t.W) == (want_t.focal, want_t.H, want_t.W)
    np.testing.assert_array_equal(got_v.images, want_v.images)
    np.testing.assert_array_equal(got_v.poses, want_v.poses)
    np.testing.assert_array_equal(np.asarray(got_v.render_poses),
                                  np.asarray(want_v.render_poses))
    for a, b in zip(got_v.get_next_validation_rays(),
                    want_v.get_next_validation_rays()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got_v.get_next_render_pose(),
                    want_v.get_next_render_pose()):
        np.testing.assert_array_equal(a, b)
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    for a, b in zip(got_t.sample_batch(rng_a, 17),
                    want_t.sample_batch(rng_b, 17)):
        np.testing.assert_array_equal(a, b)


def test_port_datasets_take_either_config():
    """Attribute access only: the port's loader accepts the JAX package's
    Config object too (no isinstance check against either class)."""
    a = port_get_datasets(_synthetic_cfg(jax_config))[0]
    b = port_get_datasets(_synthetic_cfg(port_config))[0]
    np.testing.assert_array_equal(a.device_store(), b.device_store())


@pytest.mark.parametrize("ndc", [False, True])
def test_numpy_rays_equal(ndc):
    """The port's host ray forms against the JAX package's numpy ones on a
    seeded pose: exact."""
    rng = np.random.default_rng(5)
    pose = jax_synthetic.pose_spherical(*rng.uniform(-60, 60, 2), 4.0)
    want = jax_rays.get_ray_bundle(9, 11, 13.5, pose)
    got = port_rays.get_ray_bundle_np(9, 11, 13.5, pose)
    if ndc:
        want = jax_rays.ndc_mipnerf_rays(9, 11, 13.5, *want[:2])
        got = port_rays.ndc_mipnerf_rays(9, 11, 13.5, *got[:2])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    depth = rng.uniform(0.1, 0.9, (9, 11)).astype(np.float32)
    np.testing.assert_array_equal(
        port_rays.switch_t_ndc_to_regular(depth, got[0], got[1]),
        jax_rays.switch_t_ndc_to_regular(depth, want[0], want[1]))


@pytest.mark.parametrize("fn", ["pose_spherical", "generate_synthetic_blender"])
def test_synthetic_scene_equal(fn):
    if fn == "pose_spherical":
        args = (25.0, -40.0, 3.5)
        np.testing.assert_array_equal(getattr(port_synthetic, fn)(*args),
                                      getattr(jax_synthetic, fn)(*args))
        return
    got, want = port_synthetic.generate_synthetic_blender(), \
        jax_synthetic.generate_synthetic_blender()
    assert len(got) == len(want) == 5
    for a, b in zip(got[:4], want[:4]):  # images, poses, render_poses, hwf
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert len(got[4]) == len(want[4])  # i_split: index arrays per split
    for a, b in zip(got[4], want[4]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("fn", ["normalize", "viewmatrix", "poses_avg",
                                "recenter_poses", "spherify_poses"])
def test_pose_utilities_equal(fn):
    """The LLFF pose utilities on seeded poses: exact."""
    rng = np.random.default_rng(11)
    poses = rng.normal(size=(6, 3, 5)).astype(np.float32)
    poses[:, :, 4] = np.array([8.0, 10.0, 12.0], np.float32)
    bds = rng.uniform(1, 5, (6, 2)).astype(np.float32)
    args = {
        "normalize": (poses[0, :, 0],),
        "viewmatrix": (poses[0, :, 2], poses[0, :, 1], poses[0, :, 3]),
        "poses_avg": (poses,),
        "recenter_poses": (poses.copy(),),
        "spherify_poses": (poses.copy(), bds.copy()),
    }[fn]
    got = getattr(port_poses, fn)(*[np.copy(a) for a in args])
    want = getattr(jax_poses, fn)(*[np.copy(a) for a in args])
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ----------------------------------------------------------------- metrics

def _images(seed, shape=(24, 31, 3)):
    rng = np.random.default_rng(seed)
    target = rng.uniform(0, 1, shape).astype(np.float32)
    image = np.clip(target + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    return image, target


@pytest.mark.parametrize("fn", ["psnr", "rgb2gray", "ssim", "calc_ssim"])
def test_metrics_equal(fn):
    """Same numpy code on the same seeded images: exact equality."""
    image, target = _images(7)
    if fn == "ssim":
        image, target = image[..., 0], target[..., 0]
    args = (image,) if fn == "rgb2gray" else (image, target)
    got = getattr(port_metrics, fn)(*args)
    want = getattr(jax_metrics, fn)(*args)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.isfinite(np.asarray(got)).all()


# --------------------------------------------------------------- artifacts

@pytest.mark.parametrize("fn", ["cast_to_image", "cast_to_disparity_image"])
def test_image_casts_equal(fn):
    rng = np.random.default_rng(9)
    arr = rng.uniform(-0.2, 1.2, (5, 6, 3) if fn == "cast_to_image" else (5, 6))
    if fn == "cast_to_disparity_image":
        arr[0, 0] = np.nan
    np.testing.assert_array_equal(getattr(port_viz, fn)(arr),
                                  getattr(jax_viz, fn)(arr))


def test_results_file_byte_equal(tmp_path):
    rng = np.random.default_rng(13)
    keys = ("psnr_coarse", "psnr_fine", "ssim_v1_fine")
    summary = {k: [float(v) for v in rng.uniform(0, 40, 3)] for k in keys}
    results = {i: {k: summary[k][i] for k in keys} for i in range(3)}
    paths = {}
    for name, mod in (("jax", jax_viz), ("port", port_viz)):
        d = tmp_path / name
        d.mkdir()
        mod.write_dicts_to_a_file(summary, results, str(d / "results.txt"))
        files = sorted(os.listdir(d))
        assert files == ["results.txt"]
        paths[name] = (d / "results.txt").read_bytes()
    assert paths["port"] == paths["jax"] and len(paths["port"]) > 0


def _train_metrics(rng):
    keys = ("loss", "loss_coarse", "loss_fine", "psnr_coarse", "psnr_fine",
            "lr", "dp_loss", "sig_reg", "sig_loss", "mus_reg", "mus_loss")
    return {k: float(v) for k, v in zip(keys, rng.uniform(0, 1, len(keys)))}


@pytest.mark.parametrize("kind", ["train", "valid"])
def test_documenter_lines_equal(tmp_path, kind):
    """``metrics.jsonl`` lines of both Documenters for the same inputs,
    byte for byte once the wall-clock ``time`` field is dropped."""
    rng = np.random.default_rng(17)
    metrics = [_train_metrics(rng) for _ in range(3)]
    image, target = _images(19, (6, 7, 3))
    output = {c: {"rgb": image, "disp": image[..., 0], "depth": image[..., 1]}
              for c in (0, 1)}
    lines = {}
    for name, cls in (("jax", JaxDocumenter), ("port", PortDocumenter)):
        d = str(tmp_path / name)
        doc = cls(d, use_tensorboard=False, primary=True)
        for i, m in enumerate(metrics):
            if kind == "train":
                doc.write_train_iter(i, m, extra_scalars={"x/y": 1.0})
            else:
                doc.write_valid_iter(i, m, output, target, is_ddnerf=True)
        doc.close()
        with open(os.path.join(d, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        assert all(r.pop("time") > 0 for r in records)
        lines[name] = [json.dumps(r) for r in records]
    assert lines["port"] == lines["jax"] and len(lines["port"]) == 3


def test_documenter_primary_is_a_plain_argument(tmp_path):
    """Default ``primary=True`` writes; ``primary=False`` is a no-op that
    creates nothing."""
    d = str(tmp_path / "on")
    doc = PortDocumenter(d, use_tensorboard=False)
    assert doc.primary
    doc.write_train_iter(0, _train_metrics(np.random.default_rng(0)))
    doc.close()
    assert os.path.getsize(os.path.join(d, "metrics.jsonl")) > 0
    off = str(tmp_path / "off")
    doc = PortDocumenter(off, use_tensorboard=False, primary=False)
    doc.write_train_iter(0, _train_metrics(np.random.default_rng(0)))
    doc.close()
    assert not os.path.exists(off)


# ------------------------------------------------------------- source scan

def test_cycle_profile_script_anchors_match_the_kernel():
    """scripts/profile_forward_cycles.py instruments a copy of the forward
    kernel by text substitution; every anchor must still be in the source."""
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "profile_forward_cycles.py"),
         "--check-anchors"], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "anchors ok" in proc.stdout


def _port_sources():
    root = os.path.dirname(ddnerf_tpu_torch.__file__)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for base, _, names in os.walk(root):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return sorted(os.path.relpath(f, REPO) for f in files)


# The JAX package and its frameworks, and the two libraries that not every
# installation of the port has: image files go through PIL and the standard
# library (data/images.py), the figures through PIL (viz/visualization.py).
_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:ddnerf_tpu|jax|jaxlib|flax|optax|orbax|imageio"
    r"|matplotlib)\b"
    r"|import_module\(\s*['\"]ddnerf_tpu['\".]"
    r"|__import__\(\s*['\"]ddnerf_tpu['\".]", re.M)


@pytest.mark.parametrize("path", _port_sources())
def test_source_imports_nothing_of_the_jax_package(path):
    with open(os.path.join(REPO, path)) as f:
        found = _IMPORT.findall(f.read())
    assert not found, f"{path} imports {found}"


def test_port_has_no_isinstance_check_against_config():
    pattern = re.compile(r"isinstance\([^)]*\b(?:Config|ParallelConfig)\b")
    offenders = [p for p in _port_sources()
                 if pattern.search(open(os.path.join(REPO, p)).read())]
    assert not offenders
