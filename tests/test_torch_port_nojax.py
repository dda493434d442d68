"""The port runs without JAX and without the JAX package: every
ddnerf_tpu_torch module imports (the data-parallel modules and LPIPS among
them), a tiny image renders, two training steps run through the train loop
and a video frame of the logdir they write renders, LPIPS scores two images
on weights written here, on the CPU, in a process where importing jax,
flax, optax, orbax or ddnerf_tpu fails, and so does importing imageio or
matplotlib, which not every installation of the port has.  chip_smoke.py
refuses to report without a GPU."""

import os
import pkgutil
import re
import shutil
import subprocess
import sys

import ddnerf_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "ddnerf_tpu",
           "imageio", "matplotlib")

_PROGRAM = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of it raises ImportError
import importlib, pkgutil
import ddnerf_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(ddnerf_tpu_torch.__path__,
                                              "ddnerf_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
assert {{"ddnerf_tpu_torch.parallel.mesh",
         "ddnerf_tpu_torch.parallel.distributed",
         "ddnerf_tpu_torch.eval.lpips_net",
         "ddnerf_tpu_torch.core.draws"}} <= set(mods), mods

import numpy as np
from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.render.renderer import ImageRenderer
from ddnerf_tpu_torch.data.synthetic import pose_spherical

cfg = Config.from_dict({{
    "nerf": {{"type": "DDNerfModel", "coarse_hidden_size": 16,
              "fine_hidden_size": 16,
              "validation": {{"num_coarse": 4, "num_fine": 4,
                              "perturb": True, "chunksize": 20}}}},
    "parallel": {{"compute_dtype": "bfloat16", "pallas_mlp": "auto"}},
}}).resolved()
out = ImageRenderer(cfg, NerfPipeline(cfg, "cpu")).render_image_from_pose(
    pose_spherical(10.0, -30.0, 4.0), 6, 7, 8.0)
assert out[1]["rgb"].shape == (6, 7, 3) and np.isfinite(out[1]["rgb"]).all()

import json, os, tempfile
from ddnerf_tpu_torch.train.loop import train
with tempfile.TemporaryDirectory() as tmp:
    tcfg = cfg.merge_from_list([
        "experiment.logdir", tmp, "experiment.validate_every", "1",
        "nerf.train.num_coarse", "4", "nerf.train.num_fine", "4",
        "nerf.train.num_random_rays", "16", "dataset.synthetic", "true",
        "dataset.type", "blender", "nerf.validation.chunksize", "1024",
        "parallel.render_kernel_variant", "ipe2"]).resolved()
    state, logdir = train(tcfg, max_iters=2, device="cpu")
    assert state.step == 2
    assert os.path.isfile(os.path.join(logdir, "checkpoint_2.ckpt"))
    losses = [json.loads(line)["loss"]
              for line in open(os.path.join(logdir, "metrics.jsonl"))]
    assert len(losses) == 4 and all(np.isfinite(losses)), losses
    from ddnerf_tpu_torch.render.media import read_avi
    from ddnerf_tpu_torch.render.video import render_model_video
    frames, _ = read_avi(render_model_video(logdir, max_frames=1,
                                            device="cpu"))
    assert frames.shape == (1, 64, 128, 3), frames.shape
    # An on-disk LLFF scene: PNGs written, minified and read without
    # imageio, NDC rays, a frame rendered from them.
    from ddnerf_tpu_torch.data.assembly import get_datasets
    from ddnerf_tpu_torch.data.synthetic import write_synthetic_llff
    write_synthetic_llff(os.path.join(tmp, "scene"), size=16, n=5, seed=1)
    lcfg = cfg.merge_from_list([
        "dataset.type", "llff", "dataset.basedir", os.path.join(tmp, "scene"),
        "dataset.downsample_factor", "2", "dataset.ndc_rays", "true",
        "dataset.near", "0", "dataset.far", "1", "dataset.llffhold", "2",
        "dataset.bd_factor", "0.75"]).resolved()
    _, val_ds, lcfg = get_datasets(lcfg)
    rgb, disp = ImageRenderer(lcfg, NerfPipeline(lcfg, "cpu")
                              ).render_video_frame_from_pose(
        val_ds.render_poses[0], val_ds.H, val_ds.W, val_ds.focal)
    assert rgb.shape == (8, 8, 3) and disp.shape == (8, 8)
    from ddnerf_tpu_torch.eval.metrics import Lpips
    from ddnerf_tpu_torch.parallel.mesh import maybe_mesh
    rng = np.random.default_rng(0)
    shapes = [(64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3),
              (256, 384, 3, 3), (256, 256, 3, 3)]
    w = {{}}
    for i, sh in enumerate(shapes):
        w[f"conv{{i}}_w"] = 0.05 * rng.standard_normal(sh).astype(np.float32)
        w[f"conv{{i}}_b"] = np.zeros(sh[0], np.float32)
        w[f"lin{{i}}_w"] = rng.random(sh[0]).astype(np.float32)
    np.savez(os.path.join(tmp, "alex.npz"), **w)
    img = rng.random((32, 32, 3)).astype(np.float32)
    assert Lpips(os.path.join(tmp, "alex.npz"))(img, img[::-1]) > 0
    assert maybe_mesh(cfg, "cpu") is None  # one process: no group
leaked = [m for m in sys.modules if m.split(".")[0] in {BLOCKED!r}
          and sys.modules[m] is not None]
assert not leaked, leaked
print("RENDERED, TRAINED AND FILMED", len(mods), "modules")
"""


def test_port_imports_and_renders_without_jax():
    """Every module imports; a render, two train steps and a video frame
    run."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _PROGRAM], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RENDERED, TRAINED AND FILMED" in proc.stdout


def test_no_port_source_imports_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|orbax|ddnerf_tpu|imageio"
        r"|matplotlib)\b", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.dirname(ddnerf_tpu_torch.__file__)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert not offenders
    mods = list(pkgutil.walk_packages(ddnerf_tpu_torch.__path__,
                                      "ddnerf_tpu_torch."))
    # The package's .py files are its walked modules plus the root __init__.
    assert len(files) - 1 == len(mods) + 1


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """No CUDA: non-zero exit and no result line, in the repository and in a
    directory that holds chip_smoke.py alone."""
    lone = os.path.join(tmp_path, "chip_smoke.py")
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (lone, str(tmp_path))):
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
