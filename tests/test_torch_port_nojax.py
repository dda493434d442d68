"""The port runs without JAX: every ddnerf_tpu_torch module imports, a
tiny image renders and two training steps run through the train loop on
the CPU, in a process where importing jax, flax, optax or orbax fails.
chip_smoke.py refuses to report without a GPU."""

import os
import pkgutil
import re
import shutil
import subprocess
import sys

import ddnerf_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "chex")

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

import numpy as np
from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.render.renderer import ImageRenderer
from ddnerf_tpu.data.synthetic import pose_spherical

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
        "dataset.type", "blender"]).resolved()
    state, logdir = train(tcfg, max_iters=2, device="cpu")
    assert state.step == 2
    assert os.path.isfile(os.path.join(logdir, "checkpoint.ckpt"))
    losses = [json.loads(line)["loss"]
              for line in open(os.path.join(logdir, "metrics.jsonl"))]
    assert len(losses) == 4 and all(np.isfinite(losses)), losses
leaked = [m for m in sys.modules if m.split(".")[0] in {BLOCKED!r}
          and sys.modules[m] is not None]
assert not leaked, leaked
print("RENDERED AND TRAINED", len(mods), "modules")
"""


def test_port_imports_and_renders_without_jax():
    """Every module imports; a render and two train steps run."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _PROGRAM], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RENDERED AND TRAINED" in proc.stdout


def test_no_port_source_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax)\b", re.M)
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
