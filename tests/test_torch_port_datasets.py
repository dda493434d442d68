"""The port's dataset writer, ``scripts/make_synthetic_dataset_torch.py``,
against the JAX package's, ``scripts/make_synthetic_dataset.py``: for the
same arguments the same files (decoded pixels equal; ``transforms_*.json``
and ``poses_bounds.npy`` to 1e-7), since the dress rehearsal's PSNR gates
were calibrated on the scenes the JAX writer makes.  The port's writer
imports neither JAX, the JAX package nor imageio, and its ``real360``
scene is a ring of cameras that looks at the scene."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-7
ARGS = ["--size", "32", "--train", "4", "--val", "2", "--test", "1",
        "--seed", "3"]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax_writer(outdir, fmt, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["make_synthetic_dataset.py", outdir,
                                      "--format", fmt, *ARGS])
    _script("make_synthetic_dataset").main()


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def _pixels(path):
    with Image.open(path) as im:
        return np.array(im)


@pytest.mark.parametrize("fmt", ["blender", "llff"])
def test_writers_write_the_same_scene(tmp_path, monkeypatch, fmt):
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    _run_jax_writer(want, fmt, monkeypatch)
    _script("make_synthetic_dataset_torch").main([got, "--format", fmt,
                                                  *ARGS])
    files = _files(want)
    assert _files(got) == files
    pngs = [f for f in files if f.endswith(".png")]
    assert len(pngs) == 7
    for name in pngs:
        w, g = _pixels(os.path.join(want, name)), _pixels(os.path.join(got,
                                                                       name))
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape, name
        assert g.shape[-1] == (4 if fmt == "blender" else 3)
        np.testing.assert_array_equal(g, w, err_msg=name)
        assert g.std() > 0, name
    if fmt == "llff":
        np.testing.assert_allclose(
            np.load(os.path.join(got, "poses_bounds.npy")),
            np.load(os.path.join(want, "poses_bounds.npy")), rtol=TOL,
            atol=TOL)
        return
    for split, count in (("train", 4), ("val", 2), ("test", 1)):
        name = f"transforms_{split}.json"
        with open(os.path.join(want, name)) as f:
            w = json.load(f)
        with open(os.path.join(got, name)) as f:
            g = json.load(f)
        assert len(g["frames"]) == len(w["frames"]) == count
        assert g["camera_angle_x"] == pytest.approx(w["camera_angle_x"],
                                                    rel=TOL, abs=TOL)
        for gf, wf in zip(g["frames"], w["frames"]):
            assert gf["file_path"] == wf["file_path"]
            np.testing.assert_allclose(gf["transform_matrix"],
                                       wf["transform_matrix"], rtol=TOL,
                                       atol=TOL)


def test_port_writer_imports_no_jax_nor_imageio(tmp_path):
    """Every format, in a process where those imports fail."""
    blocked = ("jax", "jaxlib", "flax", "optax", "orbax", "ddnerf_tpu",
               "imageio", "matplotlib")
    program = (
        f"import runpy, sys\n"
        f"for name in {blocked!r}:\n"
        f"    sys.modules[name] = None\n"
        f"for fmt in ('blender', 'llff', 'real360'):\n"
        f"    sys.argv = ['w', {str(tmp_path)!r} + '/' + fmt, '--format', "
        f"fmt, '--size', '16', '--train', '2', '--val', '1', '--test', '1']\n"
        f"    runpy.run_path({os.path.join(REPO, 'scripts', 'make_synthetic_dataset_torch.py')!r}, "
        f"run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", program], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert os.path.isfile(tmp_path / "blender" / "transforms_val.json")
    for fmt in ("llff", "real360"):
        assert np.load(tmp_path / fmt / "poses_bounds.npy").shape == (4, 17)
        assert len(os.listdir(tmp_path / fmt / "images")) == 4


def test_real360_ring_looks_at_the_scene(tmp_path):
    """The ring's cameras, read back in the loader's convention: on a
    circle of radius 4 at 25 degrees, each looking at the origin (the
    back axis points from the origin to the camera), the scene in the
    middle of every image and inside the stored bounds."""
    from ddnerf_tpu_torch.data.synthetic import write_synthetic_real360

    write_synthetic_real360(str(tmp_path), size=32, n=6, seed=2)
    arr = np.load(tmp_path / "poses_bounds.npy")
    poses = arr[:, :15].reshape(-1, 3, 5)
    # Stored [-u, r, b, t, hwf]: the loader's swap gives [r, u, b].
    right, up, back, eye = poses[:, :, 1], -poses[:, :, 0], poses[:, :, 2], \
        poses[:, :, 3]
    np.testing.assert_allclose(np.linalg.norm(eye, axis=-1), 4.0, rtol=1e-6)
    np.testing.assert_allclose(eye[:, 2], 4.0 * np.sin(np.deg2rad(25.0)),
                               rtol=1e-6)
    np.testing.assert_allclose(back, eye / 4.0, atol=1e-6)
    for a, b in ((right, up), (up, back), (back, right)):
        np.testing.assert_allclose(np.sum(a * b, -1), 0.0, atol=1e-6)
    assert (arr[:, 15] < 4.0 - 1.1).all() and (arr[:, 16] > 4.0 + 1.1).all()
    for name in sorted(os.listdir(tmp_path / "images")):
        img = _pixels(tmp_path / "images" / name)
        assert img.shape == (32, 32, 3)
        assert img[12:20, 12:20].max() > 0  # the red sphere at the origin
        assert (img[0] == 0).all() or (img[:, 0] == 0).all()  # background
