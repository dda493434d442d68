"""The COLMAP path of the port against the JAX package's, on the CPU, on
scenes that hold only what COLMAP leaves: a sparse model (``sparse/0``,
binary or text, written by tests/test_llff.py's writers) and ``images/``.

* the readers (``read_model``, ``detect_model_format``), the pose
  extraction (``load_colmap_data``) and ``gen_poses``, whose
  ``poses_bounds.npy`` must be byte for byte the JAX package's;
* ``load_llff_data`` and ``get_datasets`` under ``configs/ff_dd.yml``
  (forward-facing, NDC rays) and ``configs/real360_dd.yml``
  (``normalize_poses``), every array equal;
* the error for a scene without a model;
* C12: a rank that loads the scene while another is writing the pose cache
  must never read a partly written file;
* the port's train and eval CLIs on such a scene.

Each package works on its own copy of a scene, as both write caches into
it (``poses_bounds.npy``, ``images_{factor}/``)."""

import json
import os
import re
import shutil
import threading

import numpy as np
import pytest

from test_llff import write_colmap_model, write_colmap_model_text

from ddnerf_tpu.config import load_config as jax_load_config
from ddnerf_tpu.data import colmap as jax_colmap
from ddnerf_tpu.data import poses as jax_poses
from ddnerf_tpu.data.assembly import get_datasets as jax_get_datasets
from ddnerf_tpu.data import llff as jax_llff
from ddnerf_tpu_torch.cli import eval as eval_cli
from ddnerf_tpu_torch.cli import train as train_cli
from ddnerf_tpu_torch.config import load_config
from ddnerf_tpu_torch.data import colmap, llff, poses
from ddnerf_tpu_torch.data.assembly import get_datasets
from ddnerf_tpu_torch.data.images import write_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"llff": "ff_dd.yml", "real360": "real360_dd.yml"}
FORMATS = ("binary", "text")
N_CAMS, WIDTH, HEIGHT = 8, 64, 48  # the writers' default image size
# The train CLI on the CPU: 16-wide networks, 4 + 4 samples.
TINY = ["nerf.coarse_hidden_size", "16", "nerf.fine_hidden_size", "16",
        "nerf.train.num_coarse", "4", "nerf.train.num_fine", "4",
        "nerf.train.num_random_rays", "32",
        "nerf.validation.num_coarse", "4", "nerf.validation.num_fine", "4",
        "nerf.validation.chunksize", "1024",
        "train_params.depth_analysis_rays", "false"]


def write_colmap_scene(base, fmt="binary", seed=0):
    """A forward-facing capture as COLMAP leaves it: ``N_CAMS`` cameras on
    a small arc looking at a cloud of 50 points (tests/test_llff.py's
    ``llff_dir`` geometry), the model in ``fmt``, and the images."""
    rng = np.random.default_rng(seed)
    target, w2c = np.array([0.0, 0.0, 4.5]), []
    for i in range(N_CAMS):
        ang = 0.15 * (i - N_CAMS / 2)
        pos = np.array([2.0 * np.sin(ang), 0.1 * rng.standard_normal(),
                        -0.5 * np.cos(ang)])
        fwd = (target - pos) / np.linalg.norm(target - pos)
        right = np.cross([0.0, -1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        rot = np.stack([right, np.cross(fwd, right), fwd])  # world -> camera
        w2c.append((rot, -rot @ pos))
    points = rng.uniform(-1, 1, (50, 3))
    points[:, 2] = rng.uniform(3.0, 6.0, 50)
    writer = write_colmap_model if fmt == "binary" else write_colmap_model_text
    writer(os.path.join(base, "sparse", "0"), w2c, points)
    os.makedirs(os.path.join(base, "images"))
    for i in range(N_CAMS):
        write_image(os.path.join(base, "images", f"img_{i:03d}.png"),
                    rng.integers(0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8))
    return base


@pytest.fixture(scope="module", params=FORMATS)
def scenes(request, tmp_path_factory):
    """(the port's copy, the JAX package's copy) of one scene; the copies
    share their directory's name, which the real-360 render path reads."""
    root = tmp_path_factory.mktemp(f"colmap_{request.param}")
    port = write_colmap_scene(str(root / "port" / "scene"), request.param)
    want = str(root / "jax" / "scene")
    shutil.copytree(port, want)
    return port, want


def _assert_same(got, want, path="model"):
    """Dicts of COLMAP records (dataclasses), arrays and scalars: equal
    keys, fields and values."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}[{k}]")
    elif hasattr(want, "__dataclass_fields__"):
        assert type(got).__name__ == type(want).__name__, path
        assert got.__dataclass_fields__.keys() == want.__dataclass_fields__.keys()
        for f in want.__dataclass_fields__:
            _assert_same(getattr(got, f), getattr(want, f), f"{path}.{f}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(got, want, err_msg=path)
        assert np.asarray(got).dtype == np.asarray(want).dtype, path


def test_model_readers_match_jax(scenes):
    port, want = scenes
    sparse, jsparse = (os.path.join(d, "sparse", "0") for d in scenes)
    assert colmap.detect_model_format(sparse) == \
        jax_colmap.detect_model_format(jsparse)
    _assert_same(colmap.read_model(sparse), jax_colmap.read_model(jsparse))
    _assert_same(poses.load_colmap_data(port),
                 jax_poses.load_colmap_data(want))


def test_gen_poses_writes_the_jax_packages_bytes(scenes):
    port, want = scenes
    poses.gen_poses(port)
    jax_poses.gen_poses(want)
    with open(os.path.join(port, "poses_bounds.npy"), "rb") as f:
        got = f.read()
    with open(os.path.join(want, "poses_bounds.npy"), "rb") as f:
        assert got == f.read()
    assert sorted(os.listdir(port)) == ["images", "poses_bounds.npy",
                                        "sparse"]
    arr = np.load(os.path.join(port, "poses_bounds.npy"))
    assert arr.shape == (N_CAMS, 17) and (arr[:, 15] < arr[:, 16]).all()


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_loaders_match_jax_on_a_colmap_only_scene(tmp_path, kind):
    """Each package's first load of the scene builds ``poses_bounds.npy``
    from the model, then every array of ``load_llff_data`` and of
    ``get_datasets`` (the training store, the validation views, the
    config after ``normalize_poses``) is the JAX package's."""
    port = write_colmap_scene(str(tmp_path / "port" / "scene"), seed=3)
    want = str(tmp_path / "jax" / "scene")
    shutil.copytree(port, want)
    name = os.path.join(REPO, "configs", CONFIGS[kind])
    cfg = load_config(name).merge_from_list(["dataset.basedir", port])
    jcfg = jax_load_config(name).merge_from_list(["dataset.basedir", want])
    got, exp = llff.load_llff_data(cfg), jax_llff.load_llff_data(jcfg)
    assert os.path.isfile(os.path.join(port, "poses_bounds.npy"))
    assert len(got) == len(exp) == 5
    for a, b, what in zip(got, exp, ("images", "poses", "bds",
                                     "render_poses", "i_test")):
        np.testing.assert_array_equal(a, b, err_msg=what)
        assert np.asarray(a).dtype == np.asarray(b).dtype, what
    train, val, rcfg = get_datasets(cfg.resolved())
    jtrain, jval, jrcfg = jax_get_datasets(jcfg.resolved())
    assert rcfg.replace_at("dataset.basedir", want).to_dict() == \
        jrcfg.to_dict()
    np.testing.assert_array_equal(train.device_store(), jtrain.device_store())
    np.testing.assert_array_equal(val.images, jval.images)
    np.testing.assert_array_equal(val.poses, jval.poses)
    for a, b in zip(val.get_next_validation_rays(),
                    jval.get_next_validation_rays()):
        np.testing.assert_array_equal(a, b)


def test_missing_model_raises_as_jax(tmp_path):
    """No model in ``sparse/0``: the reader, ``gen_poses`` and the loader
    of each package raise ``FileNotFoundError`` with the same message
    (tests/test_llff.py::test_read_model_missing_dir), and nothing is
    written into the scene."""
    base = str(tmp_path / "scene")
    os.makedirs(os.path.join(base, "images"))
    nope = os.path.join(base, "nope_model")
    for port_fn, jax_fn in (
            (lambda: colmap.read_model(nope), lambda: jax_colmap.read_model(nope)),
            (lambda: poses.gen_poses(base), lambda: jax_poses.gen_poses(base)),
            (lambda: llff._load_data(base), lambda: jax_llff._load_data(base))):
        with pytest.raises(FileNotFoundError) as got:
            port_fn()
        with pytest.raises(FileNotFoundError) as want:
            jax_fn()
        assert str(got.value) == str(want.value)
    assert os.listdir(base) == ["images"]


def test_a_reader_never_sees_a_partly_written_pose_cache(tmp_path,
                                                         monkeypatch):
    """C12: under ``torchrun`` every rank loads the scene, and a rank that
    finds no ``poses_bounds.npy`` builds it.  The writer here stops in the
    middle of writing the array (half of its bytes out, the file still
    open) until a second thread has loaded the scene.  That load must see
    either no cache, and build its own, or a whole one: its arrays are the
    final file's, and the file is the JAX package's, byte for byte."""
    import numpy.lib.format as npy_format

    scene = write_colmap_scene(str(tmp_path / "port" / "scene"))
    want = str(tmp_path / "jax" / "scene")
    shutil.copytree(scene, want)
    write_array = npy_format.write_array
    window, loaded = threading.Event(), threading.Event()
    writer_ident, result = [], {}

    def stalled_write_array(fid, arr, *args, **kwargs):
        if threading.get_ident() not in writer_ident:
            return write_array(fid, arr, *args, **kwargs)
        import io

        buf = io.BytesIO()
        write_array(buf, arr, *args, **kwargs)
        data = buf.getvalue()
        fid.write(data[:len(data) // 2])
        fid.flush()
        window.set()
        assert loaded.wait(60), "the reader did not finish"
        fid.write(data[len(data) // 2:])

    def write():
        writer_ident.append(threading.get_ident())
        poses.gen_poses(scene)

    def read():
        assert window.wait(60), "the writer never began"
        try:
            result["arrays"] = llff._load_data(scene)
        except Exception as e:  # the reader's failure is the finding
            result["error"] = repr(e)
        finally:
            loaded.set()

    monkeypatch.setattr(npy_format, "write_array", stalled_write_array)
    threads = [threading.Thread(target=write), threading.Thread(target=read)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    monkeypatch.undo()
    assert "error" not in result, result["error"]
    final = llff._load_data(scene)
    for a, b in zip(result["arrays"], final):
        np.testing.assert_array_equal(a, b)
    jax_poses.gen_poses(want)
    with open(os.path.join(scene, "poses_bounds.npy"), "rb") as f:
        got = f.read()
    with open(os.path.join(want, "poses_bounds.npy"), "rb") as f:
        assert got == f.read()
    assert sorted(os.listdir(scene)) == ["images", "poses_bounds.npy",
                                         "sparse"]


def test_train_and_eval_clis_on_a_colmap_only_scene(tmp_path, capsys):
    """The user's flow on a fresh capture: the train CLI (4 iterations of
    ``configs/ff_dd.yml``, narrowed) writes ``poses_bounds.npy`` from the
    model and trains; the eval CLI writes a finite ``psnr_fine``."""
    scene = write_colmap_scene(str(tmp_path / "scene"), "text")
    train_cli.main(["--config", os.path.join(REPO, "configs", CONFIGS["llff"]),
                    "--max-iters", "4", "--device", "cpu",
                    "dataset.basedir", scene, "experiment.logdir",
                    str(tmp_path), "experiment.id", "run",
                    "experiment.validate_every", "3",
                    "experiment.save_every", "4", *TINY])
    assert os.path.isfile(os.path.join(scene, "poses_bounds.npy"))
    logdir = os.path.join(str(tmp_path), "run")
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        losses = [r["loss"] for r in map(json.loads, f)
                  if r["kind"] == "train"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    eval_cli.main(["--logdir", logdir, "--max-images", "1", "--device",
                   "cpu"])
    with open(os.path.join(logdir, "validation", "results.txt")) as f:
        text = f.read()
    psnr = float(re.search(r"^psnr_fine: \t (\S+)$", text, re.M).group(1))
    assert np.isfinite(psnr)
    assert "[VAL] iter 3 " in capsys.readouterr().out
