"""The port's AlexNet-LPIPS (``ddnerf_tpu_torch/eval/lpips_net.py``,
``eval/metrics.py::Lpips``, eval's ``lpips_weights``) against the JAX
package's, on the CPU, with an ``.npz`` of seeded random weights in the
schema ``scripts/convert_lpips_weights.py`` writes (nothing downloaded)."""

import os
import warnings

import numpy as np
import pytest

from ddnerf_tpu.eval.evaluate import eval_model as jax_eval_model
from ddnerf_tpu.eval.lpips_net import lpips_distance as jax_lpips_distance
from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.eval import lpips_net
from ddnerf_tpu_torch.eval.evaluate import eval_model
from ddnerf_tpu_torch.eval.metrics import Lpips
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.train.checkpoint import save_config_snapshot
from ddnerf_tpu_torch.utils.weights import save_checkpoint

TOL = 1e-5  # float32 convolutions, summed in another order
_CONV_SHAPES = [(64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3),
                (256, 384, 3, 3), (256, 256, 3, 3)]


def _write_weights(path, seed=0):
    rng = np.random.default_rng(seed)
    w = {}
    for i, shape in enumerate(_CONV_SHAPES):
        fan_in = shape[1] * shape[2] * shape[3]
        w[f"conv{i}_w"] = (rng.standard_normal(shape)
                           * np.sqrt(2.0 / fan_in)).astype(np.float32)
        w[f"conv{i}_b"] = (0.01 * rng.standard_normal(shape[0])
                           ).astype(np.float32)
        w[f"lin{i}_w"] = rng.random(shape[0]).astype(np.float32)
    np.savez(path, **w)
    return w


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_alex.npz")
    _write_weights(path)
    return path


def _images(seed, hw=64):
    rng = np.random.default_rng(seed)
    a = rng.random((hw, hw, 3), np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1)
    return a, b.astype(np.float32)


@pytest.mark.parametrize("seed,hw", [(0, 64), (1, 64), (2, 80)])
def test_lpips_distance_matches_jax(weights_file, seed, hw):
    a, b = _images(seed, hw)
    want = float(jax_lpips_distance(dict(np.load(weights_file)), a, b))
    got = float(lpips_net.lpips_distance(
        lpips_net.load_weights(weights_file), a, b))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_lpips_is_zero_on_identity_and_symmetric(weights_file):
    score = Lpips(weights_file)
    assert score.available
    a, b = _images(3)
    assert score(a, a) == 0.0
    np.testing.assert_allclose(score(a, b), score(b, a), rtol=TOL)
    assert score(a, b) > 0


@pytest.mark.parametrize("content", [None, b"not an npz"],
                         ids=["missing", "garbage"])
def test_unreadable_weights_omit_the_metric_and_warn(tmp_path, content):
    path = str(tmp_path / "alex.npz")
    if content is not None:
        with open(path, "wb") as f:
            f.write(content)
    with pytest.warns(UserWarning, match="unreadable"):
        score = Lpips(path)
    assert not score.available and score(*_images(0)) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not Lpips(None).available  # no path: no metric, no warning


def test_eval_lpips_matches_jax_eval(weights_file, tmp_path):
    """Eval with ``lpips_weights``: the lpips_* entries and results.txt
    lines of the JAX ``eval_model`` on the same run and weights."""
    cfg = Config.from_dict({
        "nerf": {"type": "DDNerfModel", "coarse_hidden_size": 16,
                 "fine_hidden_size": 16,
                 "validation": {"num_coarse": 4, "num_fine": 4,
                                "perturb": False,
                                "radiance_field_noise_std": 0.0,
                                "chunksize": 2048}},
        "dataset": {"type": "blender", "synthetic": True,
                    "single_image_mode": False},
        "parallel": {"num_devices": 1, "compute_dtype": "float32"},
    }).resolved()
    pipe = NerfPipeline(cfg, "cpu", seed=4)
    runs = {}
    for name in ("jax", "port"):
        runs[name] = str(tmp_path / name)
        save_config_snapshot(cfg, runs[name])
        save_checkpoint(os.path.join(runs[name], "checkpoint.ckpt"),
                        pipe.coarse, pipe.fine, step=7)
    _, want = jax_eval_model(
        runs["jax"], save_images=False, max_images=2,
        lpips_weights=weights_file,
        torch_checkpoint=os.path.join(runs["jax"], "checkpoint.ckpt"))
    _, got = eval_model(runs["port"], save_images=False, max_images=2,
                        lpips_weights=weights_file, device="cpu")
    for i in (0, 1):
        for key in ("lpips_coarse", "lpips_fine"):
            assert got[i][key] > 0
            np.testing.assert_allclose(got[i][key], want[i][key], rtol=TOL,
                                       atol=TOL, err_msg=f"{i} {key}")

    def lpips_lines(path):
        with open(os.path.join(path, "validation", "results.txt")) as f:
            return [ln.split(":")[0] for ln in f if "lpips" in ln]

    assert lpips_lines(runs["port"]) == lpips_lines(runs["jax"])
    assert len(lpips_lines(runs["port"])) == 2 + 2 * 2
