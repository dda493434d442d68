"""Port evaluation on the CPU: ddnerf_tpu_torch's eval_model against the
JAX eval_model fed the same reference-format checkpoint through
``--torch-checkpoint``, on the procedural synthetic scene."""

import json
import os

import numpy as np
import pytest
import torch

from ddnerf_tpu.config import Config
from ddnerf_tpu.eval.evaluate import eval_model as jax_eval_model
from ddnerf_tpu.train.checkpoint import save_config_snapshot
from ddnerf_tpu_torch.cli import eval as port_cli
from ddnerf_tpu_torch.eval.evaluate import eval_model
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.utils.weights import save_checkpoint


@pytest.fixture(scope="module")
def logdir(tmp_path_factory):
    """A tiny DDNeRF run: config snapshot + the port's seeded checkpoint.
    No density noise or jitter, so both packages render deterministically."""
    path = str(tmp_path_factory.mktemp("run"))
    cfg = Config.from_dict({
        "nerf": {
            "type": "DDNerfModel", "coarse_hidden_size": 16,
            "fine_hidden_size": 16,
            "train": {"num_coarse": 4, "num_fine": 4},
            "validation": {"num_coarse": 4, "num_fine": 4, "perturb": False,
                           "radiance_field_noise_std": 0.0,
                           "chunksize": 1024},
        },
        "dataset": {"type": "blender", "synthetic": True,
                    "single_image_mode": False},
        "parallel": {"num_devices": 1, "compute_dtype": "float32"},
    }).resolved()
    save_config_snapshot(cfg, path)
    pipe = NerfPipeline(cfg, "cpu", seed=4)
    save_checkpoint(os.path.join(path, "checkpoint.ckpt"), pipe.coarse,
                    pipe.fine, step=7)
    return path


def test_eval_model_matches_jax_eval_model(logdir):
    ckpt = os.path.join(logdir, "checkpoint.ckpt")
    want, want_images = jax_eval_model(logdir, save_images=False,
                                       max_images=2, torch_checkpoint=ckpt)
    got, got_images = eval_model(logdir, max_images=2, device="cpu")
    assert os.path.isfile(os.path.join(logdir, "validation", "results.txt"))
    assert len(got_images) == len(want_images) == 2
    # f32 renders of the same weights agree to ~1e-6 per pixel (see the
    # pipeline test); on PSNR / SSIM that is far below 1e-3.
    for key in ("psnr_coarse", "psnr_fine", "ssim_v1_coarse",
                "ssim_v2_coarse", "ssim_v1_fine", "ssim_v2_fine"):
        assert np.isfinite(got[key]).all()
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-3,
                                   err_msg=key)
    assert "lpips_fine" not in got  # reported unavailable, as without weights


def test_cli_writes_results_and_counts_no_launch_on_cpu(logdir, capsys):
    port_cli.main(["--logdir", logdir, "--max-images", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("kernel launches: ")]
    launches = json.loads(line[-1][len("kernel launches: "):])
    assert launches == {
        **{f"{plan}_{kernel}{sfx}": 0 for plan in ("fused", "wide")
           for kernel in ("mlp_fwd", "mlp_fwd_stash", "mlp_bwd", "enc_mlp_fwd")
           for sfx in ("", "_f32")},
        "ipe_encode": 0, "ipe_encode_f32": 0, "chain_mask_bits": 0}
    text = open(os.path.join(logdir, "validation", "results.txt")).read()
    assert "psnr_fine" in text and "ssim_v2_coarse" in text


def test_cuda_requested_without_a_card_is_an_error(logdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_cli.main(["--logdir", logdir, "--device", "cuda"])


def test_missing_checkpoint_is_reported(logdir, tmp_path):
    os.symlink(os.path.join(logdir, "config.yml"),
               os.path.join(tmp_path, "config.yml"))
    with pytest.raises(FileNotFoundError, match="checkpoint.ckpt"):
        eval_model(str(tmp_path), device="cpu")
