"""The port's video path on the CPU: the on-device frame quantizer against
a numpy transcription of the JAX frame program, a ragged video frame
against the JAX renderer's, the media files against independent readers,
and the render_video CLI end to end."""

import json
import os

import numpy as np
import pytest
import torch

import jax

from ddnerf_tpu.config import Config
from ddnerf_tpu.data.synthetic import pose_spherical
from ddnerf_tpu.models.nerf import NerfPipeline as JaxPipeline
from ddnerf_tpu.render.renderer import ImageRenderer as JaxRenderer
from ddnerf_tpu.train.checkpoint import save_config_snapshot
from ddnerf_tpu_torch.cli import render_video as video_cli
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.render.media import (
    AviWriter,
    read_avi,
    read_png,
    write_png,
)
from ddnerf_tpu_torch.render.renderer import (
    ImageRenderer,
    quantize_video_frame,
)
from ddnerf_tpu_torch.render.video import side_by_side
from ddnerf_tpu_torch.utils.weights import (
    params_to_state_dict,
    save_checkpoint,
)


def _numpy_quantize(rgb, disp):
    """ddnerf_tpu/render/renderer.py:403-408, transcribed to numpy in
    float32."""
    rgb_u8 = (np.clip(rgb, 0.0, 1.0) * np.float32(255)).astype(np.uint8)
    d = np.nan_to_num(disp, nan=0.0, posinf=0.0, neginf=0.0)
    lo = np.min(d)
    span = np.max(d) - lo
    norm = (d - lo) / np.where(span > 0, span, np.float32(1.0))
    disp_u8 = (np.clip(norm, 0.0, 1.0) * np.float32(255)).astype(np.uint8)
    return rgb_u8, disp_u8


@pytest.mark.parametrize("case", ["plain", "non_finite", "constant",
                                  "all_nan"])
def test_quantizer_is_bit_exact_against_the_jax_transcription(case):
    rng = np.random.default_rng(3)
    rgb = rng.uniform(-0.2, 1.2, (40, 3)).astype(np.float32)
    rgb[:4] = [[0.0] * 3, [1.0] * 3, [1 / 255] * 3, [254.999 / 255] * 3]
    disp = rng.uniform(0.1, 7.0, 40).astype(np.float32)
    if case == "non_finite":
        disp[[1, 5, 9]] = [np.nan, np.inf, -np.inf]
    elif case == "constant":
        disp[:] = 0.37
    elif case == "all_nan":
        disp[:] = np.nan
    got = quantize_video_frame(torch.tensor(rgb), torch.tensor(disp))
    want = _numpy_quantize(rgb, disp)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), w)
    if case in ("constant", "all_nan"):
        assert not got[1].any()  # a zero span divides by 1


# Frames are compared in uint8 levels.  Both sides render f32 with the same
# weights (the port through the B3 wrapper's plain version, direct-form IPE;
# JAX through XLA with its double-angle IPE) and agree to ~1e-6, so a level
# flips only where a value sits on a truncation edge.  Disparity is
# normalized by the frame's min and span first, which can amplify the
# difference.  Read: 0 levels on rgb and on disp.
RGB_LEVELS = 1
DISP_LEVELS = 2


def test_video_frame_matches_jax_video_frame():
    """A ragged 10x9 frame (90 rays in chunks of 50) against the JAX
    renderer's device-quantized frame, no jitter and no density noise."""
    cfg = Config.from_dict({
        "nerf": {
            "type": "DDNerfModel", "coarse_hidden_size": 32,
            "fine_hidden_size": 32,
            "validation": {"num_coarse": 6, "num_fine": 6, "perturb": False,
                           "radiance_field_noise_std": 0.0, "chunksize": 50},
        },
        "dataset": {"type": "blender", "near": 2.0, "far": 6.0},
        "parallel": {"compute_dtype": "float32", "num_devices": 1,
                     "pallas_mlp": "off"},
    }).resolved()
    jpipe = JaxPipeline(cfg)
    params = jpipe.init_params(jax.random.PRNGKey(0))
    port_cfg = cfg.replace_at("parallel.pallas_mlp", "auto").replace_at(
        "parallel.render_kernel_variant", "ipe2")
    pipe = NerfPipeline(port_cfg, "cpu")
    pipe.load_state_dicts(params_to_state_dict(params["coarse"]),
                          params_to_state_dict(params["fine"]))
    pose = pose_spherical(25.0, -30.0, 4.0)
    h, w, focal = 10, 9, 12.0
    want = JaxRenderer(cfg, jpipe, mode="render",
                       extract_keys=("rgb", "disp")
                       ).render_video_frame_from_pose(params, pose, h, w,
                                                      focal)
    got = ImageRenderer(port_cfg, pipe).render_video_frame_from_pose(
        pose, h, w, focal)
    for g, wnt, levels in zip(got, want, (RGB_LEVELS, DISP_LEVELS)):
        wnt = np.asarray(wnt)
        assert g.dtype == np.uint8 and g.shape == wnt.shape
        diff = np.abs(g.astype(int) - wnt.astype(int)).max()
        assert diff <= levels
    assert got[0].shape == (h, w, 3) and got[1].shape == (h, w)
    assert got[1].max() == 255 and got[1].min() == 0  # normalized disparity


# ------------------------------------------------------------------ media

@pytest.mark.parametrize("h,w", [(10, 18), (7, 9)])  # 27-byte rows are padded
def test_avi_round_trips_and_decodes_with_opencv(tmp_path, h, w):
    import cv2

    frames = np.random.default_rng(h).integers(0, 256, (3, h, w, 3),
                                               dtype=np.uint8)
    path = str(tmp_path / "v.avi")
    with AviWriter(path, w, h, fps=24) as writer:
        for f in frames:
            writer.write(f)
    got, fps = read_avi(path)
    assert fps == 24
    np.testing.assert_array_equal(got, frames)
    cap = cv2.VideoCapture(path)
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 3
    assert cap.get(cv2.CAP_PROP_FPS) == 24
    for f in frames:
        ok, bgr = cap.read()
        assert ok
        np.testing.assert_array_equal(bgr[..., ::-1], f)
    cap.release()
    with AviWriter(str(tmp_path / "w.avi"), w, h) as writer:
        with pytest.raises(ValueError, match="frame must be"):
            writer.write(frames[0, :, :-1])
        writer._frame_bytes = 2 ** 32 - 100  # a frame past the 32-bit sizes
        with pytest.raises(ValueError, match="4 GiB"):
            writer.write(frames[0])


def test_png_round_trips_and_decodes_with_pil(tmp_path):
    from PIL import Image

    image = np.random.default_rng(0).integers(0, 256, (11, 7, 3),
                                              dtype=np.uint8)
    path = str(tmp_path / "f.png")
    write_png(path, image)
    np.testing.assert_array_equal(read_png(path), image)
    with Image.open(path) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), image)


def test_side_by_side_frame():
    rgb = np.full((2, 3, 3), 7, np.uint8)
    disp = np.arange(6, dtype=np.uint8).reshape(2, 3)
    frame = side_by_side(rgb, disp)
    assert frame.shape == (2, 6, 3)
    np.testing.assert_array_equal(frame[:, :3], rgb)
    for c in range(3):
        np.testing.assert_array_equal(frame[:, 3:, c], disp)


# -------------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def logdir(tmp_path_factory):
    """A tiny DDNeRF run on the synthetic scene with ``ipe2`` under a
    kernel policy: config snapshot + the port's seeded checkpoint."""
    path = str(tmp_path_factory.mktemp("run"))
    cfg = Config.from_dict({
        "nerf": {
            "type": "DDNerfModel", "coarse_hidden_size": 16,
            "fine_hidden_size": 16,
            "validation": {"num_coarse": 4, "num_fine": 4, "perturb": False,
                           "chunksize": 1500},
        },
        "dataset": {"type": "blender", "synthetic": True,
                    "single_image_mode": False},
        "parallel": {"num_devices": 1, "compute_dtype": "bfloat16",
                     "pallas_mlp": "auto", "render_kernel_variant": "ipe2"},
    }).resolved()
    save_config_snapshot(cfg, path)
    pipe = NerfPipeline(cfg, "cpu", seed=2)
    save_checkpoint(os.path.join(path, "checkpoint.ckpt"), pipe.coarse,
                    pipe.fine, step=5)
    return path


def test_cli_writes_video_frames_and_launch_counts(logdir, capsys):
    video_cli.main(["--logdir", logdir, "--max-frames", "3", "--save_images",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert [ln.split()[1] for ln in out.splitlines()
            if ln.startswith("frame ")] == ["0/3", "1/3", "2/3"]
    line = [ln for ln in out.splitlines() if ln.startswith("kernel launches: ")]
    launches = json.loads(line[-1][len("kernel launches: "):])
    assert launches == {
        **{f"{plan}_{kernel}{sfx}": 0 for plan in ("fused", "wide")
           for kernel in ("mlp_fwd", "mlp_fwd_stash", "mlp_bwd", "enc_mlp_fwd")
           for sfx in ("", "_f32")},
        "ipe_encode": 0, "ipe_encode_f32": 0, "chain_mask_bits": 0}
    savedir = os.path.join(logdir, "video")
    frames, fps = read_avi(os.path.join(savedir, "video.avi"))
    assert frames.shape == (3, 64, 128, 3) and fps == 24
    for i, frame in enumerate(frames):
        np.testing.assert_array_equal(
            read_png(os.path.join(savedir, f"frame_{i:04d}.png")), frame)
        # The right half is the disparity, grey, normalized per frame.
        right = frame[:, 64:]
        assert (right == right[..., :1]).all() and right.max() == 255
    assert frames[0].std() > 0 and not np.array_equal(frames[0], frames[1])


def test_cli_without_save_images_writes_only_the_video(logdir, tmp_path):
    os.symlink(os.path.join(logdir, "config.yml"),
               os.path.join(tmp_path, "config.yml"))
    video_cli.main(["--logdir", str(tmp_path), "--max-frames", "1",
                    "--torch-checkpoint",
                    os.path.join(logdir, "checkpoint.ckpt"),
                    "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "video")) == ["video.avi"]
    assert read_avi(str(tmp_path / "video" / "video.avi"))[0].shape[0] == 1


def test_video_cli_cuda_requested_without_a_card_is_an_error(logdir,
                                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        video_cli.main(["--logdir", logdir, "--device", "cuda"])
