"""Quality against the JAX package on the LLFF / NDC path: DDNeRF
(``configs/ff_dd.yml``: NDC rays, the forward-facing spiral) on a
forward-facing capture written by ``write_synthetic_llff`` (10 views of
128², minified 4x to 32² by the config, ``llffhold`` 8 holding out 2),
co-trained by both packages from the same weights on the same batches for
300 steps under tests/test_torch_port_quality.py's method, narrowing and
gates: the fine PSNRs on the held-out views within 0.5 dB, each at least
3 dB above the untrained nets'.  The scene has no keypoint file, so the
depth-analysis rays are off."""

from test_torch_port_quality import (  # noqa: F401 (_two_threads: autouse)
    NARROW,
    _two_threads,
    assert_quality,
    cotrain,
)

from ddnerf_tpu_torch.data.synthetic import write_synthetic_llff


def test_cotrained_psnr_matches_jax_on_ndc(tmp_path):
    scene = str(tmp_path / "fern")
    write_synthetic_llff(scene, size=128, n=10, seed=1)
    untrained, got, want, val = cotrain(
        "ff_dd.yml", ["dataset.basedir", scene, *NARROW,
                      "train_params.depth_analysis_rays", "false"])
    assert (val.H, val.W) == (32, 32) and len(val.poses) == 2
    assert_quality("ndc", untrained, got, want)
