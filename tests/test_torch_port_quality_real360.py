"""Quality against the JAX package on the real-360 path: DDNeRF
(``configs/real360_dd.yml``: world-space rays, ``normalize_poses``, the
spherical render path) on a ring of cameras written by
``write_synthetic_real360`` (10 views of 128², minified 4x to 32² by the
config, ``llffhold`` 8 holding out 2), co-trained by both packages from
the same weights on the same batches for 300 steps under
tests/test_torch_port_quality.py's method, narrowing and gates: the fine
PSNRs on the held-out views within 0.5 dB, each at least 3 dB above the
untrained nets'."""

from test_torch_port_quality import (  # noqa: F401 (_two_threads: autouse)
    NARROW,
    _two_threads,
    assert_quality,
    cotrain,
)

from ddnerf_tpu_torch.data.synthetic import write_synthetic_real360


def test_cotrained_psnr_matches_jax_on_real360(tmp_path):
    scene = str(tmp_path / "ring")
    write_synthetic_real360(scene, size=128, n=10, seed=1)
    untrained, got, want, val = cotrain(
        "real360_dd.yml", ["dataset.basedir", scene, *NARROW])
    assert (val.H, val.W) == (32, 32) and len(val.poses) == 2
    assert_quality("real360", untrained, got, want)
