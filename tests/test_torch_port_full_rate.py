"""The fine render at the full learning rate from step 0, against the JAX
package.  On an NVIDIA H100 the port's fine render went black within 40
steps of ``configs/synthetic_smoke.yml`` from ``lr_init`` 5e-4 without the
lr delay, on the kernels and on the plain path alike
(``scripts/full_rate_darkening.py``): at 256 / 256 in some streams of
draws, and without any draw (no jitter, no density noise, the same host
batches on every device) from a fine width of 512 at 64 rays per step.
The same run on the CPU goes black at that narrowest shape, coarse 32 /
fine 512, 64 rays of 8 + 8 samples, and so does the JAX package: the
darkening is the method's at that rate, not the port's.

Here both packages are co-trained from one JAX initialization on the same
host batches (tests/test_torch_port_quality.py's method) at that shape and
settings, without draws, from ``lr_init`` 5e-4 with ``lr_delay_steps`` 0
for 40 steps, in bfloat16 and in float32, then rendered on the two
validation views.  They must agree on whether the fine render went black
(its rgb's min and max both under ``DARK_LEVEL``, as
``scripts/full_rate_darkening.py`` calls it) and on the fine PSNR within
0.5 dB; and the compute dtype must reach both packages' CPU paths."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_quality import (  # noqa: F401 (_two_threads: autouse)
    PSNR_GAP_DB,
    REPO,
    _psnr,
    _two_threads,
)

from ddnerf_tpu.config import load_config as jax_load_config
from ddnerf_tpu.data.assembly import get_datasets as jax_get_datasets
from ddnerf_tpu.models.nerf import NerfPipeline as JaxPipeline
from ddnerf_tpu.render.renderer import ImageRenderer as JaxRenderer
from ddnerf_tpu.train.state import create_train_state
from ddnerf_tpu.train.step import make_train_step
from ddnerf_tpu.train.step import schedule_values as jax_schedule_values
from ddnerf_tpu_torch.config import load_config
from ddnerf_tpu_torch.data.assembly import get_datasets
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.render.renderer import ImageRenderer
from ddnerf_tpu_torch.train.state import TrainState
from ddnerf_tpu_torch.train.step import schedule_values, train_step
from ddnerf_tpu_torch.utils.weights import pipeline_state_from_params

DARK_LEVEL = 5e-5  # scripts/full_rate_darkening.py's
STEPS = 40
CONFIG = os.path.join(REPO, "configs", "synthetic_smoke.yml")
# The narrowest shape the card's sweep found black without draws; the
# config's rate from step 0, no jitter, no density noise.
RAYS = 64
SHAPE = ["nerf.coarse_hidden_size", "32", "nerf.fine_hidden_size", "512",
         "nerf.train.num_coarse", "8", "nerf.train.num_fine", "8",
         "nerf.validation.num_coarse", "8", "nerf.validation.num_fine", "8",
         "nerf.train.perturb", "false",
         "nerf.train.radiance_field_noise_std", "0.0",
         "optimizer.lr_delay_steps", "0"]
DTYPES = ("bfloat16", "float32")
# The untrained fine renders: bfloat16 against float32 in either package
# at least DTYPE_GAP apart (5.6e-5 read), the two packages at either dtype
# at most PACKAGE_GAP (9.7e-6 at bfloat16, 1.2e-7 at float32).
DTYPE_GAP, PACKAGE_GAP = 3e-5, 1.5e-5


def _renders(cfg, pipe, val, step, params=None, views=None):
    """The fine rgb of the first ``views`` validation views (all when
    None), by the JAX package's renderer when ``params`` are given, else by
    the port's."""
    poses = val.poses[:views]
    if params is None:
        renderer = ImageRenderer(cfg, pipe, mode="validation")
        sched = schedule_values(cfg, step)
        return [renderer.render_image_from_pose(
            pose, val.H, val.W, val.focal, sched=sched)[1]["rgb"]
            for pose in poses]
    renderer = JaxRenderer(cfg, pipe, mode="validation")
    sched = jax_schedule_values(cfg, step)
    return [np.asarray(renderer.render_image_from_pose(
        params, pose, val.H, val.W, val.focal, sched=sched)[1]["rgb"])
        for pose in poses]


def _reading(images, gts):
    rgb = np.stack(images)
    lo, hi = float(rgb.min()), float(rgb.max())
    return {"psnr": _psnr(images, gts), "min": lo, "max": hi,
            "std": float(rgb.std()),
            "dark": abs(lo) < DARK_LEVEL and abs(hi) < DARK_LEVEL}


def cotrain_renders(config, opts, steps=STEPS, rays=None, jstate=None):
    """``config`` under ``opts`` in both packages (JAX on its XLA step, the
    port under ``pallas_mlp: auto``, whose training Function runs its plain
    versions on the CPU), one JAX initialization carried across (``jstate``,
    a JAX train state, when given), ``steps`` steps on the same host
    batches of ``rays`` rays (the config's when None) -> {"untrained": the
    port's untrained fine PSNR, "port" / "jax": each package's fine PSNR
    and fine rgb min / max / std / dark after training, "untrained_rgb":
    each package's untrained fine renders}."""
    # The renders compared in float32 and without density noise.
    opts = [*opts, "parallel.fetch_dtype", "float32",
            "nerf.validation.radiance_field_noise_std", "0.0"]
    jcfg = jax_load_config(config).merge_from_list(
        opts + ["parallel.pallas_mlp", "off"]).resolved()
    cfg = load_config(config).merge_from_list(
        opts + ["parallel.pallas_mlp", "auto"]).resolved()
    rays = rays or cfg.nerf.train.num_random_rays
    jtrain, jval, jcfg = jax_get_datasets(jcfg)
    train, val, cfg = get_datasets(cfg)
    np.testing.assert_array_equal(train.images, jtrain.images)

    jpipe = JaxPipeline(jcfg)
    if jstate is None:
        jstate = create_train_state(jcfg, jpipe, jax.random.PRNGKey(0))
    pipe = NerfPipeline(cfg, "cpu")
    pipe.load_state_dicts(**pipeline_state_from_params(jstate.params))
    state = TrainState(cfg, pipe)
    before = {"port": _renders(cfg, pipe, val, 0, views=1),
              "jax": _renders(jcfg, jpipe, jval, 0, jstate.params, views=1)}
    untrained = _psnr(before["port"], val.images[:1])
    assert untrained == pytest.approx(_psnr(before["jax"], jval.images[:1]),
                                      abs=1e-3)

    jstep = jax.jit(make_train_step(jcfg, jpipe))
    rng = np.random.default_rng(11)
    for _ in range(steps):
        ro, rd, radii, rgb = train.sample_batch(rng, rays)
        jstate, _ = jstep(jstate, {
            "origins": jnp.asarray(ro), "directions": jnp.asarray(rd),
            "radii": jnp.asarray(radii), "rgb": jnp.asarray(rgb)})
        train_step(cfg, pipe, state, {
            "origins": torch.from_numpy(ro), "directions": torch.from_numpy(rd),
            "radii": torch.from_numpy(radii), "rgb": torch.from_numpy(rgb)})
    assert state.step == int(jstate.step) == steps
    return {"untrained": untrained, "untrained_rgb": before,
            "port": _reading(_renders(cfg, pipe, val, steps), val.images),
            "jax": _reading(_renders(jcfg, jpipe, jval, steps,
                                     jstate.params), jval.images)}


@pytest.fixture(scope="module")
def runs():
    """Both compute dtypes co-trained at :data:`SHAPE` from one JAX
    initialization (its parameters are float32 under either dtype)."""
    jcfg = jax_load_config(CONFIG).merge_from_list(
        [*SHAPE, "parallel.pallas_mlp", "off"]).resolved()
    jstate = create_train_state(jcfg, JaxPipeline(jcfg),
                                jax.random.PRNGKey(0))
    assert {str(leaf.dtype) for leaf in jax.tree_util.tree_leaves(
        jstate.params)} == {"float32"}
    return {dtype: cotrain_renders(
        CONFIG, [*SHAPE, "parallel.compute_dtype", dtype], rays=RAYS,
        jstate=jstate) for dtype in DTYPES}


@pytest.mark.parametrize("dtype", DTYPES)
def test_full_rate_fine_render_agrees_with_jax(runs, dtype):
    """Both packages went dark at this shape: the behaviour is the
    method's.  They must agree on it, and on the fine PSNR."""
    r = runs[dtype]
    for pkg in ("port", "jax"):
        print(f"{dtype} {pkg}: fine psnr {r['untrained']:.3f} -> "
              f"{r[pkg]['psnr']:.3f}, rgb min {r[pkg]['min']:.3e} max "
              f"{r[pkg]['max']:.3e} std {r[pkg]['std']:.3e}"
              f"{' (dark)' if r[pkg]['dark'] else ''}")
    assert r["port"]["dark"] == r["jax"]["dark"]
    assert abs(r["port"]["psnr"] - r["jax"]["psnr"]) <= PSNR_GAP_DB
    # What README.md and ROADMAP.md say of this shape: black in both.
    assert r["jax"]["dark"]


def test_compute_dtype_reaches_both_cpu_paths(runs):
    """The untrained renders differ between bfloat16 and float32 in each
    package, so the dtype reached both CPU paths, and the packages agree
    at each dtype closer than the dtypes differ."""
    for pkg in ("port", "jax"):
        a, b = (np.stack(runs[d]["untrained_rgb"][pkg]) for d in DTYPES)
        assert np.abs(a - b).max() > DTYPE_GAP, pkg
    for d in DTYPES:
        port, want = (np.stack(runs[d]["untrained_rgb"][pkg])
                      for pkg in ("port", "jax"))
        assert np.abs(port - want).max() < PACKAGE_GAP, d
