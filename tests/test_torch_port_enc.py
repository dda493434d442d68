"""Port parity for the in-kernel-IPE forward (``render_kernel_variant:
ipe2``): the plain version of the B3 wrapper against the JAX package's
``fused_enc_mlp_forward`` in interpret mode, the ``ipe2`` pipeline against
the JAX pipeline with the same config, the variant dispatch, and the
construction-time checks of the render selectors.

The CUDA kernel itself runs only on a GPU (tests/test_torch_port_cuda.py);
here the wrapper takes its plain version."""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddnerf_tpu.config import Config, load_config
from ddnerf_tpu.kernels.fused_mlp import fused_enc_mlp_forward as jax_enc
from ddnerf_tpu.models.mlp import DepthMipMLP as JaxDepthMLP
from ddnerf_tpu.models.mlp import MipMLP as JaxMLP
from ddnerf_tpu.models.nerf import NerfPipeline as JaxPipeline
from ddnerf_tpu.models.nerf import RayBatch as JaxRays
from ddnerf_tpu.models.nerf import ScheduleValues as JaxSched
from ddnerf_tpu_torch.kernels import fused_mlp as fk
from ddnerf_tpu_torch.models import nerf as port_nerf
from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP
from ddnerf_tpu_torch.models.nerf import NerfPipeline, RayBatch, ScheduleValues
from ddnerf_tpu_torch.utils.weights import params_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 1e-4  # as tests/test_fused_mlp.py: f32, summation order only
BF16_TOL = 2e-2  # bf16 operands: an order change can flip one rounding
TOL = 2e-3  # the f32 slice, as tests/test_torch_port_pipeline.py


def _setup(depth_head, hidden=32, rays=6, k=5, dtype="float32", seed=0):
    """Section Gaussians as tests/test_fused_mlp.py draws them: means up to
    +-3, so 2^15 x 3 engages the 100 pi wrap of the sin argument."""
    rng = np.random.default_rng(seed)
    n = rays * k
    means = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    covs = rng.uniform(1e-5, 0.3, (n, 3)).astype(np.float32)
    dirs = rng.uniform(-1, 1, (rays, 27)).astype(np.float32)
    jdt = {"float32": None, "bfloat16": jnp.bfloat16}[dtype]
    jmod = (JaxDepthMLP if depth_head else JaxMLP)(hidden_size=hidden,
                                                   dtype=jdt)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.zeros((rays, k, 96)),
                       jnp.asarray(dirs)[:, None, :])["params"]
    cdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    net = (DepthMipMLP if depth_head else MipMLP)(hidden_size=hidden,
                                                  compute_dtype=cdt)
    net.load_state_dict(params_to_state_dict(params))
    return params, net, means, covs, dirs


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("depth_head", [False, True])
def test_enc_plain_version_matches_pallas_interpret(depth_head, dtype, tol):
    params, net, means, covs, dirs = _setup(depth_head, dtype=dtype)
    assert np.abs(means).max() * 2 ** 15 > 100 * np.pi  # the wrap engages
    want = jax_enc(params, jnp.asarray(means), jnp.asarray(covs),
                   jnp.asarray(dirs), depth_head=depth_head, samples_per_ray=5,
                   rays_per_block=2, compute_dtype=getattr(jnp, dtype),
                   interpret=True)
    before = dict(fk.LAUNCHES)
    with torch.no_grad():
        got = fk.fused_enc_mlp_forward(net, torch.tensor(means),
                                       torch.tensor(covs), torch.tensor(dirs),
                                       samples_per_ray=5)
    assert fk.LAUNCHES == before  # the plain version is not a launch
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def test_enc_wrapper_checks_its_inputs_and_never_falls_back():
    _, net, means, covs, dirs = _setup(False, rays=3, k=4)
    means, covs, dirs = map(torch.tensor, (means, covs, dirs))
    with pytest.raises(ValueError, match="means must be"):
        fk.fused_enc_mlp_forward(net, torch.zeros(12, 4), covs, dirs, 4)
    with pytest.raises(ValueError, match="covs must be"):
        fk.fused_enc_mlp_forward(net, means, covs[:8], dirs, 4)
    with pytest.raises(ValueError, match="whole rays"):
        fk.fused_enc_mlp_forward(net, means[:11], covs[:11], dirs, 4)
    with pytest.raises(ValueError, match="one row per"):
        fk.fused_enc_mlp_forward(net, means, covs, dirs[:2], 4)
    # Off the CPU the wrapper launches its kernel or raises.
    with pytest.raises(ValueError, match="no fused MLP kernel"):
        fk.fused_enc_mlp_forward(net, means.to("meta"), covs.to("meta"),
                                 dirs.to("meta"), 4)


# ------------------------------------------------------------- the pipeline

def _cfg(**parallel):
    return Config.from_dict({
        "nerf": {
            "type": "DDNerfModel", "coarse_hidden_size": 32,
            "fine_hidden_size": 32,
            "validation": {"num_coarse": 6, "num_fine": 6, "perturb": False,
                           "radiance_field_noise_std": 0.0, "chunksize": 50},
        },
        "dataset": {"type": "blender", "near": 2.0, "far": 6.0},
        "parallel": {"compute_dtype": "float32", "num_devices": 1,
                     **parallel},
    }).resolved()


def _rays(n=16, seed=0):
    rng = np.random.default_rng(seed)
    ro = rng.standard_normal((n, 3)).astype(np.float32)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True) * 0.8  # non-unit norms
    radii = np.abs(rng.standard_normal((n, 1))).astype(np.float32) * 0.01
    return ro, rd, radii


KEYS = {0: ("rgb", "disp", "acc", "weights", "depth", "corrected_disp_map",
            "t_vals"),
        1: ("rgb", "disp", "acc", "weights", "depth", "t_vals")}
VALIDATION_KEYS = {0: ("mus", "sigmas", "smoothed_sigmas"), 1: ("dp_loss",)}


@pytest.mark.parametrize("mode", ["render", "validation"])
def test_ipe2_pipeline_matches_jax_pallas_interpret(mode):
    """``render_kernel_variant: ipe2`` under ``use_pallas_mlp: true``: the
    JAX side runs ``fused_enc_mlp_forward`` in interpret mode, the port's
    wrapper its plain version."""
    cfg = _cfg(use_pallas_mlp=True, render_kernel_variant="ipe2")
    jpipe = JaxPipeline(cfg)
    params = jpipe.init_params(jax.random.PRNGKey(0))
    pipe = NerfPipeline(cfg, "cpu")
    pipe.load_state_dicts(params_to_state_dict(params["coarse"]),
                          params_to_state_dict(params["fine"]))
    ro, rd, radii = _rays()
    want = jpipe.render_rays(
        params, JaxRays.create(*map(jnp.asarray, (ro, rd, radii)), 2.0, 6.0),
        jax.random.PRNGKey(1), JaxSched.for_eval(cfg), mode)
    got = pipe.render_rays(
        RayBatch.create(*map(torch.tensor, (ro, rd, radii)), 2.0, 6.0),
        ScheduleValues.for_eval(cfg), mode)
    keys = {i: KEYS[i] + (VALIDATION_KEYS[i] if mode == "validation" else ())
            for i in KEYS}
    for i in keys:
        for key in keys[i]:
            np.testing.assert_allclose(
                got[i][key].numpy(), np.asarray(want[i][key]), rtol=TOL,
                atol=TOL, err_msg=f"{mode} cycle {i} {key}")


@pytest.fixture
def enc_calls(monkeypatch):
    """Counts the pipeline's calls of the B3 wrapper, by mode."""
    calls = []
    real = port_nerf.fused_enc_mlp_forward

    def spy(*args, **kwargs):
        calls.append(args[0].depth_head)
        return real(*args, **kwargs)

    monkeypatch.setattr(port_nerf, "fused_enc_mlp_forward", spy)
    return calls


@pytest.mark.parametrize("variant,policy,mode,expected", [
    ("ipe2", "auto", "render", [True, False]),
    ("ipe2", "render", "validation", [True, False]),
    ("ipe2", "all", "train", []),  # forward only: training never takes B3
    ("ipe2", "off", "render", []),
    ("mlp", "auto", "render", []),
])
def test_variant_dispatch(enc_calls, variant, policy, mode, expected):
    cfg = _cfg(pallas_mlp=policy, render_kernel_variant=variant)
    pipe = NerfPipeline(cfg, "cpu")
    ro, rd, radii = _rays(8)
    pipe.render_rays(RayBatch.create(*map(torch.tensor, (ro, rd, radii)),
                                     2.0, 6.0),
                     ScheduleValues.for_eval(cfg), mode,
                     torch.Generator().manual_seed(0))
    assert enc_calls == expected  # coarse (depth head), then fine


def test_ipe2_and_mlp_agree_on_cpu():
    """On the CPU both variants run plain versions; ``ipe2`` takes the
    direct-form IPE, which ``mlp`` matches with ``ipe_double_angle:
    false``."""
    ro, rd, radii = _rays(8)
    outs = []
    for variant in ("ipe2", "mlp"):
        pipe = NerfPipeline(_cfg(pallas_mlp="auto", ipe_double_angle=False,
                                 render_kernel_variant=variant), "cpu")
        outs.append(pipe.render_rays(
            RayBatch.create(*map(torch.tensor, (ro, rd, radii)), 2.0, 6.0),
            ScheduleValues.for_eval(pipe.cfg)))
    for i in (0, 1):
        assert torch.equal(outs[0][i]["rgb"], outs[1][i]["rgb"])


# ---------------------------------------------------- the render selectors

@pytest.mark.parametrize("parallel,match", [
    ({"render_kernel_variant": "ipe"}, "render_kernel_variant"),
    ({"render_kernel_variant": "mlp2"}, "render_kernel_variant"),
    ({"ipe_variant": "floor"}, "ipe_variant"),
    ({"ipe_variant": "fused", "ipe_transposed": True}, "ipe_transposed"),
])
def test_bad_render_selectors_raise_as_in_jax(parallel, match):
    cfg = _cfg(**parallel)
    with pytest.raises(ValueError, match=match):
        JaxPipeline(cfg)
    with pytest.raises(ValueError, match=match):
        NerfPipeline(cfg, "cpu")


def test_fused_ipe_variant_without_transpose_constructs():
    pipe = NerfPipeline(_cfg(ipe_variant="fused", ipe_transposed=False))
    assert pipe.render_variant == "mlp"


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(REPO, "configs", "*.yml"))), ids=os.path.basename)
def test_every_shipped_config_constructs(path):
    """The selectors of every shipped config pass, for both model
    families: a DDNeRF config builds two networks, a mip-NeRF config one
    shared network."""
    cfg = load_config(path)
    pipe = NerfPipeline(cfg, "cpu")
    assert pipe.render_variant == cfg.parallel.render_kernel_variant
    assert pipe.shared_net == (not cfg.is_ddnerf())
    assert len(pipe.networks()) == (2 if cfg.is_ddnerf() else 1)
