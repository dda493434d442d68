"""The plain backward (B2's plain version) against the JAX package's
``fused_mlp_backward`` in interpret mode, with transplanted weights and the
JAX forward's stash: at network widths that are none of the kernels' own
(48, 96, 320) and one new one (192), and with the per-sample dirs of the
JAX package's default (``parallel.kernel_per_ray_dirs: false``).  The
forward kernels' widths and the zero padding: tests/test_torch_port_widths.py.

The CUDA kernels themselves run only on a GPU (tests/test_torch_port_cuda.py);
here every wrapper takes its plain version."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddnerf_tpu.kernels.fused_mlp import fused_mlp_forward as jax_fwd
from ddnerf_tpu.kernels.fused_mlp_bwd import fused_mlp_backward as jax_bwd
from ddnerf_tpu.models.mlp import DepthMipMLP as JaxDepthMLP
from ddnerf_tpu.models.mlp import MipMLP as JaxMLP
from ddnerf_tpu_torch.kernels import reference as ref
from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP
from ddnerf_tpu_torch.utils.weights import params_to_state_dict

# As tests/test_torch_port_backward.py: f32 differs by summation order only;
# bf16 cotangents can flip one rounding, which the dgrad chain carries on.
BWD_F32_TOL = 2e-4
BWD_BF16_NORM_REL_TOL = 2e-2
# The dirs weight gradient against the JAX per-sample branch, norm-relative:
# the same bf16 products summed in another f32 order (read 1.5e-8 / 1.7e-8,
# MipMLP / DepthMipMLP); rounding the per-ray sum instead reads 2.2e-3 /
# 2.3e-3 on these inputs.
DIRS_NORM_REL_TOL = 1e-5
RAYS_PER_BLOCK = 8
WIDTHS = [48, 96, 192, 320]  # 40 rows each: 8 rays of 5 samples


def _setup(depth_head, hidden, dtype, rays=8, k=5, seed=0):
    rng = np.random.default_rng(seed + hidden)
    n = rays * k
    ipe = rng.uniform(-1, 1, (n, 96)).astype(np.float32)
    dirs = rng.uniform(-1, 1, (rays, 27)).astype(np.float32)
    g = rng.standard_normal((n, 6 if depth_head else 4)).astype(np.float32)
    jdt = {"float32": None, "bfloat16": jnp.bfloat16}[dtype]
    jmod = (JaxDepthMLP if depth_head else JaxMLP)(hidden_size=hidden,
                                                   dtype=jdt)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(ipe[None, :k]),
                       jnp.asarray(dirs[:1])[:, None, :])["params"]
    cdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    net = (DepthMipMLP if depth_head else MipMLP)(hidden_size=hidden,
                                                  compute_dtype=cdt)
    net.load_state_dict(params_to_state_dict(params))
    return params, net, ipe, dirs, g


def _jax_kw(depth_head, dtype, k):
    return dict(depth_head=depth_head, compute_dtype=getattr(jnp, dtype),
                interpret=True, samples_per_ray=k,
                rays_per_block=RAYS_PER_BLOCK)


@torch.no_grad()
def _port_stash(net, trunk, h, n):
    """The port's stash from the JAX split stash (x0..x6, padded to whole
    blocks): x7 and feat from x6, as the forward computes them."""
    cdt = net.compute_dtype
    x = torch.tensor(np.asarray(trunk, np.float32)[:, :n]).to(cdt)
    x7 = torch.relu(net._dense(x[6].float(), net.layers_xyz[-1]))
    feat = net._q(net._dense(x7, net.fc_feat))
    tail = torch.stack([x7, feat]).to(cdt)
    return ref.Stash(torch.cat([x, tail]),
                     torch.tensor(np.asarray(h, np.float32)[:n]).to(cdt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth_head", [False, True])
@pytest.mark.parametrize("hidden", WIDTHS)
def test_b2_plain_version_matches_pallas_at_width(hidden, depth_head, dtype):
    """JAX with per-ray dirs (``samples_per_ray=K``) rounds the per-ray
    cotangent sum once: the port's ``per_ray_dirs=True``."""
    params, net, ipe, dirs, g = _setup(depth_head, hidden, dtype)
    kw = _jax_kw(depth_head, dtype, 5)
    _, acts = jax_fwd(params, jnp.asarray(ipe), jnp.asarray(dirs),
                      stash=True, split_h_stash=True, **kw)
    want = {name: np.asarray(v, np.float32) for name, v in
            params_to_state_dict(jax_bwd(
                params, jnp.asarray(ipe), jnp.asarray(dirs), jnp.asarray(g),
                acts=acts, **kw)).items()}
    stash = _port_stash(net, acts[0], acts[1], ipe.shape[0])
    got = ref.fused_mlp_backward_reference(
        net, torch.tensor(ipe), torch.tensor(dirs), torch.tensor(g), 5, stash,
        per_ray_dirs=True)
    assert list(got) == [name for name, _ in net.named_parameters()]
    for name, p in net.named_parameters():
        assert got[name].shape == p.shape
        w = torch.tensor(want[name])
        if dtype == "float32":
            np.testing.assert_allclose(got[name].numpy(), want[name],
                                       rtol=BWD_F32_TOL, atol=BWD_F32_TOL,
                                       err_msg=name)
        else:
            rel = ((got[name] - w).norm() / w.norm().clamp_min(1e-30)).item()
            assert rel <= BWD_BF16_NORM_REL_TOL, (name, rel)


@pytest.mark.parametrize("depth_head", [False, True])
def test_default_dirs_gradient_matches_jax_per_sample_backward(depth_head):
    """The JAX ``fused_mlp_backward`` in interpret mode with per-sample dirs
    (``samples_per_ray=0``, each ray's dirs repeated on its rows; the
    branch every JAX run takes, ``kernel_per_ray_dirs: false``) fed its own
    stash, against the port's plain B2 with the default switch fed the same
    stash: the dirs weight gradient to summation order, every other
    gradient to the bf16 tolerance.  The per-ray rounding misses the dirs
    gradient's tolerance by two orders of magnitude."""
    rays, k = 8, 5
    params, net, ipe, dirs, g = _setup(depth_head, 32, "bfloat16",
                                       rays=rays, k=k, seed=1)
    kw = _jax_kw(depth_head, "bfloat16", 0)
    per_row = np.repeat(dirs, k, axis=0)
    _, acts = jax_fwd(params, jnp.asarray(ipe), jnp.asarray(per_row),
                      stash=True, split_h_stash=True, **kw)
    want = params_to_state_dict(jax_bwd(params, jnp.asarray(ipe),
                                        jnp.asarray(per_row), jnp.asarray(g),
                                        acts=acts, **kw))
    stash = _port_stash(net, acts[0], acts[1], rays * k)
    args = (net, torch.tensor(ipe), torch.tensor(dirs), torch.tensor(g), k,
            stash)

    def rel(a, name, cols=slice(None)):
        w = torch.tensor(np.asarray(want[name], np.float32))[:, cols]
        return ((a[name][:, cols] - w).norm() / w.norm()).item()

    dirs_cols = slice(32, None)
    got = ref.fused_mlp_backward_reference(*args)
    assert rel(got, "layers_dir.0.weight", dirs_cols) <= DIRS_NORM_REL_TOL
    per_ray = ref.fused_mlp_backward_reference(*args, per_ray_dirs=True)
    assert rel(per_ray, "layers_dir.0.weight", dirs_cols) > \
        100 * DIRS_NORM_REL_TOL
    for name, p in net.named_parameters():
        w = torch.tensor(np.asarray(want[name], np.float32))
        r = ((got[name] - w).norm() / w.norm().clamp_min(1e-30)).item()
        assert r <= BWD_BF16_NORM_REL_TOL, (name, r)
