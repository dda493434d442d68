"""Port parity: the MLP modules and the fused-MLP kernel module of
ddnerf_tpu_torch against the JAX package — the flax modules, the Pallas
kernel in interpret mode and its jnp twin — with transplanted weights.

The CUDA kernel itself runs only on a GPU (tests/test_torch_port_cuda.py);
here the wrapper takes its plain version, and the kernel's packed weight
layout is checked by evaluating the kernel's arithmetic from the packed
buffers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddnerf_tpu.kernels.fused_mlp import _reference_apply
from ddnerf_tpu.kernels.fused_mlp import fused_mlp_forward as jax_fused
from ddnerf_tpu.models.mlp import DepthMipMLP as JaxDepthMLP
from ddnerf_tpu.models.mlp import MipMLP as JaxMLP
from ddnerf_tpu_torch.kernels import fused_mlp as fk
from ddnerf_tpu_torch.kernels.reference import fused_mlp_reference
from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP
from ddnerf_tpu_torch.utils.weights import params_to_state_dict

F32_TOL = 1e-4  # as tests/test_fused_mlp.py: f32, summation order only
BF16_TOL = 2e-2  # bf16 operands: an order change can flip one rounding


def _setup(depth_head, hidden=32, rays=5, k=6, dtype="float32", seed=0):
    rng = np.random.default_rng(seed)
    ipe = rng.uniform(-1, 1, (rays, k, 96)).astype(np.float32)
    dirs = rng.uniform(-1, 1, (rays, 27)).astype(np.float32)
    jdt = {"float32": None, "bfloat16": jnp.bfloat16}[dtype]
    jmod = (JaxDepthMLP if depth_head else JaxMLP)(hidden_size=hidden,
                                                   dtype=jdt)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(ipe),
                       jnp.asarray(dirs)[:, None, :])["params"]
    cdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    net = (DepthMipMLP if depth_head else MipMLP)(hidden_size=hidden,
                                                  compute_dtype=cdt)
    net.load_state_dict(params_to_state_dict(params))
    return jmod, params, net, ipe, dirs


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("depth_head", [False, True])
def test_module_matches_flax(depth_head, dtype, tol):
    jmod, params, net, ipe, dirs = _setup(depth_head, dtype=dtype)
    want = jmod.apply({"params": params}, jnp.asarray(ipe),
                      jnp.asarray(dirs)[:, None, :])
    with torch.no_grad():
        got = net(torch.tensor(ipe), torch.tensor(dirs))
    assert tuple(got.shape) == want.shape == (5, 6, 6 if depth_head else 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("depth_head", [False, True])
def test_kernel_plain_version_matches_pallas_interpret(depth_head, dtype, tol):
    """The wrapper on CPU tensors (the plain version) against the Pallas
    kernel in interpret mode, per-ray dirs (samples_per_ray=K)."""
    _, params, net, ipe, dirs = _setup(depth_head, rays=8, k=4, dtype=dtype)
    n = ipe.shape[0] * ipe.shape[1]
    want = jax_fused(
        params, jnp.asarray(ipe.reshape(n, 96)), jnp.asarray(dirs),
        depth_head=depth_head, compute_dtype=getattr(jnp, dtype),
        interpret=True, samples_per_ray=4, rays_per_block=8)
    before = dict(fk.LAUNCHES)
    with torch.no_grad():
        got = fk.fused_mlp_forward(net, torch.tensor(ipe.reshape(n, 96)),
                                   torch.tensor(dirs), samples_per_ray=4)
    assert fk.LAUNCHES == before  # the plain version is not a launch
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("depth_head", [False, True])
def test_reference_matches_jnp_twin(depth_head):
    _, params, net, ipe, dirs = _setup(depth_head, rays=3, k=7)
    n = 21
    want = _reference_apply(params, jnp.asarray(ipe.reshape(n, 96)),
                            jnp.asarray(np.repeat(dirs, 7, axis=0)),
                            depth_head)
    with torch.no_grad():
        got = fused_mlp_reference(net, torch.tensor(ipe.reshape(n, 96)),
                                  torch.tensor(dirs), 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def _kernel_arithmetic(net, ipe, dirs, k):
    """The CUDA kernel's computation, read from the packed buffers exactly
    as csrc/fused_mlp_fwd.cu indexes them."""
    kw = fk.pack_weights(net)
    h, dh = net.hidden_size, net.dir_hidden
    w, b = kw.w.float(), kw.b

    def mat(i, rows, cols):
        return w[kw.w_off[i]:kw.w_off[i] + rows * cols].reshape(rows, cols)

    def bf(t):
        return t.to(torch.bfloat16).float()

    ipe, dirs = bf(ipe), bf(dirs)
    b_trunk = b[kw.b_off[0]:kw.b_off[0] + 8 * h].reshape(8, h)
    x = ipe
    for layer in range(8):
        kin = 96 if layer == 0 else (96 + h if layer == 5 else h)
        inp = torch.cat([ipe, x], -1) if layer == 5 else x
        x = bf(torch.relu(inp @ mat(layer, h, kin).T + b_trunk[layer]))
    feat = bf(x @ mat(8, h, h).T + b[kw.b_off[1]:kw.b_off[1] + h])
    b_dir = b[kw.b_off[2]:kw.b_off[2] + fk.DIR_LAYER_ROWS]
    acc = feat @ mat(9, fk.DIR_LAYER_ROWS, h).T
    dproj = dirs @ mat(11, dh, fk.DIRS_LD)[:, :27].T
    ray = torch.arange(ipe.shape[0]) // k
    hh = bf(torch.relu(acc[:, :dh] + dproj[ray] + b_dir[:dh]))
    alpha = acc[:, dh] + b_dir[dh]
    heads = (hh @ mat(10, fk.HEAD_ROWS, dh).T
             + b[kw.b_off[3]:kw.b_off[3] + fk.HEAD_ROWS])
    cols = [heads[:, :3], alpha[:, None]]
    if net.depth_head:
        cols.append(heads[:, 3:5])
    return torch.cat(cols, -1)


@pytest.mark.parametrize("hidden", [64, 256])
@pytest.mark.parametrize("depth_head", [False, True])
def test_packed_layout_reproduces_the_plain_version(depth_head, hidden):
    gen = torch.Generator().manual_seed(1)
    net = (DepthMipMLP if depth_head else MipMLP)(
        hidden_size=hidden, compute_dtype=torch.bfloat16, generator=gen)
    k, rays = 7, 5
    ipe = torch.rand(rays * k, 96, generator=gen) * 2 - 1
    dirs = torch.rand(rays, 27, generator=gen) * 2 - 1
    with torch.no_grad():
        got = _kernel_arithmetic(net, ipe, dirs, k)
        want = fused_mlp_reference(net, ipe, dirs, k)
    # Same roundings, same products; only the summation order differs.
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    kw = fk.pack_weights(net)
    assert kw.w.dtype == torch.bfloat16 and kw.b.dtype == torch.float32
    assert all(o % 8 == 0 for o in kw.w_off)  # 16-byte aligned matrices


def test_pack_cache_follows_parameter_updates():
    net = MipMLP(hidden_size=64, compute_dtype=torch.bfloat16,
                 generator=torch.Generator().manual_seed(0))
    first = fk._packed(net)
    assert fk._packed(net) is first
    with torch.no_grad():
        net.fc_rgb.bias.add_(1.0)
    second = fk._packed(net)
    assert second is not first
    assert torch.equal(second.b[second.b_off[3]:second.b_off[3] + 3],
                       net.fc_rgb.bias)


def test_wrapper_checks_its_inputs_and_never_falls_back():
    net = MipMLP(hidden_size=32, generator=torch.Generator().manual_seed(0))
    ipe, dirs = torch.zeros(12, 96), torch.zeros(3, 27)
    with pytest.raises(ValueError, match="whole rays"):
        fk.fused_mlp_forward(net, ipe[:11], dirs, 4)
    with pytest.raises(ValueError, match="one row per"):
        fk.fused_mlp_forward(net, ipe, torch.zeros(12, 27), 4)
    with pytest.raises(ValueError, match="ipe must be"):
        fk.fused_mlp_forward(net, torch.zeros(12, 95), dirs, 4)
    # Off the CPU the wrapper launches its kernel or raises.
    with pytest.raises(ValueError, match="no fused MLP kernel"):
        fk.fused_mlp_forward(net, ipe.to("meta"), dirs.to("meta"), 4)
    # The kernels take float32 and bfloat16 networks, nothing else.
    fk._check_net(net, torch.device("cpu"))
    net.compute_dtype = torch.float16
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fk._check_net(net, torch.device("cpu"))
