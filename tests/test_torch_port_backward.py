"""Port parity for the training kernels' plain versions: the stash forward
(B1s) and the explicit backward (B2) of ddnerf_tpu_torch against the JAX
package's Pallas kernels in interpret mode (``fused_mlp_forward(stash=True,
split_h_stash=True)`` and ``fused_mlp_backward`` with per-ray dirs, the
plain backward's ``per_ray_dirs=True``), with transplanted weights; and the
training ``autograd.Function`` on the CPU.

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
from ddnerf_tpu_torch.kernels import fused_mlp as fk
from ddnerf_tpu_torch.kernels import reference as ref
from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP
from ddnerf_tpu_torch.utils.weights import params_to_state_dict

# f32: as tests/test_fused_mlp_bwd.py:52 (summation order only).
F32_TOL = 2e-4
# bf16 operands and cotangents: an order change can flip one bf16 rounding
# of an activation or cotangent element (2^-8 relative), which then
# propagates down the dgrad chain; per gradient, ||port - jax|| / ||jax||.
BF16_NORM_REL_TOL = 2e-2
RAYS_PER_BLOCK = 8


def _setup(depth_head, rays, k, dtype, hidden=32, seed=0):
    rng = np.random.default_rng(seed)
    n = rays * k
    ipe = rng.uniform(-1, 1, (n, 96)).astype(np.float32)
    dirs = rng.uniform(-1, 1, (rays, 27)).astype(np.float32)
    jdt = {"float32": None, "bfloat16": jnp.bfloat16}[dtype]
    jmod = (JaxDepthMLP if depth_head else JaxMLP)(hidden_size=hidden,
                                                   dtype=jdt)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(ipe[None, :k]),
                       jnp.asarray(dirs[:1])[:, None, :])["params"]
    cdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    net = (DepthMipMLP if depth_head else MipMLP)(hidden_size=hidden,
                                                  compute_dtype=cdt)
    net.load_state_dict(params_to_state_dict(params))
    g = rng.standard_normal((n, net.out_dim)).astype(np.float32)
    return params, net, ipe, dirs, g


def _jax_stash_and_grads(params, ipe, dirs, g, k, depth_head, dtype):
    cdt = getattr(jnp, dtype)
    kw = dict(depth_head=depth_head, compute_dtype=cdt, interpret=True,
              samples_per_ray=k, rays_per_block=RAYS_PER_BLOCK)
    out, acts = jax_fwd(params, jnp.asarray(ipe), jnp.asarray(dirs),
                        stash=True, split_h_stash=True, **kw)
    grads = jax_bwd(params, jnp.asarray(ipe), jnp.asarray(dirs),
                    jnp.asarray(g), acts=acts, **kw)
    return out, acts, params_to_state_dict(grads)


def _to_torch(x, dtype):
    return torch.tensor(np.asarray(x, dtype=np.float32)).to(dtype)


@torch.no_grad()
def _stash_tail(net, x6):
    """x7 and feat from x6, as the forward computes them: the JAX split
    stash holds x0..x6 only, the port's stash also x7 and feat."""
    x7 = torch.relu(net._dense(x6.float(), net.layers_xyz[-1]))
    feat = net._q(net._dense(x7, net.fc_feat))
    return torch.stack([x7, feat]).to(net.compute_dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth_head", [False, True])
# 13 and 37 rays leave a ragged last block of RAYS_PER_BLOCK rays; at K = 33
# the rays also straddle the edges of the CUDA kernel's 128-row tiles.
@pytest.mark.parametrize("rays,k", [(8, 3), (13, 4), (37, 33)])
def test_plain_backward_matches_pallas_interpret(rays, k, depth_head, dtype):
    params, net, ipe, dirs, g = _setup(depth_head, rays, k, dtype)
    n = rays * k
    _, (trunk, h), want = _jax_stash_and_grads(params, ipe, dirs, g, k,
                                               depth_head, dtype)
    cdt = net.compute_dtype
    x = _to_torch(trunk, cdt)[:, :n]  # the JAX stash is padded to whole blocks
    stash = ref.Stash(torch.cat([x, _stash_tail(net, x[6])]),
                      _to_torch(h, cdt)[:n])
    # JAX with per-ray dirs rounds the per-ray cotangent sum once.
    got = ref.fused_mlp_backward_reference(
        net, torch.tensor(ipe), torch.tensor(dirs), torch.tensor(g), k, stash,
        per_ray_dirs=True)
    assert list(got) == [name for name, _ in net.named_parameters()]
    for name, p in net.named_parameters():
        assert got[name].shape == p.shape and got[name].dtype == torch.float32
        w = torch.tensor(np.asarray(want[name]))
        if dtype == "float32":
            np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                       rtol=F32_TOL, atol=F32_TOL,
                                       err_msg=name)
        else:
            rel = ((got[name] - w).norm() / w.norm().clamp_min(1e-30)).item()
            assert rel <= BF16_NORM_REL_TOL, (name, rel)


@pytest.mark.parametrize("depth_head", [False, True])
def test_dirs_gradient_rounds_the_per_ray_sum_once(depth_head):
    """With ``per_ray_dirs`` (``parallel.kernel_per_ray_dirs: true``),
    d layers_dir.0.weight[:, hid:] = bf16(sum_K g_h)^T dirs, computed here
    by hand: g_h is summed over the ray's K rows in float32 and rounded to
    bf16 once, after the sum (``_bwd_kernel``'s per-ray g_dproj).  Rounding
    each row first, the other place the rounding could sit (the default,
    tests/test_torch_port_widths.py), gives another result on these inputs,
    so a kernel that moved the rounding point would show."""
    gen = torch.Generator().manual_seed(6)
    hid, rays, k = 32, 11, 33
    net = (DepthMipMLP if depth_head else MipMLP)(
        hidden_size=hid, compute_dtype=torch.bfloat16, generator=gen)
    n = rays * k
    ipe = torch.rand(n, 96, generator=gen) * 2 - 1
    dirs = torch.rand(rays, 27, generator=gen) * 2 - 1
    g = torch.randn(n, net.out_dim, generator=gen)
    _, stash = ref.fused_mlp_stash_reference(net, ipe, dirs, k)
    got = ref.fused_mlp_backward_reference(net, ipe, dirs, g, k, stash,
                                           per_ray_dirs=True)

    def q(x):
        return x.to(torch.bfloat16).float()

    with torch.no_grad():
        g_h = q(g[:, 0:3]) @ q(net.fc_rgb.weight)
        if depth_head:
            g_h = g_h + q(g[:, 4:6]) @ q(net.fc_mu_sigma.weight)
        g_h = torch.where(stash.h.float() > 0, g_h, 0.0).reshape(rays, k, -1)
        want = q(g_h.sum(1)).T @ q(dirs)
        rounded_first = q(q(g_h).sum(1)).T @ q(dirs)
    d_dirs = got["layers_dir.0.weight"][:, hid:]
    assert d_dirs.shape == (net.dir_hidden, 27)
    assert torch.equal(d_dirs, want)
    assert not torch.equal(d_dirs, rounded_first)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("depth_head", [False, True])
def test_stash_reference_matches_pallas_interpret(depth_head, dtype, tol):
    """Outputs and the x0..x6 / h slabs of the split layout (bf16: one
    flipped rounding of a unit-size activation is 2^-8)."""
    params, net, ipe, dirs, g = _setup(depth_head, 13, 4, dtype)
    n = ipe.shape[0]
    out_j, (trunk, h), _ = _jax_stash_and_grads(params, ipe, dirs, g, 4,
                                                depth_head, dtype)
    with torch.no_grad():
        out, stash = fk.fused_mlp_forward(net, torch.tensor(ipe),
                                          torch.tensor(dirs), 4, stash=True)
    assert stash.trunk.shape == (ref.NUM_STASH, n, 32)
    assert stash.trunk.dtype == net.compute_dtype
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(stash.trunk[:7].float().numpy(),
                               np.asarray(trunk, np.float32)[:, :n],
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(stash.h.float().numpy(),
                               np.asarray(h, np.float32)[:n], rtol=tol,
                               atol=tol)
    # Slabs 7 and 8 hold x7 and feat, the values the backward reads.
    assert torch.equal(stash.trunk[7:], _stash_tail(net, stash.trunk[6]))


@pytest.mark.parametrize("depth_head", [False, True])
def test_train_apply_on_cpu_is_the_plain_backward(depth_head):
    """The autograd.Function: parameter gradients equal the plain backward
    on the plain stash, no input gradient, no kernel launch."""
    gen = torch.Generator().manual_seed(3)
    net = (DepthMipMLP if depth_head else MipMLP)(
        hidden_size=32, compute_dtype=torch.bfloat16, generator=gen)
    k, rays = 5, 6
    ipe = (torch.rand(rays * k, 96, generator=gen) * 2 - 1).requires_grad_()
    dirs = torch.rand(rays, 27, generator=gen).requires_grad_()
    g = torch.randn(rays * k, net.out_dim, generator=gen)
    before = dict(fk.LAUNCHES)
    out = fk.fused_mlp_train_apply(net, ipe, dirs, k)
    (out * g).sum().backward()
    assert fk.LAUNCHES == before
    assert ipe.grad is None and dirs.grad is None
    with torch.no_grad():
        want_out, stash = ref.fused_mlp_stash_reference(
            net, ipe.to(torch.bfloat16), dirs.to(torch.bfloat16), k)
    assert torch.equal(out.detach(), want_out)
    want = ref.fused_mlp_backward_reference(net, ipe.detach(), dirs.detach(),
                                            g, k, stash)
    for name, p in net.named_parameters():
        assert torch.equal(p.grad, want[name]), name


def test_f32_plain_backward_is_autograd_of_the_module():
    """At float32 compute the explicit backward and autograd through the
    module differentiate the same function."""
    gen = torch.Generator().manual_seed(4)
    net = DepthMipMLP(hidden_size=32, generator=gen)
    k, rays = 3, 4
    ipe = torch.rand(rays * k, 96, generator=gen)
    dirs = torch.rand(rays, 27, generator=gen)
    g = torch.randn(rays * k, 6, generator=gen)
    _, stash = ref.fused_mlp_stash_reference(net, ipe, dirs, k)
    got = ref.fused_mlp_backward_reference(net, ipe, dirs, g, k, stash)
    (ref.fused_mlp_reference(net, ipe, dirs, k) * g).sum().backward()
    for name, p in net.named_parameters():
        np.testing.assert_allclose(got[name].numpy(), p.grad.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("hidden", [64, 256, 96, 320])
@pytest.mark.parametrize("depth_head", [False, True])
def test_gradient_layout_round_trips(depth_head, hidden):
    """``unpack_grads`` reads the packed layout that the backward kernel
    writes its f32 gradients in (the packed weight layout, zero-padded to
    the kernel width at 96 and 320) back into parameter shapes: unpacking
    the packed weights gives the parameters (at bf16 compute, whose pack
    rounds the weights; tests/test_torch_port_f32.py holds the float32
    pack)."""
    gen = torch.Generator().manual_seed(5)
    net = (DepthMipMLP if depth_head else MipMLP)(
        hidden_size=hidden, compute_dtype=torch.bfloat16, generator=gen)
    kw = fk.pack_weights(net)
    back = fk.unpack_grads(net, kw, kw.w.float(), kw.b)
    assert list(back) == [name for name, _ in net.named_parameters()]
    for name, p in net.named_parameters():
        want = p.detach()
        if name.endswith("weight"):
            want = want.to(torch.bfloat16).float()
        assert torch.equal(back[name], want), name


@pytest.mark.parametrize("depth_head", [False, True])
def test_wrapper_parameter_list_is_named_parameters(depth_head):
    """The wrappers read the parameters off the network's layers instead of
    walking the module tree; names, order and tensors are
    ``named_parameters()``'s."""
    net = (DepthMipMLP if depth_head else MipMLP)(hidden_size=32)
    got, want = fk._named_params(net), list(net.named_parameters())
    assert [name for name, _ in got] == [name for name, _ in want]
    assert all(a is b for (_, a), (_, b) in zip(got, want))


def test_backward_wrapper_checks_its_inputs():
    net = MipMLP(hidden_size=32, generator=torch.Generator().manual_seed(0))
    ipe, dirs, g = torch.zeros(12, 96), torch.zeros(3, 27), torch.zeros(12, 4)
    _, stash = fk.fused_mlp_forward(net, ipe, dirs, 4, stash=True)
    with pytest.raises(ValueError, match="g must be"):
        fk.fused_mlp_backward(net, ipe, dirs, g[:, :3], 4, stash)
    with pytest.raises(ValueError, match="stash shapes"):
        fk.fused_mlp_backward(net, ipe, dirs, g, 4,
                              ref.Stash(stash.trunk[:7], stash.h))
    with pytest.raises(ValueError, match="whole rays"):
        fk.fused_mlp_backward(net, ipe[:11], dirs, g[:11], 4, stash)
    with pytest.raises(ValueError, match="no fused MLP kernel"):
        fk.fused_mlp_backward(net, ipe.to("meta"), dirs.to("meta"),
                              g.to("meta"), 4, stash)
