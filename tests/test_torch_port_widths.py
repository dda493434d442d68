"""The fused-MLP kernels' range of network widths and the rounding point of
the dirs weight gradient, on the CPU.

* ``parallel.kernel_per_ray_dirs`` (default false): the plain backward
  (B2's plain version) rounds each sample's dir-layer cotangent before the
  sum over the ray, as the JAX package's per-sample branch; true rounds the
  per-ray sum once.  Held by hand and through the pipeline (against the
  JAX kernel: tests/test_torch_port_widths_backward.py).
* Widths: the plain versions of B1, B1s and B3 against the JAX Pallas
  kernels in interpret mode at widths that are none of the kernels' own
  (48, 96, 320) and one new one (192) (B2: the other file); the zero
  padding that runs such a width at the next kernel width
  (``pack_weights`` / ``unpack_grads``) changes neither the plain forward
  nor the plain gradients.

The CUDA kernels themselves run only on a GPU (tests/test_torch_port_cuda.py);
here every wrapper takes its plain version."""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddnerf_tpu.kernels.fused_mlp import fused_enc_mlp_forward as jax_enc
from ddnerf_tpu.kernels.fused_mlp import fused_mlp_forward as jax_fwd
from ddnerf_tpu.models.mlp import DepthMipMLP as JaxDepthMLP
from ddnerf_tpu.models.mlp import MipMLP as JaxMLP
from ddnerf_tpu_torch.kernels import fused_mlp as fk
from ddnerf_tpu_torch.kernels import reference as ref
from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP
from ddnerf_tpu_torch.utils.weights import params_to_state_dict

# The tolerances of tests/test_torch_port_{mlp,backward,enc}.py: f32 differs
# by summation order only; bf16 operands and cotangents can flip one
# rounding (2^-8 relative), which the dgrad chain carries on.
FWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
STASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BWD_BF16_NORM_REL_TOL = 2e-2
# A network and the same network zero-padded to the next kernel width: the
# padding adds exact zeros to f32 sums (float32 compute).  In bf16 the CPU's
# matmul sums a K = w and a K = H product in other orders, which can flip a
# rounding of an activation (read at width 320: 10 of 115,200 stash
# elements), so there the bf16 tolerances above hold.
PAD_TOL = {"float32": 1e-6, "bfloat16": 2e-2}
RAYS_PER_BLOCK = 8
WIDTHS = [48, 96, 192, 320]  # 40 rows each: 8 rays of 5 samples


def q(x):
    return x.to(torch.bfloat16).float()


def _setup(depth_head, hidden, dtype, rays=8, k=5, seed=0):
    rng = np.random.default_rng(seed + hidden)
    n = rays * k
    ipe = rng.uniform(-1, 1, (n, 96)).astype(np.float32)
    dirs = rng.uniform(-1, 1, (rays, 27)).astype(np.float32)
    means = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    covs = rng.uniform(1e-5, 0.3, (n, 3)).astype(np.float32)
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
    return params, net, ipe, dirs, means, covs, g


def _jax_kw(depth_head, dtype, k):
    return dict(depth_head=depth_head, compute_dtype=getattr(jnp, dtype),
                interpret=True, samples_per_ray=k,
                rays_per_block=RAYS_PER_BLOCK)


@functools.lru_cache(maxsize=None)
def _jax_results(depth_head, hidden, dtype, k=5):
    """The JAX forward kernels in interpret mode on one case's inputs: B1,
    B1s (outputs, x0..x6, h) and B3."""
    params, _, ipe, dirs, means, covs, _ = _setup(depth_head, hidden, dtype,
                                                  k=k)
    kw = _jax_kw(depth_head, dtype, k)
    b1 = jax_fwd(params, jnp.asarray(ipe), jnp.asarray(dirs), **kw)
    out, acts = jax_fwd(params, jnp.asarray(ipe), jnp.asarray(dirs),
                        stash=True, split_h_stash=True, **kw)
    b3 = jax_enc(params, jnp.asarray(means), jnp.asarray(covs),
                 jnp.asarray(dirs), **kw)
    to_np = functools.partial(np.asarray, dtype=np.float32)
    return (to_np(b1), to_np(out), to_np(acts[0]), to_np(acts[1]),
            to_np(b3))


@torch.no_grad()
def _stash_tail(net, x6):
    """x7 and feat from x6, as the forward computes them: the JAX split
    stash holds x0..x6 only, the port's stash also x7 and feat."""
    x7 = torch.relu(net._dense(x6.float(), net.layers_xyz[-1]))
    feat = net._q(net._dense(x7, net.fc_feat))
    return torch.stack([x7, feat]).to(net.compute_dtype)


def _port_stash(net, trunk, h, n):
    """The port's stash from the JAX split stash (padded to whole blocks)."""
    cdt = net.compute_dtype
    x = torch.tensor(trunk[:, :n]).to(cdt)
    return ref.Stash(torch.cat([x, _stash_tail(net, x[6])]),
                     torch.tensor(h[:n]).to(cdt))


# ------------------------------------------------------------- widths


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth_head", [False, True])
@pytest.mark.parametrize("hidden", WIDTHS)
def test_b1_and_b3_plain_versions_match_pallas_at_width(hidden, depth_head,
                                                        dtype):
    _, net, ipe, dirs, means, covs, _ = _setup(depth_head, hidden, dtype)
    b1, _, _, _, b3 = _jax_results(depth_head, hidden, dtype)
    before = dict(fk.LAUNCHES)
    with torch.no_grad():
        got = fk.fused_mlp_forward(net, torch.tensor(ipe), torch.tensor(dirs),
                                   5)
        got3 = fk.fused_enc_mlp_forward(net, torch.tensor(means),
                                        torch.tensor(covs),
                                        torch.tensor(dirs), 5)
    assert fk.LAUNCHES == before
    tol = FWD_TOL[dtype]
    np.testing.assert_allclose(got.numpy(), b1, rtol=tol, atol=tol)
    np.testing.assert_allclose(got3.numpy(), b3, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth_head", [False, True])
@pytest.mark.parametrize("hidden", WIDTHS)
def test_b1s_plain_version_matches_pallas_at_width(hidden, depth_head, dtype):
    _, net, ipe, dirs, _, _, _ = _setup(depth_head, hidden, dtype)
    _, out_j, trunk, h, _ = _jax_results(depth_head, hidden, dtype)
    n = ipe.shape[0]
    with torch.no_grad():
        out, stash = fk.fused_mlp_forward(net, torch.tensor(ipe),
                                          torch.tensor(dirs), 5, stash=True)
    assert stash.trunk.shape == (ref.NUM_STASH, n, hidden)
    tol = STASH_TOL[dtype]
    np.testing.assert_allclose(out.numpy(), out_j, rtol=tol, atol=tol)
    np.testing.assert_allclose(stash.trunk[:7].float().numpy(),
                               trunk[:, :n], rtol=tol, atol=tol)
    np.testing.assert_allclose(stash.h.float().numpy(), h[:n], rtol=tol,
                               atol=tol)
    assert torch.equal(stash.trunk[7:], _stash_tail(net, stash.trunk[6]))


def _pack_f32(net):
    """``pack_weights(net)`` with the weights kept in float32: the packing
    rounds them to bf16, so pack three bf16 parts of each weight (its
    rounding, the rounding of the rest, the rest), whose float32 sum is the
    weight exactly."""
    holder = copy.deepcopy(net)
    rest = {name: p.detach().clone() for name, p in net.named_parameters()}
    w = 0
    with torch.no_grad():
        for _ in range(3):
            for name, p in holder.named_parameters():
                p.copy_(rest[name].bfloat16().float())
                rest[name] -= p
            w = w + fk.pack_weights(holder).w.float()
    kw = fk.pack_weights(net)
    return kw._replace(w=w)


def _padded_copy(net):
    """A network of the next kernel width holding ``net``'s packed weights
    (the kernels' zero-padded layout), as ``unpack_grads`` reads them."""
    width = fk.kernel_width(net.hidden_size)
    wide = type(net)(hidden_size=width, compute_dtype=net.compute_dtype)
    kw = _pack_f32(net)
    wide.load_state_dict(fk.unpack_grads(wide, kw, kw.w, kw.b))
    return wide


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth_head", [False, True])
@pytest.mark.parametrize("hidden", [48, 96, 200, 320])
def test_zero_padding_to_the_kernel_width_is_exact(hidden, depth_head, dtype):
    """What the card's kernels rely on: a network and its copy zero-padded
    by ``pack_weights`` give the same plain outputs and stash (the padded
    columns zero), and the same plain B2 gradients once ``unpack_grads``
    cuts the padded ones back to the network's width."""
    cdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tol = PAD_TOL[dtype]
    gen = torch.Generator().manual_seed(hidden)
    net = (DepthMipMLP if depth_head else MipMLP)(
        hidden_size=hidden, compute_dtype=cdt, generator=gen)
    wide = _padded_copy(net)
    assert wide.hidden_size == fk.kernel_width(hidden) > hidden
    rays, k = 8, 5
    ipe = torch.rand(rays * k, 96, generator=gen) * 2 - 1
    dirs = torch.rand(rays, 27, generator=gen) * 2 - 1
    g = torch.randn(rays * k, net.out_dim, generator=gen)
    out, stash = ref.fused_mlp_stash_reference(net, ipe, dirs, k)
    out_w, stash_w = ref.fused_mlp_stash_reference(wide, ipe, dirs, k)
    assert not stash_w.trunk[..., hidden:].any()
    for a, b in ((out_w, out), (stash_w.trunk[..., :hidden], stash.trunk),
                 (stash_w.h, stash.h)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=tol, atol=tol)
    for per_ray in (False, True):
        want = ref.fused_mlp_backward_reference(net, ipe, dirs, g, k, stash,
                                                per_ray)
        grads_w = ref.fused_mlp_backward_reference(wide, ipe, dirs, g, k,
                                                   stash_w, per_ray)
        holder = type(wide)(hidden_size=wide.hidden_size)
        holder.load_state_dict(grads_w)
        packed = _pack_f32(holder)
        got = fk.unpack_grads(net, fk.pack_weights(net), packed.w, packed.b)
        # The plain backward also reads the padded stash itself.
        from_wide_stash = ref.fused_mlp_backward_reference(
            net, ipe, dirs, g, k, stash_w, per_ray)
        for name, p in net.named_parameters():
            assert got[name].shape == p.shape, name
            for have in (got[name], from_wide_stash[name]):
                if dtype == "float32":
                    np.testing.assert_allclose(
                        have.numpy(), want[name].numpy(), rtol=tol, atol=tol,
                        err_msg=f"{name} per_ray={per_ray}")
                else:
                    rel = ((have - want[name]).norm()
                           / want[name].norm().clamp_min(1e-30)).item()
                    assert rel <= tol, (name, per_ray, rel)


def test_kernel_widths_and_the_limit():
    assert [fk.kernel_width(w) for w in (1, 64, 65, 96, 128, 129, 192, 193,
                                         256, 257, 320, 384, 385, 512)] == \
        [64, 64, 128, 128, 128, 192, 192, 256, 256, 384, 384, 384, 512, 512]
    # Past the fused plans' 512 the wide plan: the next multiple of 64.
    assert fk.kernel_width(513) == 576 and fk.is_wide(513)
    assert not fk.is_wide(512)
    net = MipMLP(hidden_size=96)
    assert fk.stash_width(net, "cpu") == 96
    assert fk.stash_width(net, "cuda") == 128
    # What a launch checks first: every width passes, 513 included; a
    # network the JAX kernel cannot take either raises.
    cpu = torch.device("cpu")
    for width in (1, 300, 512, 513):
        fk._check_net(MipMLP(hidden_size=width, compute_dtype=torch.bfloat16),
                      cpu)
    with pytest.raises(ValueError, match="128-wide dir branch"):
        fk._check_net(MipMLP(hidden_size=96, dir_hidden=64,
                             compute_dtype=torch.bfloat16), cpu)


@pytest.mark.parametrize("hidden", [96, 320])
def test_packed_layout_is_the_kernel_widths(hidden):
    """The packed buffers of a padded network have the sizes of the kernel
    width's: the kernels read them with that width's tensor maps."""
    net = DepthMipMLP(hidden_size=hidden,
                      generator=torch.Generator().manual_seed(0))
    wide = DepthMipMLP(hidden_size=fk.kernel_width(hidden))
    got, want = fk.pack_weights(net), fk.pack_weights(wide)
    assert got.w_off == want.w_off and got.b_off == want.b_off
    assert got.w.shape == want.w.shape and got.b.shape == want.b.shape


# ------------------------------------------- the dirs gradient's rounding


def _dirs_case(depth_head, hid=32, rays=11, k=33, seed=6):
    gen = torch.Generator().manual_seed(seed)
    net = (DepthMipMLP if depth_head else MipMLP)(
        hidden_size=hid, compute_dtype=torch.bfloat16, generator=gen)
    n = rays * k
    ipe = torch.rand(n, 96, generator=gen) * 2 - 1
    dirs = torch.rand(rays, 27, generator=gen) * 2 - 1
    g = torch.randn(n, net.out_dim, generator=gen)
    _, stash = ref.fused_mlp_stash_reference(net, ipe, dirs, k)
    with torch.no_grad():
        g_h = q(g[:, 0:3]) @ q(net.fc_rgb.weight)
        if depth_head:
            g_h = g_h + q(g[:, 4:6]) @ q(net.fc_mu_sigma.weight)
        g_h = torch.where(stash.h.float() > 0, g_h, 0.0).reshape(rays, k, -1)
    return net, ipe, dirs, g, k, stash, g_h


@pytest.mark.parametrize("depth_head", [False, True])
def test_dirs_gradient_rounds_each_sample_by_default(depth_head):
    """d layers_dir.0.weight[:, hid:] = (sum_K bf16(g_h))^T dirs: each
    sample's cotangent rounded to bf16, the sum over the ray's K rows and
    the product in float32, as the JAX package's default per-sample branch
    (``accum(d_wd_dirs, _mm_t(dirs, g_h_c))``).  Rounding the per-ray sum
    instead gives another result on these inputs."""
    net, ipe, dirs, g, k, stash, g_h = _dirs_case(depth_head)
    want = q(g_h).sum(1).T @ q(dirs)
    per_ray = q(g_h.sum(1)).T @ q(dirs)
    for got in (ref.fused_mlp_backward_reference(net, ipe, dirs, g, k, stash),
                fk.fused_mlp_backward(net, ipe, dirs, g, k, stash)):
        d_dirs = got["layers_dir.0.weight"][:, 32:]
        assert torch.equal(d_dirs, want)
        assert not torch.equal(d_dirs, per_ray)


@pytest.mark.parametrize("depth_head", [False, True])
def test_dirs_switch_moves_only_the_dirs_gradient(depth_head):
    """``per_ray_dirs`` changes the dirs columns of the dir layer's weight
    gradient and no other gradient, through the wrapper and through the
    training ``autograd.Function``."""
    net, ipe, dirs, g, k, stash, _ = _dirs_case(depth_head, rays=6, k=9)
    got = {}
    for per_ray in (False, True):
        grads = fk.fused_mlp_backward(net, ipe, dirs, g, k, stash, per_ray)
        net.zero_grad()
        out = fk.fused_mlp_train_apply(net, ipe, dirs, k, per_ray)
        (out * g).sum().backward()
        for name, p in net.named_parameters():
            assert torch.equal(p.grad, grads[name]), (name, per_ray)
        got[per_ray] = grads
    for name in got[False]:
        if name == "layers_dir.0.weight":
            assert torch.equal(got[False][name][:, :32], got[True][name][:, :32])
            assert not torch.equal(got[False][name], got[True][name])
        else:
            assert torch.equal(got[False][name], got[True][name]), name


@pytest.mark.parametrize("per_ray", [False, True])
def test_pipeline_passes_the_dirs_switch_to_the_backward(per_ray,
                                                         monkeypatch):
    """A training loss through ``pallas_mlp: auto`` hands
    ``parallel.kernel_per_ray_dirs`` to every backward call."""
    from ddnerf_tpu_torch.config import Config
    from ddnerf_tpu_torch.models.nerf import NerfPipeline, RayBatch
    from ddnerf_tpu_torch.train.step import compute_loss, schedule_values

    cfg = Config.from_dict({
        "nerf": {"type": "DDNerfModel", "coarse_hidden_size": 24,
                 "fine_hidden_size": 40,
                 "train": {"num_coarse": 4, "num_fine": 4,
                           "num_random_rays": 8, "perturb": False,
                           "radiance_field_noise_std": 0.0}},
        "parallel": {"compute_dtype": "bfloat16", "pallas_mlp": "auto",
                     "kernel_per_ray_dirs": per_ray},
    }).resolved()
    seen = []
    backward = fk.fused_mlp_backward

    def spy(*args, **kwargs):
        seen.append((args[0].hidden_size, args[6]))
        return backward(*args, **kwargs)

    monkeypatch.setattr(fk, "fused_mlp_backward", spy)
    pipe = NerfPipeline(cfg, "cpu", seed=0)
    rng = torch.Generator().manual_seed(0)
    rd = torch.randn(8, 3, generator=rng)
    rays = RayBatch.create(torch.randn(8, 3, generator=rng) * 0.3,
                           rd / rd.norm(dim=-1, keepdim=True),
                           torch.full((8, 1), 1e-3), 2.0, 6.0)
    loss, _ = compute_loss(cfg, pipe, rays, torch.rand(8, 3, generator=rng),
                           schedule_values(cfg, 0))
    loss.backward()
    assert sorted(seen) == [(24, per_ray), (40, per_ray)]
