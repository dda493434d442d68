"""Network widths above 512, which the port's kernels run through the wide
plan (``csrc/fused_mlp_wide.cu``), on the CPU.

* The plain versions of B1, B1s, B3 and B2 at widths 600 and 1024 against
  the JAX Pallas kernels in interpret mode at the same widths (DepthMipMLP,
  float32 and bfloat16; the tolerances of tests/test_torch_port_widths.py
  and tests/test_torch_port_widths_backward.py);
* ``kernel_width`` and ``pack_weights`` above 512: the wide plan's width
  (a multiple of 64) and its padded layout;
* ``utils/weights.py`` carrying a 1024-wide JAX network across;
* two co-trained DDNeRF steps at coarse 600 / fine 1024 against the JAX
  package (losses 1e-4, gradients rtol 5e-3).

The CUDA kernels themselves run only on a GPU (tests/test_torch_port_cuda.py);
here every wrapper takes its plain version."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddnerf_tpu.config import Config as JaxConfig
from ddnerf_tpu.kernels.fused_mlp import fused_enc_mlp_forward as jax_enc
from ddnerf_tpu.kernels.fused_mlp import fused_mlp_forward as jax_fwd
from ddnerf_tpu.kernels.fused_mlp_bwd import fused_mlp_backward as jax_bwd
from ddnerf_tpu.models.mlp import DepthMipMLP as JaxDepthMLP
from ddnerf_tpu.models.nerf import NerfPipeline as JaxPipeline
from ddnerf_tpu.models.nerf import RayBatch as JaxRays
from ddnerf_tpu.train.state import create_train_state
from ddnerf_tpu.train.step import compute_loss as jax_compute_loss
from ddnerf_tpu.train.step import schedule_values as jax_schedule_values
from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.kernels import fused_mlp as fk
from ddnerf_tpu_torch.kernels import reference as ref
from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP
from ddnerf_tpu_torch.models.nerf import NerfPipeline, RayBatch
from ddnerf_tpu_torch.train.step import compute_loss, schedule_values
from ddnerf_tpu_torch.utils.weights import _torch_name, params_to_state_dict

# tests/test_torch_port_widths.py's and _widths_backward.py's tolerances:
# f32 differs by summation order only; bf16 operands and cotangents can
# flip one rounding (2^-8 relative), which the dgrad chain carries on.
FWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
STASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BWD_F32_TOL = 2e-4
BWD_BF16_NORM_REL_TOL = 2e-2
RAYS, K, RAYS_PER_BLOCK = 4, 8, 4  # 32 rows: one JAX block
WIDTHS = [600, 1024]


def _setup(hidden, dtype, seed=0):
    rng = np.random.default_rng(seed + hidden)
    n = RAYS * K
    ipe = rng.uniform(-1, 1, (n, 96)).astype(np.float32)
    dirs = rng.uniform(-1, 1, (RAYS, 27)).astype(np.float32)
    means = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    covs = rng.uniform(1e-5, 0.3, (n, 3)).astype(np.float32)
    g = rng.standard_normal((n, 6)).astype(np.float32)
    jdt = {"float32": None, "bfloat16": jnp.bfloat16}[dtype]
    jmod = JaxDepthMLP(hidden_size=hidden, dtype=jdt)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(ipe[None, :K]),
                       jnp.asarray(dirs[:1])[:, None, :])["params"]
    cdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    net = DepthMipMLP(hidden_size=hidden, compute_dtype=cdt)
    net.load_state_dict(params_to_state_dict(params))
    return params, net, ipe, dirs, means, covs, g


@functools.lru_cache(maxsize=None)
def _jax_results(hidden, dtype):
    """The JAX kernels in interpret mode on one case's inputs: B1, B1s
    (outputs, x0..x6, h), B3 and B2 (per-ray dirs, the port's
    ``per_ray_dirs=True``)."""
    params, _, ipe, dirs, means, covs, g = _setup(hidden, dtype)
    kw = dict(depth_head=True, compute_dtype=getattr(jnp, dtype),
              interpret=True, samples_per_ray=K, rays_per_block=RAYS_PER_BLOCK)
    args = (jnp.asarray(ipe), jnp.asarray(dirs))
    b1 = jax_fwd(params, *args, **kw)
    out, acts = jax_fwd(params, *args, stash=True, split_h_stash=True, **kw)
    b3 = jax_enc(params, jnp.asarray(means), jnp.asarray(covs),
                 jnp.asarray(dirs), **kw)
    grads = jax_bwd(params, *args, jnp.asarray(g), acts=acts, **kw)
    to_np = functools.partial(np.asarray, dtype=np.float32)
    return (to_np(b1), to_np(out), to_np(acts[0]), to_np(acts[1]),
            to_np(b3), {name: to_np(v) for name, v in
                        params_to_state_dict(grads).items()})


@torch.no_grad()
def _port_stash(net, trunk, h, n):
    """The port's stash from the JAX split stash (x0..x6): x7 and feat
    from x6, as the forward computes them."""
    cdt = net.compute_dtype
    x = torch.tensor(trunk[:, :n]).to(cdt)
    x7 = torch.relu(net._dense(x[6].float(), net.layers_xyz[-1]))
    feat = net._q(net._dense(x7, net.fc_feat))
    return ref.Stash(torch.cat([x, torch.stack([x7, feat]).to(cdt)]),
                     torch.tensor(h[:n]).to(cdt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", WIDTHS)
def test_b1_and_b3_plain_versions_match_pallas_wide(hidden, dtype):
    _, net, ipe, dirs, means, covs, _ = _setup(hidden, dtype)
    b1, _, _, _, b3, _ = _jax_results(hidden, dtype)
    before = dict(fk.LAUNCHES)
    with torch.no_grad():
        got = fk.fused_mlp_forward(net, torch.tensor(ipe), torch.tensor(dirs),
                                   K)
        got3 = fk.fused_enc_mlp_forward(net, torch.tensor(means),
                                        torch.tensor(covs),
                                        torch.tensor(dirs), K)
    assert fk.LAUNCHES == before
    tol = FWD_TOL[dtype]
    np.testing.assert_allclose(got.numpy(), b1, rtol=tol, atol=tol)
    np.testing.assert_allclose(got3.numpy(), b3, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", WIDTHS)
def test_b1s_plain_version_matches_pallas_wide(hidden, dtype):
    _, net, ipe, dirs, _, _, _ = _setup(hidden, dtype)
    _, out_j, trunk, h, _, _ = _jax_results(hidden, dtype)
    n = ipe.shape[0]
    with torch.no_grad():
        out, stash = fk.fused_mlp_forward(net, torch.tensor(ipe),
                                          torch.tensor(dirs), K, stash=True)
    assert stash.trunk.shape == (ref.NUM_STASH, n, hidden)
    tol = STASH_TOL[dtype]
    np.testing.assert_allclose(out.numpy(), out_j, rtol=tol, atol=tol)
    np.testing.assert_allclose(stash.trunk[:7].float().numpy(),
                               trunk[:, :n], rtol=tol, atol=tol)
    np.testing.assert_allclose(stash.h.float().numpy(), h[:n], rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", WIDTHS)
def test_b2_plain_version_matches_pallas_wide(hidden, dtype):
    """B2's plain version fed the JAX forward's stash, per-ray dirs (JAX
    with ``samples_per_ray=K`` rounds the per-ray cotangent sum once)."""
    _, net, ipe, dirs, _, _, g = _setup(hidden, dtype)
    _, _, trunk, h, _, want = _jax_results(hidden, dtype)
    n = ipe.shape[0]
    stash = _port_stash(net, trunk, h, n)
    got = fk.fused_mlp_backward(net, torch.tensor(ipe), torch.tensor(dirs),
                                torch.tensor(g), K, stash, per_ray_dirs=True)
    assert list(got) == [name for name, _ in net.named_parameters()]
    for name, p in net.named_parameters():
        assert got[name].shape == p.shape
        if dtype == "float32":
            np.testing.assert_allclose(got[name].numpy(), want[name],
                                       rtol=BWD_F32_TOL, atol=BWD_F32_TOL,
                                       err_msg=name)
        else:
            w = torch.tensor(want[name])
            rel = ((got[name] - w).norm() / w.norm().clamp_min(1e-30)).item()
            assert rel <= BWD_BF16_NORM_REL_TOL, (name, rel)


def test_kernel_widths_above_512():
    """Above 512 the wide plan's width: the next multiple of 64, with no
    upper limit; what a launch checks first accepts every width."""
    assert [fk.kernel_width(w) for w in (513, 576, 577, 600, 768, 1000,
                                         1024, 4000)] == \
        [576, 576, 640, 640, 768, 1024, 1024, 4032]
    assert not fk.is_wide(512) and fk.is_wide(513)
    assert fk.stash_width(MipMLP(hidden_size=600), "cuda") == 640
    assert fk.stash_width(MipMLP(hidden_size=600), "cpu") == 600
    cpu = torch.device("cpu")
    for width in (513, 600, 1024, 2048):
        fk._check_net(MipMLP(hidden_size=width, compute_dtype=torch.bfloat16),
                      cpu)
    with pytest.raises(ValueError, match="positive"):
        fk.kernel_width(0)


@pytest.mark.parametrize("opts, want", [
    ((), {"fused_mlp_fwd": 2}),
    (("nerf.coarse_hidden_size", "600", "nerf.fine_hidden_size", "1024"),
     {"wide_mlp_fwd": 2}),
    (("nerf.coarse_hidden_size", "256", "nerf.fine_hidden_size", "1024"),
     {"fused_mlp_fwd": 1, "wide_mlp_fwd": 1}),
    (("nerf.coarse_hidden_size", "1024", "nerf.fine_hidden_size", "256",
      "parallel.compute_dtype", "float32"),
     {"wide_mlp_fwd_f32": 1, "fused_mlp_fwd_f32": 1}),
    (("nerf.type", "GeneralMipNerfModel", "nerf.coarse_hidden_size", "600",
      "nerf.fine_hidden_size", "256"), {"wide_mlp_fwd": 2}),
])
def test_card_run_expects_each_networks_plan(opts, want):
    """The launches ``chip_smoke.py`` expects of a config's two network
    evaluations: each under its own network's plan and dtype (mip-NeRF
    evaluates its one net twice), so that a pair on both plans runs."""
    import chip_smoke as cs
    from ddnerf_tpu_torch.config import load_config

    cfg = load_config(cs.CONFIG).merge_from_list(list(opts)).resolved()
    assert cs._kn(cfg, "fused_mlp_fwd") == want
    assert cs._kn(cfg, "fused_mlp_bwd", 5) == {
        name.replace("fwd", "bwd"): 5 * n for name, n in want.items()}


@pytest.mark.parametrize("hidden", [600, 768, 1024])
def test_wide_pack_layout(hidden):
    """``pack_weights`` at a wide network: the padded width's layout (the
    same offsets as a network of that width), every matrix 16-byte aligned,
    the padding zero, and ``unpack_grads`` the inverse; the float32 pack's
    TF32 planes as the plain split gives them."""
    width = fk.kernel_width(hidden)
    gen = torch.Generator().manual_seed(hidden)
    net = DepthMipMLP(hidden_size=hidden, generator=gen)
    kw = fk.pack_weights(net)
    full = fk.pack_weights(DepthMipMLP(hidden_size=width))
    assert kw.w_off == full.w_off and kw.b_off == full.b_off
    assert kw.w.numel() == fk.plane_size(kw.w_off)
    assert kw.w.shape == full.w.shape and kw.b.shape == full.b.shape
    assert all(o % 8 == 0 for o in kw.w_off)
    w0 = kw.w[kw.w_off[0]:kw.w_off[1]].view(width, 96)
    assert not w0[hidden:].any()
    w1 = kw.w[kw.w_off[1]:kw.w_off[2]].view(width, width)
    assert not w1[:, hidden:].any() and not w1[hidden:].any()
    back = fk.unpack_grads(net, kw, kw.w, kw.b)
    for name, p in net.named_parameters():
        assert torch.equal(back[name], p.detach()), name
    # float32: five planes, the split's as tf32_split_pack_reference makes
    # them.
    assert kw.planes is not None and kw.planes.numel() == 5 * kw.w.numel()
    plane = kw.w.numel()
    big, small = ref.tf32_split(kw.w)
    assert torch.equal(kw.planes[plane:2 * plane], big)
    assert torch.equal(kw.planes[2 * plane:3 * plane], small)


def test_weights_carry_a_1024_wide_jax_network():
    """``params_to_state_dict`` on a 1024-wide JAX DepthMipMLP: the port's
    module holds it, with the JAX module's outputs (float32, 1e-4)."""
    rng = np.random.default_rng(1)
    ipe = rng.uniform(-1, 1, (2, 3, 96)).astype(np.float32)
    dirs = rng.uniform(-1, 1, (2, 27)).astype(np.float32)
    jmod = JaxDepthMLP(hidden_size=1024)
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(ipe),
                       jnp.asarray(dirs)[:, None, :])["params"]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(ipe),
                                 jnp.asarray(dirs)[:, None, :]))
    sd = params_to_state_dict(params)
    assert sd["layers_xyz.5.weight"].shape == (1024, 96 + 1024)
    assert sd["layers_dir.0.weight"].shape == (128, 1024 + 27)
    net = DepthMipMLP(hidden_size=1024)
    net.load_state_dict(sd)
    with torch.no_grad():
        got = net(torch.tensor(ipe), torch.tensor(dirs)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _dd_dict(policy):
    return {
        "experiment": {"train_iters": 1000},
        "optimizer": {"lr_init": 1e-3, "lr_final": 1e-4, "lr_delay_steps": 0},
        "nerf": {
            "type": "DDNerfModel", "coarse_hidden_size": 600,
            "fine_hidden_size": 1024,
            "train": {"num_coarse": 6, "num_fine": 6, "num_random_rays": 4,
                      "perturb": False, "radiance_field_noise_std": 0.0},
            "validation": {"num_coarse": 6, "num_fine": 6, "perturb": False,
                           "radiance_field_noise_std": 0.0},
        },
        "dataset": {"type": "blender", "near": 2.0, "far": 6.0},
        "parallel": {"compute_dtype": "float32", "num_devices": 1,
                     "microbatch_rays": 0, "pallas_mlp": policy},
    }


def test_wide_ddnerf_cotrains_with_jax():
    """Coarse 600 / fine 1024 at float32: the port's training step through
    the kernel entry points (plain versions here) against JAX's fused train
    kernels in interpret mode, two steps, the same weights and batches and
    the same Adam updates applied to both."""
    jcfg = JaxConfig.from_dict(_dd_dict("train")).resolved()
    jpipe = JaxPipeline(jcfg)
    jstate = create_train_state(jcfg, jpipe, jax.random.PRNGKey(0))
    cfg = Config.from_dict(_dd_dict("auto")).resolved()
    pipe = NerfPipeline(cfg, "cpu")
    assert pipe.use_train_kernel
    nets = {"coarse": pipe.coarse, "fine": pipe.fine}
    assert (pipe.coarse.hidden_size, pipe.fine.hidden_size) == (600, 1024)
    for name, net in nets.items():
        net.load_state_dict(params_to_state_dict(jstate.params[name]))

    def loss_fn(params, ro, rd, radii, rgb, sched):
        return jax_compute_loss(
            jcfg, jpipe, params, JaxRays.create(ro, rd, radii, 2.0, 6.0), rgb,
            jax.random.PRNGKey(3), sched)

    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
    rng = np.random.default_rng(7)
    params = jstate.params
    opt = torch.optim.Adam(pipe.parameters(), lr=1e-3)
    for step in range(2):
        ro = rng.standard_normal((4, 3)).astype(np.float32) * 0.3
        rd = rng.standard_normal((4, 3)).astype(np.float32)
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True) * 0.8
        radii = np.abs(rng.standard_normal((4, 1))).astype(np.float32) * 0.01
        rgb = rng.uniform(0, 1, (4, 3)).astype(np.float32)
        sched = jax.tree_util.tree_map(jnp.asarray,
                                       jax_schedule_values(jcfg, step))
        (jloss, jm), jg = grad_fn(params, *map(jnp.asarray,
                                               (ro, rd, radii, rgb)), sched)
        opt.zero_grad(set_to_none=True)
        loss, m = compute_loss(
            cfg, pipe, RayBatch.create(*map(torch.tensor, (ro, rd, radii)),
                                       2.0, 6.0),
            torch.tensor(rgb), schedule_values(cfg, step))
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4,
                                   err_msg=f"step {step}")
        for key in ("loss_coarse", "loss_fine", "dp_loss"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=1e-4, atol=1e-7,
                                       err_msg=f"{step} {key}")
        for name, net in nets.items():
            want = params_to_state_dict(jg[name])
            for leaf, p in net.named_parameters():
                b = want[leaf].numpy()
                np.testing.assert_allclose(
                    p.grad.numpy(), b, rtol=5e-3,
                    atol=5e-5 * max(1.0, float(np.abs(b).max())),
                    err_msg=f"{step} {name} {leaf}")
        # Both sides take the port's Adam step from the same gradients, so
        # the next step starts from the same weights.
        opt.step()
        params = {name: _jax_params_of(net, params[name])
                  for name, net in nets.items()}


def _jax_params_of(net, like):
    """The JAX parameter tree of ``net`` (``kernel [in, out]``, ``bias``)
    with the groups of ``like``."""
    sd = {k: v.detach().numpy() for k, v in net.state_dict().items()}
    return {group: {"kernel": jnp.asarray(sd[f"{_torch_name(group)}.weight"].T),
                    "bias": jnp.asarray(sd[f"{_torch_name(group)}.bias"])}
            for group in like}
