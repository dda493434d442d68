"""The fused-MLP CUDA kernels on the card: the forward against its plain
version at the shapes the render path gives it, the whole render slice
through it against the plain modules, the in-kernel-IPE forward against
its plain version and bit for bit against the forward fed the plain IPE,
the forward's three modes bit for bit against each other on ragged,
one-tile and many-round grids and back to back with different weights,
and the training kernels (stash forward, fused backward) against their
plain versions at every width, below one tile and above 132 tiles, bitwise
repeatable (also around a call with other weights), in a train step.  Marked ``cuda``;
without a GPU every test here skips (the decision is made in a fixture,
at run time).

On a GPU machine:  python -m pytest tests/test_torch_port_cuda.py -m cuda
"""

import pytest
import torch

from ddnerf_tpu_torch.core.math import integrated_pos_enc
from ddnerf_tpu_torch.kernels import fused_mlp as fk
from ddnerf_tpu_torch.kernels.reference import (
    fused_enc_mlp_reference,
    fused_mlp_reference,
)
from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP

pytestmark = pytest.mark.cuda

# bf16 operands and f32 accumulation on both sides: summation order and
# the bf16 re-roundings it can flip (the chip_smoke.py tolerances).
MAX_ABS_TOL, MEAN_ABS_TOL = 2e-2, 1e-3


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("hidden,rays,k", [(256, 512, 32), (256, 129, 33),
                                           (128, 77, 3), (64, 50, 5),
                                           (256, 1, 1)])
@pytest.mark.parametrize("depth_head", [False, True])
def test_kernel_matches_plain_version(device, depth_head, hidden, rays, k):
    gen = torch.Generator().manual_seed(hidden + rays)
    net = (DepthMipMLP if depth_head else MipMLP)(
        hidden_size=hidden, compute_dtype=torch.bfloat16,
        generator=gen).to(device)
    ipe = (torch.rand(rays * k, 96, generator=gen) * 2 - 1).to(device)
    dirs = (torch.rand(rays, 27, generator=gen) * 2 - 1).to(device)
    before = fk.LAUNCHES["fused_mlp_fwd"]
    out = fk.fused_mlp_forward(net, ipe, dirs, k)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fused_mlp_fwd"] == before + 1
    ref = fused_mlp_reference(net, ipe, dirs, k)
    err = (out - ref).abs()
    assert torch.isfinite(out).all()
    assert err.max().item() <= MAX_ABS_TOL
    assert err.mean().item() <= MEAN_ABS_TOL


def test_kernel_rejects_float32_compute(device):
    net = MipMLP(hidden_size=64).to(device)
    with pytest.raises(ValueError, match="bf16"):
        fk.fused_mlp_forward(net, torch.zeros(4, 96, device=device),
                             torch.zeros(1, 27, device=device), 4)


def test_render_slice_through_kernel_matches_plain(device):
    from ddnerf_tpu_torch.config import Config
    from ddnerf_tpu_torch.models.nerf import NerfPipeline
    from ddnerf_tpu_torch.render.renderer import ImageRenderer
    from ddnerf_tpu_torch.data.synthetic import pose_spherical

    base = Config.from_dict({
        "nerf": {"type": "DDNerfModel",
                 "validation": {"num_coarse": 32, "num_fine": 32,
                                "perturb": False, "chunksize": 4096}},
        "parallel": {"compute_dtype": "bfloat16"},
    }).resolved()
    maps = {}
    for policy in ("auto", "off"):
        cfg = base.replace_at("parallel.pallas_mlp", policy)
        before = fk.LAUNCHES["fused_mlp_fwd"]
        r = ImageRenderer(cfg, NerfPipeline(cfg, device, seed=0))
        maps[policy] = r.render_image_from_pose(
            pose_spherical(30.0, -30.0, 4.0), 48, 40, 50.0)
        launched = fk.LAUNCHES["fused_mlp_fwd"] - before
        assert launched == (2 if policy == "auto" else 0)
    for i in (0, 1):
        diff = abs(maps["auto"][i]["rgb"] - maps["off"][i]["rgb"]).max()
        assert diff < 1e-3


def _gaussians(gen, n, device):
    """Section means up to +-3 (2^15 x 3 engages the 100 pi wrap) and
    covariances over six decades, as cast_rays gives them."""
    means = (torch.rand(n, 3, generator=gen) * 6 - 3).to(device)
    covs = (10.0 ** (torch.rand(n, 3, generator=gen) * 6 - 7)).to(device)
    return means, covs


@pytest.mark.parametrize("hidden,rays,k", [(256, 512, 32), (256, 129, 33),
                                           (128, 77, 32), (64, 50, 33),
                                           (256, 3, 1)])
@pytest.mark.parametrize("depth_head", [False, True])
def test_enc_kernel_matches_plain_and_the_forward_fed_the_plain_ipe(
        device, depth_head, hidden, rays, k):
    gen = torch.Generator().manual_seed(hidden + rays + k)
    net = (DepthMipMLP if depth_head else MipMLP)(
        hidden_size=hidden, compute_dtype=torch.bfloat16,
        generator=gen).to(device)
    means, covs = _gaussians(gen, rays * k, device)
    dirs = (torch.rand(rays, 27, generator=gen) * 2 - 1).to(device)
    before = dict(fk.LAUNCHES)
    out = fk.fused_enc_mlp_forward(net, means, covs, dirs, k)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fused_enc_mlp_fwd"] == before["fused_enc_mlp_fwd"] + 1
    assert fk.LAUNCHES["fused_mlp_fwd"] == before["fused_mlp_fwd"]
    assert out.shape == (rays * k, net.out_dim) and torch.isfinite(out).all()
    err = (out - fused_enc_mlp_reference(net, means, covs, dirs, k)).abs()
    assert err.max().item() <= MAX_ABS_TOL
    assert err.mean().item() <= MEAN_ABS_TOL
    # Same libdevice sinf / expf in the same order, the same bf16 rounding
    # and the same net body: bit-identical to B1 fed the torch IPE.
    ipe = integrated_pos_enc((means, covs), double_angle=False)
    assert torch.equal(out, fk.fused_mlp_forward(net, ipe, dirs, k))


def test_enc_kernel_checks_its_inputs_and_never_falls_back(device):
    gen = torch.Generator().manual_seed(0)
    net = MipMLP(hidden_size=64, compute_dtype=torch.bfloat16,
                 generator=gen).to(device)
    means, covs = _gaussians(gen, 12, device)
    dirs = torch.zeros(3, 27, device=device)
    before = dict(fk.LAUNCHES)
    with pytest.raises(ValueError, match="means must be"):
        fk.fused_enc_mlp_forward(net, torch.zeros(12, 4, device=device),
                                 covs, dirs, 4)
    with pytest.raises(ValueError, match="covs must be"):
        fk.fused_enc_mlp_forward(net, means, covs[:8], dirs, 4)
    with pytest.raises(ValueError, match="one row per"):
        fk.fused_enc_mlp_forward(net, means, covs, dirs[:2], 4)
    with pytest.raises(ValueError, match="whole rays"):
        fk.fused_enc_mlp_forward(net, means[:11], covs[:11], dirs, 4)
    with pytest.raises(ValueError, match="computes in bf16"):
        fk.fused_enc_mlp_forward(MipMLP(hidden_size=64).to(device), means,
                                 covs, dirs, 4)
    with pytest.raises(ValueError, match="hidden width"):
        fk.fused_enc_mlp_forward(
            MipMLP(hidden_size=32, compute_dtype=torch.bfloat16).to(device),
            means, covs, dirs, 4)
    assert fk.LAUNCHES == before


def test_render_slice_through_enc_kernel_matches_plain(device):
    from ddnerf_tpu_torch.config import Config
    from ddnerf_tpu_torch.models.nerf import NerfPipeline
    from ddnerf_tpu_torch.render.renderer import ImageRenderer
    from ddnerf_tpu_torch.data.synthetic import pose_spherical

    base = Config.from_dict({
        "nerf": {"type": "DDNerfModel",
                 "validation": {"num_coarse": 32, "num_fine": 32,
                                "perturb": False, "chunksize": 4096}},
        # The plain side takes the direct-form IPE that the kernel computes.
        "parallel": {"compute_dtype": "bfloat16", "ipe_double_angle": False,
                     "render_kernel_variant": "ipe2"},
    }).resolved()
    maps = {}
    for policy in ("auto", "off"):
        cfg = base.replace_at("parallel.pallas_mlp", policy)
        before = dict(fk.LAUNCHES)
        r = ImageRenderer(cfg, NerfPipeline(cfg, device, seed=0))
        maps[policy] = r.render_image_from_pose(
            pose_spherical(30.0, -30.0, 4.0), 48, 40, 50.0)
        launched = {name: fk.LAUNCHES[name] - before[name]
                    for name in before}
        assert launched["fused_enc_mlp_fwd"] == (2 if policy == "auto" else 0)
        assert launched["fused_mlp_fwd"] == 0
    for i in (0, 1):
        diff = abs(maps["auto"][i]["rgb"] - maps["off"][i]["rgb"]).max()
        assert diff < 1e-3


def _net(cls, hidden, seed, device):
    gen = torch.Generator().manual_seed(seed)
    return cls(hidden_size=hidden, compute_dtype=torch.bfloat16,
               generator=gen).to(device), gen


# Row counts that are no multiple of the 64 rows a warpgroup owns nor of the
# 128-row tile, a grid of one CTA, and grids of more tiles than the card has
# SMs, so the persistent CTAs walk several tiles and their barriers' phases
# wrap (33,000 rows = 258 tiles; 50,717 rows = 397 tiles, the last ragged).
@pytest.mark.parametrize("rays,k", [(5, 13), (3, 43), (7, 29), (1000, 33),
                                    (1237, 41)])
@pytest.mark.parametrize("hidden", [64, 128, 256])
def test_forward_modes_agree_bit_for_bit(device, hidden, rays, k):
    """Render mode, stash mode and the in-kernel IPE are one net body:
    B1 == B1s == B3 fed the same Gaussians, bit for bit, and within the
    forward tolerances of the plain version; the stash slabs too."""
    from ddnerf_tpu_torch.kernels import reference as ref

    net, gen = _net(DepthMipMLP, hidden, hidden + rays, device)
    n = rays * k
    means, covs = _gaussians(gen, n, device)
    dirs = (torch.rand(rays, 27, generator=gen) * 2 - 1).to(device)
    ipe = integrated_pos_enc((means, covs), double_angle=False)
    b1 = fk.fused_mlp_forward(net, ipe, dirs, k)
    b1s, stash = fk.fused_mlp_forward(net, ipe, dirs, k, stash=True)
    b3 = fk.fused_enc_mlp_forward(net, means, covs, dirs, k)
    torch.cuda.synchronize()
    assert b1.shape == (n, net.out_dim) and torch.isfinite(b1).all()
    assert torch.equal(b1, b1s)
    assert torch.equal(b1, b3)
    want, want_stash = ref.fused_mlp_stash_reference(net, ipe, dirs, k)
    for a, b in zip([b1, *stash.trunk, stash.h],
                    [want, *want_stash.trunk, want_stash.h]):
        err = (a.float() - b.float()).abs()
        assert err.max().item() <= MAX_ABS_TOL
        assert err.mean().item() <= MEAN_ABS_TOL


@pytest.mark.parametrize("hidden", [64, 128, 256])
def test_back_to_back_launches_with_different_weights(device, hidden):
    """Launches queued on one stream with no synchronisation between them,
    alternating two networks and the three modes: each result equals the
    same call made alone (no ring slot, tensor map or barrier state leaks
    from one launch into the next)."""
    net_a, gen = _net(DepthMipMLP, hidden, 1, device)
    net_b, _ = _net(DepthMipMLP, hidden, 2, device)
    rays, k = 300, 33
    means, covs = _gaussians(gen, rays * k, device)
    dirs = (torch.rand(rays, 27, generator=gen) * 2 - 1).to(device)
    ipe = integrated_pos_enc((means, covs), double_angle=False)
    alone = {}
    for name, net in (("a", net_a), ("b", net_b)):
        alone[name] = fk.fused_mlp_forward(net, ipe, dirs, k)
        torch.cuda.synchronize()
    assert not torch.equal(alone["a"], alone["b"])
    queued = []
    for _ in range(3):
        queued.append(("a", fk.fused_mlp_forward(net_a, ipe, dirs, k)))
        queued.append(("b", fk.fused_enc_mlp_forward(net_b, means, covs, dirs,
                                                     k)))
        queued.append(("b", fk.fused_mlp_forward(net_b, ipe, dirs, k,
                                                 stash=True)[0]))
        queued.append(("a", fk.fused_enc_mlp_forward(net_a, means, covs, dirs,
                                                     k)))
    torch.cuda.synchronize()
    for name, out in queued:
        assert torch.equal(out, alone[name])


# The fused backward vs its plain version, per gradient, norm-relative:
# summation order and the bf16 cotangent roundings it can flip.  At a few
# rows one flipped rounding weighs more than at the training shape (5 rows:
# layers_xyz.0.weight reads 1.7e-3 on an H100), so these small shapes are
# held at 1e-2; chip_smoke.py holds the 65,536-row training shape to
# per-leaf limits near its readings.
GRAD_NORM_REL_TOL = 1e-2


def _training_shapes():
    """(hidden, rays, k): every width x K in {32, 33, 13} x a row count
    below one 128-row tile and one above 132 tiles (more tiles than the card
    has SMs, so the persistent CTAs walk several and the last is ragged),
    then a few odd ones (K = 1, five rows)."""
    shapes = []
    for hidden in (64, 128, 256):
        for k in (32, 33, 13):
            shapes.append((hidden, 3, k))
            shapes.append((hidden, 132 * 128 // k + 7, k))
    return shapes + [(128, 77, 3), (64, 50, 1), (256, 5, 1), (256, 37, 33)]


@pytest.mark.parametrize("hidden,rays,k", _training_shapes())
@pytest.mark.parametrize("depth_head", [False, True])
def test_training_kernels_match_plain_versions(device, depth_head, hidden,
                                               rays, k):
    from ddnerf_tpu_torch.kernels import reference as ref

    gen = torch.Generator().manual_seed(hidden + rays + k)
    net = (DepthMipMLP if depth_head else MipMLP)(
        hidden_size=hidden, compute_dtype=torch.bfloat16,
        generator=gen).to(device)
    n = rays * k
    ipe = (torch.rand(n, 96, generator=gen) * 2 - 1).to(device)
    dirs = (torch.rand(rays, 27, generator=gen) * 2 - 1).to(device)
    g = torch.randn(n, net.out_dim, generator=gen).to(device)
    before = dict(fk.LAUNCHES)
    out_r = fk.fused_mlp_forward(net, ipe, dirs, k)
    out_s, stash = fk.fused_mlp_forward(net, ipe, dirs, k, stash=True)
    grads = fk.fused_mlp_backward(net, ipe, dirs, g, k, stash)
    again = fk.fused_mlp_backward(net, ipe, dirs, g, k, stash)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fused_mlp_fwd_stash"] == before["fused_mlp_fwd_stash"] + 1
    assert fk.LAUNCHES["fused_mlp_bwd"] == before["fused_mlp_bwd"] + 2
    assert torch.equal(out_r, out_s)  # the stash changes no arithmetic
    ref_out, ref_stash = ref.fused_mlp_stash_reference(net, ipe, dirs, k)
    for a, b in zip([out_s, *stash.trunk, stash.h],
                    [ref_out, *ref_stash.trunk, ref_stash.h]):
        err = (a.float() - b.float()).abs()
        assert err.max().item() <= MAX_ABS_TOL
        assert err.mean().item() <= MEAN_ABS_TOL
    want = ref.fused_mlp_backward_reference(net, ipe, dirs, g, k, stash)
    for name, p in net.named_parameters():
        assert grads[name].shape == p.shape
        assert torch.equal(grads[name], again[name]), name  # deterministic
        rel = ((grads[name] - want[name]).norm()
               / want[name].norm().clamp_min(1e-30)).item()
        assert rel <= GRAD_NORM_REL_TOL, (name, rel)


@pytest.mark.parametrize("hidden", [64, 128, 256])
def test_backward_repeats_bitwise_after_a_call_with_other_weights(device,
                                                                  hidden):
    """Two backward calls on one network give bitwise the same gradients,
    with a call on another network (other weights, another row count, so
    other workspace and tensor maps) queued between them: nothing that a
    call builds (tensor maps, workspace, partial sums) outlives it."""
    net_a, gen = _net(DepthMipMLP, hidden, 3, device)
    net_b, _ = _net(DepthMipMLP, hidden, 4, device)
    calls = {}
    for name, net, rays, k in (("a", net_a, 300, 33), ("b", net_b, 129, 32)):
        n = rays * k
        ipe = (torch.rand(n, 96, generator=gen) * 2 - 1).to(device)
        dirs = (torch.rand(rays, 27, generator=gen) * 2 - 1).to(device)
        g = torch.randn(n, net.out_dim, generator=gen).to(device)
        _, stash = fk.fused_mlp_forward(net, ipe, dirs, k, stash=True)
        calls[name] = (net, ipe, dirs, g, k, stash)
    first = fk.fused_mlp_backward(*calls["a"])
    other = fk.fused_mlp_backward(*calls["b"])
    second = fk.fused_mlp_backward(*calls["a"])
    torch.cuda.synchronize()
    alone_b = fk.fused_mlp_backward(*calls["b"])
    torch.cuda.synchronize()
    for name in first:
        assert torch.equal(first[name], second[name]), name
        assert torch.equal(other[name], alone_b[name]), name
        assert not torch.equal(first[name], other[name]), name


def test_backward_rejects_float32_compute_and_never_falls_back(device,
                                                               monkeypatch):
    """On CUDA tensors the backward launches its kernel or raises: an
    f32-compute network raises, and neither a kernel nor the plain version
    runs in its place."""
    from ddnerf_tpu_torch.kernels import reference as ref

    gen = torch.Generator().manual_seed(0)
    net = MipMLP(hidden_size=64, generator=gen).to(device)
    rays, k = 4, 3
    ipe = torch.rand(rays * k, 96, generator=gen).to(device)
    dirs = torch.rand(rays, 27, generator=gen).to(device)
    g = torch.randn(rays * k, 4, generator=gen).to(device)
    _, stash = ref.fused_mlp_stash_reference(net, ipe, dirs, k)
    before = dict(fk.LAUNCHES)
    called = []
    monkeypatch.setattr(fk, "fused_mlp_backward_reference",
                        lambda *a, **kw: called.append(a))
    with pytest.raises(ValueError, match="computes in bf16"):
        fk.fused_mlp_backward(net, ipe, dirs, g, k, stash)
    assert not called and fk.LAUNCHES == before


def test_training_step_runs_both_kernels_twice(device):
    """A DDNeRF train step on the card under pallas_mlp: auto launches the
    stash forward and the backward once per network."""
    from ddnerf_tpu_torch.config import Config
    from ddnerf_tpu_torch.models.nerf import NerfPipeline
    from ddnerf_tpu_torch.train.state import TrainState
    from ddnerf_tpu_torch.train.step import train_step

    cfg = Config.from_dict({
        "nerf": {"type": "DDNerfModel",
                 "train": {"num_coarse": 32, "num_fine": 32,
                           "num_random_rays": 256}},
        "parallel": {"compute_dtype": "bfloat16", "pallas_mlp": "auto"},
    }).resolved()
    pipe = NerfPipeline(cfg, device, seed=0)
    state = TrainState(cfg, pipe)
    gen = torch.Generator(device=device).manual_seed(0)
    rng = torch.Generator().manual_seed(1)
    rd = torch.randn(256, 3, generator=rng)
    batch = {"origins": (torch.randn(256, 3, generator=rng) * 0.3).to(device),
             "directions": (rd / rd.norm(dim=-1, keepdim=True)).to(device),
             "radii": torch.full((256, 1), 1e-3, device=device),
             "rgb": torch.rand(256, 3, generator=rng).to(device)}
    before = dict(fk.LAUNCHES)
    metrics = train_step(cfg, pipe, state, batch, gen)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fused_mlp_fwd_stash"] - before["fused_mlp_fwd_stash"] == 2
    assert fk.LAUNCHES["fused_mlp_bwd"] - before["fused_mlp_bwd"] == 2
    assert torch.isfinite(metrics["loss"]).item()
    assert all(torch.isfinite(p.grad).all() for p in pipe.parameters())


def _mipnerf_cfg(**dataset):
    from ddnerf_tpu_torch.config import Config

    return Config.from_dict({
        "train_params": {"loss_coeficients": [1.0, 0.1]},
        "nerf": {"type": "GeneralMipNerfModel",
                 "train": {"num_coarse": 32, "num_fine": 32,
                           "num_random_rays": 256, "perturb": False,
                           "radiance_field_noise_std": 0.0},
                 "validation": {"num_coarse": 32, "num_fine": 32,
                                "perturb": False, "chunksize": 4096}},
        "dataset": dataset,
        "parallel": {"compute_dtype": "bfloat16", "pallas_mlp": "auto"},
    }).resolved()


def test_mipnerf_step_sums_two_kernel_backwards_on_the_shared_net(
        device, monkeypatch):
    """A mip-NeRF train step on the card: the stash forward and the
    backward launch twice on the one network, both calls read one weight
    pack (a fresh one after Adam), and the summed gradient of each leaf
    agrees with the same step whose backward is the plain version (same
    forward, so the same stash and cotangents)."""
    from ddnerf_tpu_torch.kernels import reference as ref
    from ddnerf_tpu_torch.models.nerf import NerfPipeline
    from ddnerf_tpu_torch.train.state import TrainState
    from ddnerf_tpu_torch.train.step import train_step

    cfg = _mipnerf_cfg()
    rng = torch.Generator().manual_seed(1)
    rd = torch.randn(256, 3, generator=rng)
    batch = {"origins": (torch.randn(256, 3, generator=rng) * 0.3).to(device),
             "directions": (rd / rd.norm(dim=-1, keepdim=True)).to(device),
             "radii": torch.full((256, 1), 1e-3, device=device),
             "rgb": torch.rand(256, 3, generator=rng).to(device)}
    packs = []
    real_pack = fk.pack_weights
    monkeypatch.setattr(fk, "pack_weights",
                        lambda net: packs.append(net) or real_pack(net))

    def step(plain_backward):
        pipe = NerfPipeline(cfg, device, seed=0)
        state = TrainState(cfg, pipe)
        before = dict(fk.LAUNCHES)
        with monkeypatch.context() as patch:
            if plain_backward:
                patch.setattr(fk, "fused_mlp_backward",
                              ref.fused_mlp_backward_reference)
            metrics = train_step(cfg, pipe, state, batch)
            torch.cuda.synchronize()
        launched = {k: fk.LAUNCHES[k] - before[k] for k in before}
        return pipe, state, metrics, launched

    pipe, state, metrics, launched = step(False)
    assert launched == {"fused_mlp_fwd": 0, "fused_mlp_fwd_stash": 2,
                        "fused_mlp_bwd": 2, "fused_enc_mlp_fwd": 0}
    assert packs == [pipe.coarse]  # one pack served both cycles and B2
    train_step(cfg, pipe, state, batch)
    assert packs == [pipe.coarse] * 2  # Adam changed the weights: repacked
    grads = {n: p.grad.clone() for n, p in pipe.coarse.named_parameters()}
    assert "dp_loss" not in metrics and torch.isfinite(metrics["loss"])

    pipe, state, _, _ = step(False)
    kernel = {n: p.grad.clone() for n, p in pipe.coarse.named_parameters()}
    plain_pipe, _, _, launched = step(True)
    assert launched["fused_mlp_bwd"] == 0 and launched["fused_mlp_fwd_stash"] == 2
    for name, p in plain_pipe.coarse.named_parameters():
        rel = ((kernel[name] - p.grad).norm()
               / p.grad.norm().clamp_min(1e-30)).item()
        assert rel <= GRAD_NORM_REL_TOL, (name, rel)
    assert grads.keys() == kernel.keys()


def test_ndc_frame_through_kernel_matches_plain(device):
    """``dataset.ndc_rays``: a forward-facing pose projected on the device
    and rendered through the forward kernel (both variants) against the
    plain modules."""
    import numpy as np

    from ddnerf_tpu_torch.models.nerf import NerfPipeline
    from ddnerf_tpu_torch.render.renderer import ImageRenderer

    base = _mipnerf_cfg(type="llff", ndc_rays=True, near=0.0, far=1.0)
    base = base.replace_at("nerf.type", "DDNerfModel")
    pose = np.eye(4, dtype=np.float32)[:3]
    pose[:, 3] = [0.1, -0.05, 0.2]
    maps = {}
    for name, policy, variant, kernel in (
            ("mlp", "auto", "mlp", "fused_mlp_fwd"),
            ("ipe2", "auto", "ipe2", "fused_enc_mlp_fwd"),
            ("plain", "off", "mlp", None)):
        cfg = base.replace_at("parallel.pallas_mlp", policy).replace_at(
            "parallel.render_kernel_variant", variant)
        before = dict(fk.LAUNCHES)
        maps[name] = ImageRenderer(
            cfg, NerfPipeline(cfg, device, seed=0)).render_image_from_pose(
            pose, 48, 40, 50.0)
        launched = {k: fk.LAUNCHES[k] - before[k] for k in before
                    if fk.LAUNCHES[k] != before[k]}
        assert launched == ({kernel: 2} if kernel else {})
    for name in ("mlp", "ipe2"):
        for i in (0, 1):
            assert np.isfinite(maps[name][i]["rgb"]).all()
            assert abs(maps[name][i]["rgb"] - maps["plain"][i]["rgb"]).max() \
                < 1e-3
