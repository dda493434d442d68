"""The fused-MLP CUDA kernels on the card: the forward against its plain
version at the shapes the render path gives it, the whole render slice
through it against the plain modules, and the training kernels (stash
forward, fused backward) against their plain versions, bitwise
repeatable, in a train step.  Marked ``cuda``; without a GPU every test
here skips (the decision is made in a fixture, at run time).

On a GPU machine:  python -m pytest tests/test_torch_port_cuda.py -m cuda
"""

import pytest
import torch

from ddnerf_tpu_torch.kernels import fused_mlp as fk
from ddnerf_tpu_torch.kernels.reference import fused_mlp_reference
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
    from ddnerf_tpu.data.synthetic import pose_spherical

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


# The fused backward vs its plain version, per gradient, norm-relative:
# summation order and the bf16 cotangent roundings it can flip.  At a few
# rows one flipped rounding weighs more than at the training shape (5 rows:
# layers_xyz.0.weight reads 1.7e-3 on an H100), so these small shapes are
# held at 1e-2; chip_smoke.py holds the 65,536-row training shape to
# per-leaf limits near its readings.
GRAD_NORM_REL_TOL = 1e-2


@pytest.mark.parametrize("hidden,rays,k", [(256, 64, 32), (256, 37, 33),
                                           (128, 77, 3), (64, 50, 1),
                                           (256, 5, 1), (128, 9, 33)])
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
