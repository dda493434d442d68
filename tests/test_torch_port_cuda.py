"""The fused-MLP CUDA kernel on the card: against its plain version at the
shapes the render path gives it, and the whole render slice through the
kernel against the plain modules.  Marked ``cuda``; without a GPU every
test here skips (the decision is made in a fixture, at run time).

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
