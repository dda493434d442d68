"""The pipeline's encode stage as one kernel (``kernels/encode.py``,
``csrc/ipe_encode.cu``).

On the CPU: the wrapper's plain path is the composition it replaces
(``cast_rays`` → ``integrated_pos_enc`` → ``positional_encoding`` → the
cast) bit for bit, over both ray shapes, both IPE forms, both compute
dtypes, 17 / 32 / 33 sections, ragged ray counts and the training batch's
strided columns; ``NerfPipeline._run_network`` gives the outputs and
gradients it gave before for both pipelines; the kernel's name is none of
the benchmark's MLP kernels.  Marked ``cuda`` (skipped without a card,
decided in a fixture): the kernel against the plain composition on the
card at the render chunk's 524,288 rows, the training step's 65,536 and
every variant at small ragged sizes; its launch counts eagerly, at capture
and per replay; a captured DDNeRF step's encode stage in at most two
nodes a cycle; the ``ipe2`` and ``off`` paths launch none.

On a GPU machine:  python -m pytest tests/test_torch_port_encode.py -m cuda --noconftest
"""

import math

import pytest
import torch

from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.core import math as mmath
from ddnerf_tpu_torch.kernels import encode as enc
from ddnerf_tpu_torch.kernels import fused_mlp as fk
from ddnerf_tpu_torch.models.nerf import NerfPipeline, RayBatch

# ---------------------------------------------------------------- inputs


def _rays(seed, n, s, scene="blender", device="cpu"):
    """``n`` rays of ``s`` sections as the pipeline holds them: the
    training batch's column views of one [n, 10] store row (origins,
    directions, radii, rgb), view directions, and sorted fenceposts.
    ``blender``: cameras on a sphere of radius 4 looking in, near 2, far 6;
    ``ndc``: rays of the NDC cube, t in [0, 1]."""
    gen = torch.Generator().manual_seed(seed)
    if scene == "blender":
        o = torch.randn(n, 3, generator=gen)
        o = 4.0 * o / o.norm(dim=-1, keepdim=True)
        d = -o / 4.0 + 0.35 * torch.randn(n, 3, generator=gen)
        near, far = 2.0, 6.0
    else:
        o = torch.cat([torch.rand(n, 2, generator=gen) * 2 - 1,
                       -torch.ones(n, 1)], 1)
        d = torch.cat([torch.randn(n, 2, generator=gen) * 0.3,
                       2.0 * torch.ones(n, 1)], 1)
        near, far = 0.0, 1.0
    radii = 4e-4 + 4e-4 * torch.rand(n, 1, generator=gen)
    store = torch.cat([o, d, radii, torch.rand(n, 3, generator=gen)], 1)
    store = store.to(device)
    origins, directions, radii = store[:, 0:3], store[:, 3:6], store[:, 6:7]
    viewdirs = directions / torch.linalg.norm(directions, dim=-1,
                                              keepdim=True)
    # Stratified fenceposts with jitter (the first cycle's), sorted.
    base = torch.linspace(near, far, s + 1)
    jitter = (torch.rand(n, s + 1, generator=gen) - 0.5) * (far - near) / s
    t_vals = torch.sort(base + jitter, dim=-1).values.to(device)
    return t_vals, origins, directions, radii, viewdirs


def _composition(t_vals, origins, directions, radii, viewdirs, ray_shape,
                 double_angle, dtype):
    """The pipeline's encode stage before the kernel, written out."""
    means, covs = mmath.cast_rays(t_vals, origins, directions, radii,
                                  ray_shape)
    ipe = mmath.integrated_pos_enc((means, covs), double_angle=double_angle)
    dirs = mmath.positional_encoding(viewdirs, num_freqs=4)
    n, s = means.shape[0], means.shape[1]
    return ipe.reshape(n * s, -1).to(dtype), dirs.to(dtype)


VARIANTS = [(shape, double, dtype)
            for shape in ("cone", "cylinder") for double in (True, False)
            for dtype in (torch.bfloat16, torch.float32)]
SHAPES = [(5, 17), (3, 32), (7, 33)]  # (rays, sections): ragged row counts


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("rays,s", SHAPES)
@pytest.mark.parametrize("ray_shape,double_angle,dtype", VARIANTS)
def test_plain_path_is_the_composition_bit_for_bit(ray_shape, double_angle,
                                                   dtype, rays, s):
    args = _rays(rays * 100 + s, rays, s)
    ipe, dirs = enc.ipe_encode(*args, ray_shape, double_angle, dtype)
    want_ipe, want_dirs = _composition(*args, ray_shape, double_angle, dtype)
    assert ipe.dtype == dirs.dtype == dtype
    assert tuple(ipe.shape) == (rays * s, 96)
    assert tuple(dirs.shape) == (rays, 27)
    assert torch.equal(ipe, want_ipe) and torch.equal(dirs, want_dirs)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    args = _rays(0, 4, 8)
    with pytest.raises(ValueError, match="unknown ray_shape"):
        enc.ipe_encode(*args, "sphere")
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        enc.ipe_encode(*args, dtype=torch.float16)
    with pytest.raises(ValueError, match=r"radii must be \[4, 1\]"):
        enc.ipe_encode(args[0], args[1], args[2], args[3][:3], args[4])
    with pytest.raises(ValueError, match="origins must be float32"):
        enc.ipe_encode(args[0], args[1].double(), *args[2:])


def _pipeline(model, policy="auto", variant="mlp", dtype="bfloat16",
              device="cpu", hidden=16, chunk=4096):
    cfg = Config.from_dict({
        "experiment": {"train_iters": 1000},
        "nerf": {"type": model, "coarse_hidden_size": hidden,
                 "fine_hidden_size": hidden,
                 "train": {"num_coarse": 8, "num_fine": 8,
                           "num_random_rays": 16, "perturb": False,
                           "radiance_field_noise_std": 0.0},
                 "validation": {"num_coarse": 8, "num_fine": 8,
                                "perturb": False, "chunksize": chunk,
                                "radiance_field_noise_std": 0.0}},
        "dataset": {"type": "blender", "near": 2.0, "far": 6.0},
        "parallel": {"compute_dtype": dtype, "num_devices": 1,
                     "pallas_mlp": policy,
                     "render_kernel_variant": variant},
    }).resolved()
    return cfg, NerfPipeline(cfg, device, seed=3)


@pytest.mark.parametrize("mode", ["train", "validation"])
@pytest.mark.parametrize("model", ["DDNerfModel", "GeneralMipNerfModel"])
def test_run_network_is_unchanged_on_the_cpu(model, mode):
    """Each network of both pipelines, through the kernel entry points'
    plain versions: the outputs (and in training the gradients) of today's
    ``_run_network`` against the code before the encode kernel (the IPE
    rows left in float32 on the CPU, the cast to the compute dtype done by
    the network's operand rounding)."""
    cfg, pipe = _pipeline(model)
    t_vals, origins, directions, radii, _ = _rays(11, 6, 9)
    rays = RayBatch.create(origins, directions, radii, 2.0, 6.0)
    for net in pipe.networks():
        got = pipe._run_network(net, rays, t_vals, mode)
        means, covs = mmath.cast_rays(t_vals, rays.origins, rays.directions,
                                      rays.radii, cfg.nerf.ray_shape)
        dirs = mmath.positional_encoding(rays.viewdirs, num_freqs=4)
        ipe = mmath.integrated_pos_enc(
            (means, covs), double_angle=cfg.parallel.ipe_double_angle)
        ipe = ipe.reshape(6 * 9, -1)
        if mode == "train":
            flat = fk.fused_mlp_train_apply(net, ipe, dirs, 9,
                                            cfg.parallel.kernel_per_ray_dirs)
        else:
            flat = fk.fused_mlp_forward(net, ipe, dirs, 9)
        want = flat.reshape(6, 9, -1)
        assert torch.equal(got, want)
        if mode == "train":
            params = list(net.parameters())
            g_got = torch.autograd.grad(got.square().sum(), params)
            g_want = torch.autograd.grad(want.square().sum(), params)
            assert all(torch.equal(a, b) for a, b in zip(g_got, g_want))


def test_kernel_name_is_not_an_mlp_kernel():
    """The benchmark's ``mlp_roofline`` counts the kernels
    ``portbench/tracing.py::MLP_KERNEL`` names; the encode kernel's time
    belongs to ``other_device_ms``."""
    from portbench.tracing import is_mlp_kernel

    for args in ("__nv_bfloat16, true, true", "float, false, false"):
        name = (f"void (anonymous namespace)::ipe_encode_kernel<{args}>"
                "((anonymous namespace)::EncodeParams)")
        assert not is_mlp_kernel(name)
    assert is_mlp_kernel("void (anonymous namespace)::fused_mlp_fwd_kernel"
                         "<256, false>(Params)")


# ------------------------------------------------------------------ card


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in units in the last place of a's dtype, through the
    floats' order-preserving integer keys (-0 and +0 one apart)."""
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[a.dtype]
    bits = 8 * a.element_size()

    def key(x):
        i = x.contiguous().view(ints).long()
        return torch.where(i < 0, -(i & ((1 << (bits - 1)) - 1)) - 1, i)

    return (key(a) - key(b)).abs()


# The kernel's f32 values are the plain path's where each operation rounds
# where torch rounds it, in torch's order (see the source): on an H100 under
# torch 2.11 every element of every case here is bitwise the plain one.  The
# share leaves room for a torch whose reduction kernel sums the three terms
# of |d|^2 in another order: then an f32 value moves by an ulp now and then
# and its bf16 rounding by at most one.
EQUAL_SHARE = 0.999


def _hold(got, want, tag, f32_ulps=None):
    """``got`` equals ``want`` in at least EQUAL_SHARE of the elements and
    is within 1 ulp of the dtype elsewhere; float32 rows within
    ``f32_ulps`` (see the callers)."""
    d = _ulps(got, want)
    share = (d == 0).double().mean().item()
    print(f"[encode] {tag}: equal {share:.6f}, max ulps {d.max().item()}")
    assert torch.isfinite(got).all()
    assert share >= EQUAL_SHARE, tag
    limit = f32_ulps if got.dtype == torch.float32 else 1
    assert d.max().item() <= limit, tag


# The same room in f32: one ulp of |d|^2 moves an attenuated value by up
# to ~100 ulps where exp(-4^l cov / 2) leaves it near 1e-11 (114 read with
# the other summation order, 2.3e-4 of the elements; 0 with torch's).
F32_ULPS = 128


@pytest.mark.cuda
@pytest.mark.parametrize("rays,s,scene", [(16384, 32, "blender"),
                                          (2048, 32, "blender"),
                                          (2048, 16, "ndc")])
def test_kernel_matches_plain_at_the_main_shapes(device, rays, s, scene):
    """The render chunk (16,384 rays, 524,288 rows), the training step
    (2048 rays, 65,536 rows) and the NDC path's 16 sections, in the
    shipped form (cone, double angle, bf16)."""
    args = _rays(rays + s, rays, s, scene, device)
    before = dict(fk.LAUNCHES)
    ipe, dirs = enc.ipe_encode(*args)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["ipe_encode"] == before["ipe_encode"] + 1
    want_ipe, want_dirs = _composition(*args, "cone", True, torch.bfloat16)
    _hold(ipe, want_ipe, f"ipe {rays} x {s} {scene}")
    _hold(dirs, want_dirs, f"dirs {rays} {scene}")


@pytest.mark.cuda
@pytest.mark.parametrize("rays,s", SHAPES + [(333, 33)])
@pytest.mark.parametrize("ray_shape,double_angle,dtype", VARIANTS)
def test_kernel_matches_plain_in_every_variant(device, ray_shape,
                                               double_angle, dtype, rays, s):
    args = _rays(rays * 7 + s, rays, s, "blender", device)
    ipe, dirs = enc.ipe_encode(*args, ray_shape, double_angle, dtype)
    want_ipe, want_dirs = _composition(*args, ray_shape, double_angle, dtype)
    tag = f"{ray_shape} double={double_angle} {dtype} {rays}x{s}"
    _hold(ipe, want_ipe, "ipe " + tag, F32_ULPS)
    _hold(dirs, want_dirs, "dirs " + tag, F32_ULPS)
    # The same launch again: bitwise the same rows.
    again = enc.ipe_encode(*args, ray_shape, double_angle, dtype)
    assert torch.equal(again[0], ipe) and torch.equal(again[1], dirs)


def _launches(name):
    return fk.LAUNCHES[name], fk.CAPTURED[name]


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["DDNerfModel", "GeneralMipNerfModel"])
def test_launch_count_rises_once_per_network_call(device, model):
    """A render: two network calls, two launches (on a card its one chunk
    is rendered eagerly and then captured for the next frame's replay:
    two captured launches too).  At capture: two captured launches a step,
    which every replay adds to the launches, as it adds the stash
    forward's."""
    from ddnerf_tpu_torch.render.renderer import ImageRenderer
    from ddnerf_tpu_torch.data.synthetic import pose_spherical
    from ddnerf_tpu_torch.train.state import TrainState
    from ddnerf_tpu_torch.train.step import CapturedTrainStep

    cfg, pipe = _pipeline(model, device=device, chunk=4096)
    before = _launches("ipe_encode")
    ImageRenderer(cfg, pipe).render_image_from_pose(
        pose_spherical(30.0, -30.0, 4.0), 32, 24, 30.0)
    torch.cuda.synchronize()
    assert _launches("ipe_encode") == (before[0] + 2, before[1] + 2)

    state = TrainState(cfg, pipe)
    store = torch.rand(2, 64, 10, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    step = CapturedTrainStep(cfg, pipe, state, store, gen, max_block=4)
    enc0, stash0 = _launches("ipe_encode"), _launches("fused_mlp_fwd_stash")
    step.run(4)  # three eager warm-ups, the capture, one replay
    step.run(4)
    torch.cuda.synchronize()
    enc1, stash1 = _launches("ipe_encode"), _launches("fused_mlp_fwd_stash")
    assert enc1[1] - enc0[1] == 2  # one capture, two network calls
    assert enc1[0] - enc0[0] == stash1[0] - stash0[0] == 2 * 8


@pytest.mark.cuda
def test_captured_step_encodes_in_at_most_two_nodes_a_cycle(device):
    from ddnerf_tpu_torch.train.state import TrainState
    from ddnerf_tpu_torch.train.step import CapturedTrainStep
    from ddnerf_tpu_torch.utils import profiling

    cfg, pipe = _pipeline("DDNerfModel", device=device)
    state = TrainState(cfg, pipe)
    store = torch.rand(2, 64, 10, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    profiling.reset()
    profiling.enable()
    try:
        step = CapturedTrainStep(cfg, pipe, state, store, gen, max_block=4)
        step.run(4)
        torch.cuda.synchronize()
    finally:
        profiling.disable()
    ((_, _, census),) = step._graphs.values()
    nodes = [r.nodes for r in census.spans
             if r.name == "ddnerf.pipeline.encode"]
    print(f"[encode] captured DDNeRF step: encode nodes {nodes}; "
          f"{census.by_stage()}")
    assert len(nodes) == 2 and all(0 < n <= 2 for n in nodes)
    profiling.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("policy,variant,mode", [("auto", "ipe2", "render"),
                                                 ("off", "mlp", "render"),
                                                 ("off", "mlp", "train"),
                                                 ("render", "mlp", "train")])
def test_bypassing_paths_launch_no_encode_kernel(device, policy, variant,
                                                 mode):
    cfg, pipe = _pipeline("DDNerfModel", policy, variant, device=device)
    t_vals, origins, directions, radii, _ = _rays(5, 64, 8, device=device)
    rays = RayBatch.create(origins, directions, radii, 2.0, 6.0)
    from ddnerf_tpu_torch.models.nerf import ScheduleValues

    before = dict(fk.LAUNCHES)
    out = pipe.render_rays(rays, ScheduleValues.for_eval(cfg), mode)
    if mode == "train":
        (out[1]["rgb"].sum() + out[1]["dp_loss"]).backward()
    torch.cuda.synchronize()
    launched = {k: fk.LAUNCHES[k] - before[k] for k in before
                if fk.LAUNCHES[k] != before[k]}
    assert launched == ({"fused_enc_mlp_fwd": 2} if variant == "ipe2"
                        else {})
    assert math.isfinite(out[1]["rgb"].sum().item())
