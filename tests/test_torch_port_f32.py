"""The float32 slice: the DDNeRF and mip-NeRF pipelines at
``parallel.compute_dtype: float32`` through the port's kernel entry points
(``pallas_mlp: all``; on the CPU each wrapper runs its plain version)
against the JAX pipeline at float32 with its Pallas kernels in interpret
mode: the fused train kernels (``pallas_mlp: train``; JAX's ``all`` trains
through the render-mode kernel, which has no VJP) over a few co-trained
Adam steps, and the render-mode forward (``all``) on a validation render.
Then the weight pack at float32 and the pipeline's kernel policy at float32.

Tolerances: both sides compute in f32 and differ in summation order only
(the kernels round nothing at f32).  Outputs and losses agree to 1e-4;
every gradient to 1e-5 of its norm (the port's f32 limit for the backward,
tests/test_torch_port_backward.py).  The training loss leaves out the dp
loss (``dp_coeficient: 0``): its log of small fine-section masses moves
with f32 summation order, and the coarse network's gradients of the two
packages' plain paths differ by up to ~3e-3 of their norm with it (as
tests/test_torch_port_trajectory.py's DP_LOSS_RTOL says), which would hide
what this test reads; without it every gradient agrees to < 1e-6."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ddnerf_tpu.config import Config as JaxConfig
from ddnerf_tpu.models.nerf import NerfPipeline as JaxPipeline
from ddnerf_tpu.models.nerf import RayBatch as JaxRays
from ddnerf_tpu.models.nerf import ScheduleValues as JaxSched
from ddnerf_tpu.train.state import create_train_state, make_optimizer
from ddnerf_tpu.train.step import compute_loss as jax_compute_loss
from ddnerf_tpu.train.step import schedule_values as jax_schedule_values
from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.kernels import fused_mlp as fk
from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP
from ddnerf_tpu_torch.models.nerf import NerfPipeline, RayBatch, ScheduleValues
from ddnerf_tpu_torch.train.state import TrainState
from ddnerf_tpu_torch.train.step import compute_loss, schedule_values
from ddnerf_tpu_torch.utils.weights import params_to_state_dict

STEPS = 3
OUT_TOL = 1e-4
GRAD_NORM_REL_TOL = 1e-5
FAMILIES = ("DDNerfModel", "GeneralMipNerfModel")


def _dict(family, policy):
    return {
        "experiment": {"train_iters": 1000},
        "train_params": {"dp_coeficient": 0.0},
        "optimizer": {"lr_init": 1e-3, "lr_final": 1e-4, "lr_delay_steps": 0},
        "nerf": {
            "type": family, "coarse_hidden_size": 32, "fine_hidden_size": 32,
            "train": {"num_coarse": 6, "num_fine": 6, "num_random_rays": 8,
                      "perturb": False, "radiance_field_noise_std": 0.0},
            "validation": {"num_coarse": 6, "num_fine": 6, "perturb": False,
                           "radiance_field_noise_std": 0.0},
        },
        "dataset": {"type": "blender", "near": 2.0, "far": 6.0},
        "parallel": {"compute_dtype": "float32", "num_devices": 1,
                     "microbatch_rays": 0, "pallas_mlp": policy},
    }


def _batches(n=8, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        ro = rng.standard_normal((n, 3)).astype(np.float32) * 0.3
        rd = rng.standard_normal((n, 3)).astype(np.float32)
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True) * 0.8
        radii = np.abs(rng.standard_normal((n, 1))).astype(np.float32) * 0.01
        rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        out.append((ro, rd, radii, rgb))
    return out


def _nets(pipe):
    return {"coarse": pipe.coarse, "fine": pipe.fine} if pipe.fine else {
        "coarse": pipe.coarse}


@pytest.mark.parametrize("family", FAMILIES)
def test_f32_kernel_pipeline_cotrains_with_jax_kernels(family):
    jcfg = JaxConfig.from_dict(_dict(family, "train")).resolved()
    jpipe = JaxPipeline(jcfg)
    jstate = create_train_state(jcfg, jpipe, jax.random.PRNGKey(0))
    tx = make_optimizer(jcfg)

    @jax.jit
    def adam(params, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    def loss_fn(params, ro, rd, radii, rgb, sched):
        return jax_compute_loss(
            jcfg, jpipe, params, JaxRays.create(ro, rd, radii, 2.0, 6.0), rgb,
            jax.random.PRNGKey(3), sched)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    cfg = Config.from_dict(_dict(family, "all")).resolved()
    pipe = NerfPipeline(cfg, "cpu")
    assert pipe.use_kernel and pipe.use_train_kernel
    nets = _nets(pipe)
    for name, net in nets.items():
        net.load_state_dict(params_to_state_dict(jstate.params[name]))
        assert net.compute_dtype == torch.float32
    state = TrainState(cfg, pipe)

    for i, (ro, rd, radii, rgb) in enumerate(_batches()):
        sched = jax.tree_util.tree_map(jnp.asarray,
                                       jax_schedule_values(jcfg, i))
        (jloss, jm), jg = grad_fn(jstate.params, *map(jnp.asarray,
                                                      (ro, rd, radii, rgb)),
                                  sched)
        state.optimizer.zero_grad(set_to_none=True)
        loss, m = compute_loss(
            cfg, pipe, RayBatch.create(*map(torch.tensor, (ro, rd, radii)),
                                       2.0, 6.0),
            torch.tensor(rgb), schedule_values(cfg, i))
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=OUT_TOL,
                                   err_msg=f"step {i}")
        for key in ("loss_coarse", "loss_fine", "dp_loss"):
            if key in jm:
                np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                           rtol=OUT_TOL, err_msg=f"{i} {key}")
        for name, net in nets.items():
            want = params_to_state_dict(jg[name])
            for leaf, p in net.named_parameters():
                if not want[leaf].any():  # the depth head, without dp loss
                    assert not p.grad.any(), (i, name, leaf)
                    continue
                rel = ((p.grad - want[leaf]).norm()
                       / want[leaf].norm()).item()
                assert rel <= GRAD_NORM_REL_TOL, (i, name, leaf, rel)
        state.apply_gradients()
        params, opt_state = adam(jstate.params, jstate.opt_state, jg)
        jstate = jstate.replace(params=params, opt_state=opt_state)

    # The render-mode forward kernel: a validation render after training.
    rjcfg = JaxConfig.from_dict(_dict(family, "all")).resolved()
    ro, rd, radii, _ = _batches(seed=1)[0]
    rpipe = JaxPipeline(rjcfg)
    want = jax.jit(lambda params, ro, rd, radii: rpipe.render_rays(
        params, JaxRays.create(ro, rd, radii, 2.0, 6.0),
        jax.random.PRNGKey(1), JaxSched.for_eval(rjcfg), "render"))(
        jstate.params, *map(jnp.asarray, (ro, rd, radii)))
    got = pipe.render_rays(
        RayBatch.create(*map(torch.tensor, (ro, rd, radii)), 2.0, 6.0),
        ScheduleValues.for_eval(cfg), "render")
    for i in (0, 1):
        np.testing.assert_allclose(got[i]["rgb"].numpy(),
                                   np.asarray(want[i]["rgb"]), rtol=OUT_TOL,
                                   atol=OUT_TOL, err_msg=f"cycle {i} rgb")


@pytest.mark.parametrize("hidden", [48, 320])
def test_pack_weights_round_trips_float32_bitwise(hidden):
    """At float32 the pack holds every weight as it is (no bf16 rounding),
    zero-padded to the kernel width, and ``unpack_grads`` of the pack read
    as gradients gives every parameter back bitwise."""
    net = DepthMipMLP(hidden_size=hidden,
                      generator=torch.Generator().manual_seed(hidden))
    kw = fk.pack_weights(net)
    assert kw.w.dtype == torch.float32 and kw.b.dtype == torch.float32
    width = fk.kernel_width(hidden)
    assert width > hidden
    back = fk.unpack_grads(net, kw, kw.w, kw.b)
    for name, p in net.named_parameters():
        assert torch.equal(back[name], p.detach()), name
    # Everything past the network's width is zero.
    assert kw.w.count_nonzero() == sum(
        p.count_nonzero() for n, p in net.named_parameters()
        if n.endswith("weight"))


def test_pipeline_takes_float32_under_every_kernel_policy():
    """No refusal remains for float32 under a kernel policy, and the
    kernels' check accepts float32 and bfloat16 networks only."""
    for policy in ("train", "render", "auto", "all"):
        cfg = Config.from_dict(_dict("DDNerfModel", policy)).resolved()
        pipe = NerfPipeline(cfg, "cpu")
        assert pipe.coarse.compute_dtype == torch.float32
        for net in _nets(pipe).values():
            fk._check_net(net, torch.device("cpu"))
    net = MipMLP(hidden_size=16, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fk._check_net(net, torch.device("cpu"))
