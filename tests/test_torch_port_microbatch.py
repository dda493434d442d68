"""Port parity for the microbatched train step (``parallel.microbatch_rays``):
the port's eager step on a 64-ray batch split into four 16-ray chunks
against the JAX package's ``make_train_step`` on the same batch, with the
same weights, at float32 with the draws made deterministic (no jitter, no
density noise).  The port's fused-MLP training Function runs its plain
versions on the CPU, JAX its fused Pallas train kernels in interpret mode.
Tolerances: the scalar metrics and the PSNRs 1e-4, every gradient leaf
rtol 5e-3 (tests/test_torch_port_train.py's), the Adam-updated parameters
after the step where the update's sign is determined."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddnerf_tpu.config import Config
from ddnerf_tpu.models.nerf import NerfPipeline as JaxPipeline
from ddnerf_tpu.models.nerf import RayBatch as JaxRays
from ddnerf_tpu.train.state import create_train_state
from ddnerf_tpu.train.step import _scan_accumulate
from ddnerf_tpu.train.step import compute_loss as jax_compute_loss
from ddnerf_tpu.train.step import make_train_step
from ddnerf_tpu.train.step import schedule_values as jax_schedule_values
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.train.state import TrainState
from ddnerf_tpu_torch.train.step import _microbatches, train_step
from ddnerf_tpu_torch.utils.weights import params_to_state_dict

RAYS, CHUNK = 64, 16


def _cfg(nerf_type, **parallel):
    return Config.from_dict({
        "experiment": {"train_iters": 1000},
        "train_params": {"max_pdf_pad_iters": 400, "finnish_smooth": 600},
        "optimizer": {"lr_delay_steps": 0},
        "nerf": {
            "type": nerf_type, "coarse_hidden_size": 32,
            "fine_hidden_size": 32,
            "train": {"num_coarse": 6, "num_fine": 6,
                      "num_random_rays": RAYS, "perturb": False,
                      "radiance_field_noise_std": 0.0},
            "validation": {"num_coarse": 6, "num_fine": 6, "perturb": False,
                           "radiance_field_noise_std": 0.0},
        },
        "dataset": {"type": "blender", "near": 2.0, "far": 6.0},
        "parallel": {"compute_dtype": "float32", "num_devices": 1,
                     "microbatch_rays": CHUNK, **parallel},
    }).resolved()


def _batch(seed=4):
    rng = np.random.default_rng(seed)
    ro = rng.standard_normal((RAYS, 3)).astype(np.float32)
    rd = rng.standard_normal((RAYS, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True) * 0.8
    radii = np.abs(rng.standard_normal((RAYS, 1))).astype(np.float32) * 0.01
    rgb = rng.uniform(0, 1, (RAYS, 3)).astype(np.float32)
    return {"origins": ro, "directions": rd, "radii": radii, "rgb": rgb}


def _jax_gradients(cfg, jpipe, state, batch):
    """The JAX step's accumulated gradient: ``make_train_step``'s
    ``grad_of`` over the same chunks through the package's own
    ``_scan_accumulate``, divided by the chunk count."""
    sched = jax_schedule_values(cfg, state.step)
    rng = jax.random.fold_in(state.rng, state.step)

    def grad_of(part, part_rng):
        rays = JaxRays.create(part["origins"], part["directions"],
                              part["radii"], cfg.dataset.near, cfg.dataset.far)
        return jax.grad(lambda p: jax_compute_loss(
            cfg, jpipe, p, rays, part["rgb"], part_rng, sched, "train"),
            has_aux=True)(state.params)

    k = RAYS // CHUNK
    chunked = {name: jnp.asarray(v).reshape(k, CHUNK, *v.shape[1:])
               for name, v in batch.items()}
    g_sum, _ = _scan_accumulate(grad_of, rng, chunked, k)
    return jax.tree_util.tree_map(lambda x: np.asarray(x / k), g_sum)


@pytest.mark.parametrize("nerf_type", ["DDNerfModel", "GeneralMipNerfModel"])
def test_microbatched_step_matches_jax(nerf_type):
    """k = 4 chunks: metrics, PSNRs (from the averaged MSEs), every
    gradient leaf and the parameters after the Adam update."""
    jcfg = _cfg(nerf_type, pallas_mlp="train")
    assert _microbatches(jcfg, RAYS) == RAYS // CHUNK
    jpipe = JaxPipeline(jcfg)
    jstate = create_train_state(jcfg, jpipe, jax.random.PRNGKey(0))
    batch = _batch()
    want_g = _jax_gradients(jcfg, jpipe, jstate, batch)
    new_jstate, want_m = make_train_step(jcfg, jpipe)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    cfg = _cfg(nerf_type, pallas_mlp="auto")
    pipe = NerfPipeline(cfg, "cpu")
    assert pipe.use_train_kernel
    names = ("coarse",) if pipe.shared_net else ("coarse", "fine")
    pipe.load_state_dicts(*(params_to_state_dict(jstate.params[n])
                            for n in names))
    state = TrainState(cfg, pipe)
    before = [p.detach().clone() for p in pipe.parameters()]
    m = train_step(cfg, pipe, state,
                   {k: torch.tensor(v) for k, v in batch.items()})
    assert state.step == 1

    assert set(m) == set(want_m)
    for key in want_m:
        np.testing.assert_allclose(m[key].item(), float(want_m[key]),
                                   rtol=1e-4, atol=1e-7, err_msg=key)

    for name, net in zip(names, pipe.networks()):
        want = params_to_state_dict(want_g[name])
        after = params_to_state_dict(new_jstate.params[name])
        start = dict(zip((n for n, _ in net.named_parameters()),
                         before[:len(list(net.parameters()))]))
        before = before[len(start):]
        for leaf, p in net.named_parameters():
            g, b = p.grad.numpy(), want[leaf].numpy()
            atol = 5e-5 * max(1.0, float(np.abs(b).max()))
            np.testing.assert_allclose(g, b, rtol=5e-3, atol=atol,
                                       err_msg=f"{name} {leaf} gradient")
            # Adam's first step moves each element by about lr * sign(g):
            # where |g| clears the gradient tolerance the sign is settled
            # and both updates must agree.
            settled = np.abs(b) > 10 * atol
            moved = (p.detach() - start[leaf]).numpy()
            want_moved = after[leaf].numpy() - start[leaf].numpy()
            np.testing.assert_allclose(moved[settled], want_moved[settled],
                                       rtol=1e-3, atol=1e-9,
                                       err_msg=f"{name} {leaf} update")
            assert np.isfinite(moved).all()


def test_microbatch_split_rule():
    """The JAX package's rule (step.py:125): split only when the batch is
    larger than the chunk and a whole number of chunks."""
    cfg = _cfg("DDNerfModel")
    assert _microbatches(cfg, 64) == 4
    assert _microbatches(cfg, 16) == 1
    assert _microbatches(cfg, 24) == 1
    assert _microbatches(cfg.replace_at("parallel.microbatch_rays", 0),
                         64) == 1
