"""The port's data parallelism (``ddnerf_tpu_torch/parallel/``) against the
JAX package's mesh (``ddnerf_tpu/parallel/``), on the CPU.

The pure helpers against JAX's, parametrised; ``parallel.num_devices``
against the world size; then two groups of two gloo ranks, each a pair of
subprocesses with its own timeout and port:

* the step group: the sharded train step of both families on one batch
  whose halves hold different numbers of empty rays, against JAX's
  ``make_sharded_train_step`` on a 2-device mesh (the tolerances of
  ``tests/test_parallel.py``) and against the port's own step on the whole
  batch; the same step without the dp loss's count all-reduce, which must
  differ; the sharded store sampler;
* the loop group: 6 + 6 iterations against 12 straight, host sampling
  against one process on the same global batches, eval and video (and an
  NDC scene) against one process, one writer.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddnerf_tpu.config import Config as JaxConfig
from ddnerf_tpu.core import math as jax_math
from ddnerf_tpu.data.assembly import get_datasets as jax_get_datasets
from ddnerf_tpu.models.nerf import NerfPipeline as JaxPipeline
from ddnerf_tpu.models.nerf import RayBatch as JaxRays
from ddnerf_tpu.parallel import distributed as jax_dist
from ddnerf_tpu.parallel import mesh as jax_mesh
from ddnerf_tpu.train.state import create_train_state
from ddnerf_tpu.train.step import compute_loss as jax_compute_loss
from ddnerf_tpu.train.step import schedule_values as jax_schedule_values
from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.core.math import bins_for_percentage
from ddnerf_tpu_torch.data.assembly import get_datasets
from ddnerf_tpu_torch.data.datasets import PrefetchedHostBatches
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.parallel import distributed as port_dist
from ddnerf_tpu_torch.parallel import mesh as port_mesh
from ddnerf_tpu_torch.train.loop import train
from ddnerf_tpu_torch.train.state import TrainState
from ddnerf_tpu_torch.train.step import train_step
from ddnerf_tpu_torch.utils.weights import (
    params_to_state_dict,
    pipeline_state_from_params,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 120
# The port's 2-rank step against its 1-rank step on the whole batch: the
# same arithmetic but for the all-reduce's sum of two halves.
RANKS_TOL = 1e-6


# ---------------------------------------------------------------- helpers

@pytest.mark.parametrize("n_pix,shards", [(64, 8), (63, 8), (5, 8), (3, 7),
                                          (100, 1)])
def test_pad_store_pixels_matches_jax(n_pix, shards):
    """Including a pad larger than the pixel axis (5 and 3 pixels)."""
    store = np.random.default_rng(0).random((2, n_pix, 10), np.float32)
    got = port_dist.pad_store_pixels(store, shards)
    np.testing.assert_array_equal(got, jax_dist.pad_store_pixels(store,
                                                                 shards))
    assert got.shape[1] % shards == 0


def _as_process(monkeypatch, rank, count):
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: count)
    monkeypatch.setattr(port_dist, "process_index", lambda: rank)
    monkeypatch.setattr(port_dist, "process_count", lambda: count)


@pytest.mark.parametrize("n_pix,shards,count,rank", [
    (64, 2, 2, 0), (64, 2, 2, 1), (63, 4, 2, 1), (5, 8, 4, 3), (64, 8, 1, 0)])
def test_store_slices_match_jax(monkeypatch, n_pix, shards, count, rank):
    _as_process(monkeypatch, rank, count)
    store = np.random.default_rng(1).random((3, n_pix, 10), np.float32)
    padded = port_dist.pad_store_pixels(store, shards).shape[1]
    assert port_dist.process_pixel_slice(padded, shards) == \
        jax_dist.process_pixel_slice(padded, shards)
    np.testing.assert_array_equal(
        port_dist.host_local_store_slice(store, shards),
        jax_dist.host_local_store_slice(store, shards))
    block = port_dist.build_sharded_store(store, shards, "cpu")
    assert isinstance(block, torch.Tensor) and block.shape == (
        3, padded // count, 10)


@pytest.mark.parametrize("num_rays,count,rank", [
    (64, 2, 0), (64, 2, 1), (63, 2, 1), (7, 4, 3), (2048, 8, 5), (10, 1, 0)])
def test_process_ray_slice_matches_jax(monkeypatch, num_rays, count, rank):
    _as_process(monkeypatch, rank, count)
    assert port_dist.process_ray_slice(num_rays) == \
        jax_dist.process_ray_slice(num_rays)


def test_pixel_slice_mismatch_raises_as_jax(monkeypatch):
    _as_process(monkeypatch, 0, 3)
    for mod in (port_dist, jax_dist):
        with pytest.raises(ValueError, match="multiple of the process count"):
            mod.process_pixel_slice(64, 4)


@pytest.mark.parametrize("num_rays,n_dev", [(64, 2), (63, 8), (2048, 3),
                                            (1, 4), (4096, 1)])
def test_effective_batch_matches_jax(num_rays, n_dev):
    assert port_mesh._effective_batch(num_rays, n_dev) == \
        jax_mesh._effective_batch(num_rays, n_dev)


def test_bins_for_percentage_matches_jax():
    w = np.random.default_rng(2).random((16, 12), np.float32) ** 3
    for pct in (0.3, 0.5, 0.9):
        np.testing.assert_array_equal(
            bins_for_percentage(torch.tensor(w), pct).numpy(),
            np.asarray(jax_math.bins_for_percentage(jnp.asarray(w), pct)))


@pytest.mark.parametrize("n,world,error", [
    (0, 1, None), (0, 4, None), (1, 1, None), (4, 4, None),
    (1, 2, "single process.* 2 ranks"), (2, 1, "num_devices: 2.* world "
                                         "size is 1"),
    (3, 2, "num_devices: 3.* world size is 2")])
def test_num_devices_against_the_world_size(n, world, error):
    cfg = Config().replace_at("parallel.num_devices", n)
    if error is None:
        port_mesh.check_num_devices(cfg, world)
    else:
        with pytest.raises(ValueError, match=error):
            port_mesh.check_num_devices(cfg, world)


def test_cuda_device_without_a_card_raises():
    """``--device cuda`` on a rank whose card does not exist raises; it
    never runs that rank on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        port_mesh.rank_device("cuda", 1)
    assert port_mesh.rank_device("cpu", 1) == torch.device("cpu")


@pytest.mark.parametrize("start,stop,total,rows", [
    (0, 5, 10, 5), (5, 10, 10, 5), (8, 10, 10, 3), (10, 10, 10, 2)])
def test_row_share_keeps_this_ranks_rows_of_the_whole_draw(start, stop,
                                                           total, rows):
    """With ``rows`` a draw is the whole chunk's, from the same generator
    state, cut to this rank's rows and padded with its last drawn row (a
    rank with no real rows gets the chunk's last)."""
    from ddnerf_tpu_torch.core import draws

    whole = torch.rand((total, 4), generator=torch.Generator().manual_seed(3))
    got = draws.rand((rows, 4), generator=torch.Generator().manual_seed(3),
                     rows=(start, stop, total))
    want = whole[start:stop] if stop > start else whole[-1:]
    assert got.shape == (rows, 4)
    assert torch.equal(got[:len(want)], want[:rows])
    assert torch.equal(got[len(want):], want[-1:].expand(rows - len(want), 4))
    plain = draws.randn((rows, 4), generator=torch.Generator().manual_seed(3))
    assert torch.equal(plain, torch.randn(
        (rows, 4), generator=torch.Generator().manual_seed(3)))


def _tiny_dict(logdir="", **over):
    d = {
        "experiment": {"id": "run", "logdir": str(logdir), "train_iters": 12,
                       "validate_every": 5, "save_every": 3,
                       "print_every": 4, "max_keep_ckpts": 2},
        "optimizer": {"lr_init": 1e-3, "lr_final": 1e-4,
                      "lr_delay_steps": 0},
        "nerf": {
            "type": "DDNerfModel", "coarse_hidden_size": 16,
            "fine_hidden_size": 16,
            "train": {"num_coarse": 4, "num_fine": 4, "num_random_rays": 64,
                      "perturb": False, "radiance_field_noise_std": 0.0},
            "validation": {"num_coarse": 4, "num_fine": 4, "perturb": False,
                           "chunksize": 1000},
        },
        "dataset": {"type": "blender", "synthetic": True,
                    "single_image_mode": True},
        "parallel": {"compute_dtype": "float32"},
    }
    for section, values in over.items():
        d[section] = {**d.get(section, {}), **values}
    return d


def test_num_devices_two_in_one_process_raises(tmp_path):
    """The config asks for two ranks; one process was launched: the run
    raises with both numbers instead of training on one device."""
    cfg = Config.from_dict(_tiny_dict(
        tmp_path, parallel={"num_devices": 2})).resolved()
    with pytest.raises(ValueError, match="num_devices: 2.* world size is 1"):
        train(cfg, max_iters=1, device="cpu", verbose=False)
    assert not os.path.exists(os.path.join(tmp_path, "run", "config.yml"))


@pytest.mark.parametrize("rank", [0, 1])
def test_host_sampling_draws_the_jax_loops_global_batches(monkeypatch, rank):
    """Each rank draws the whole global batch from the seeded generator, as
    the JAX loop does (``ddnerf_tpu/train/loop.py:122-147``), and keeps its
    ``process_ray_slice``."""
    d = _tiny_dict(dataset={"single_image_mode": False})
    train_ds, _, _ = get_datasets(Config.from_dict(d).resolved())
    jax_ds, _, _ = jax_get_datasets(JaxConfig.from_dict(d).resolved())
    _as_process(monkeypatch, rank, 2)
    rows = port_dist.process_ray_slice(64)
    batches = PrefetchedHostBatches(train_ds, 64, 42, "cpu", 3, rows=rows)
    rng = np.random.default_rng(42)
    for _ in range(3):
        got = batches.take()
        batches.prefetch()
        want = jax_ds.sample_batch(rng, 64)
        for key, w in zip(("origins", "directions", "radii", "rgb"), want):
            np.testing.assert_array_equal(got[key].numpy(), w[rows])


# ------------------------------------------------------- two gloo ranks

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(program: str, *args: str, ranks: int = 2) -> list:
    """Run ``program`` as ``ranks`` processes of one gloo group (torchrun's
    environment, a free port) -> their stdouts; each has its own timeout,
    and a rank that fails or hangs fails the test with its stderr."""
    port = _free_port()
    procs = []
    for rank in range(ranks):
        env = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), RANK=str(rank),
                   LOCAL_RANK=str(rank), WORLD_SIZE=str(ranks),
                   LOCAL_WORLD_SIZE=str(ranks), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", program, *args], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for rank, proc in enumerate(procs):
            out, err = proc.communicate(timeout=SPAWN_TIMEOUT)
            assert proc.returncode == 0, f"rank {rank}: {err[-4000:]}"
            outs.append(out)
    finally:
        for proc in procs:
            proc.kill()
    return outs


_STEP_PROGRAM = r"""
import pickle, sys, warnings
import torch
from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.parallel import distributed as pdist
from ddnerf_tpu_torch.parallel import mesh as pmesh
from ddnerf_tpu_torch.train.state import TrainState
from ddnerf_tpu_torch.train.step import train_step

root = sys.argv[1]
mesh = pmesh.init_group("cpu")
with open(f"{root}/inputs.pkl", "rb") as f:
    inputs = pickle.load(f)
res = {}
for family, inp in inputs.items():
    cfg = Config.from_dict(inp["cfg"]).resolved()
    sl = pdist.process_ray_slice(len(inp["batch"]["origins"]))
    batch = {k: torch.tensor(v[sl]) for k, v in inp["batch"].items()}
    for fault in ((False, True) if family == "dd" else (False,)):
        mesh.global_dp_count = not fault
        pipe = NerfPipeline(cfg, "cpu", mesh=mesh)
        pipe.load_state_dicts(**inp["state"])
        state = TrainState(cfg, pipe)
        m = train_step(cfg, pipe, state, batch)
        res[(family, fault)] = {
            "metrics": {k: float(v) for k, v in m.items()},
            "grads": [p.grad.clone() for p in pipe.parameters()],
            "params": [p.detach().clone() for p in pipe.parameters()]}
mesh.global_dp_count = True

# The sampler on a marker store: rgb = (image, pixel / n_pix, 0).
store = torch.zeros((3, 64, 10)).numpy()
store[..., 6] = 0.002
store[..., 7] = torch.arange(3.0)[:, None].numpy()
store[..., 8] = (torch.arange(64.0) / 64)[None].numpy()
block = pdist.build_sharded_store(store, mesh.size, "cpu")
draws = {}
for single in (False, True):
    sampler = pmesh.ShardedStoreSampler(mesh, block, 64, single, seed=3)
    draws[single] = [sampler.draw()["rgb"].clone() for _ in range(4)]
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    odd = pmesh.ShardedStoreSampler(mesh, block, 63, False, seed=3)
res["sampler"] = {"draws": draws, "odd": (odd.effective_num_rays,
                                          odd.draw()["rgb"].shape[0],
                                          [str(w.message) for w in caught])}
res["images"] = mesh.gather_objects(
    [d[:, 0].unique().tolist() for d in draws[True]])
with open(f"{root}/rank{mesh.rank}.pkl", "wb") as f:
    pickle.dump(res, f)
pmesh.destroy_group()
"""


def _jax_cfg(family):
    """``tests/test_parallel.py::tiny_cfg`` (the optimizer's defaults: a
    step moves a parameter by at most 5e-6) with the port's float32."""
    d = _tiny_dict(dataset={"single_image_mode": False})
    del d["optimizer"]
    if family == "mip":
        d["nerf"]["type"] = "GeneralMipNerfModel"
    return d


@pytest.fixture(scope="module")
def step_group(tmp_path_factory):
    """One 64-ray batch of the synthetic scene whose first half holds 12
    empty rays and whose second half 2 (rays shrunk to 1e-12 length cross
    no density), JAX's initial parameters of each family, and the 2-rank
    program's results per rank."""
    root = tmp_path_factory.mktemp("step_group")
    inputs = {}
    for family in ("dd", "mip"):
        d = _jax_cfg(family)
        jcfg = JaxConfig.from_dict(d).resolved()
        train_ds, _, jcfg = jax_get_datasets(jcfg)
        ro, rd, radii, rgb = train_ds.sample_batch(np.random.default_rng(0),
                                                   64)
        rd = rd.copy()
        rd[:12] *= 1e-12
        rd[32:34] *= 1e-12
        params = jax.tree_util.tree_map(
            np.asarray, JaxPipeline(jcfg).init_params(jax.random.PRNGKey(0)))
        inputs[family] = {
            "cfg": d, "params": params,
            "state": pipeline_state_from_params(params),
            "batch": {"origins": ro, "directions": rd, "radii": radii,
                      "rgb": rgb}}
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump({k: {kk: v for kk, v in inp.items() if kk != "params"}
                     for k, inp in inputs.items()}, f)
    _spawn(_STEP_PROGRAM, str(root))
    ranks = []
    for rank in range(2):
        with open(root / f"rank{rank}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return inputs, ranks


def _one_rank(inp):
    cfg = Config.from_dict(inp["cfg"]).resolved()
    pipe = NerfPipeline(cfg, "cpu")
    pipe.load_state_dicts(**inp["state"])
    state = TrainState(cfg, pipe)
    batch = {k: torch.tensor(v) for k, v in inp["batch"].items()}
    m = train_step(cfg, pipe, state, batch)
    return pipe, {k: float(v) for k, v in m.items()}, \
        [p.grad.clone() for p in pipe.parameters()]


def test_batch_halves_hold_different_numbers_of_empty_rays(step_group):
    """The premise of the dp-loss tests: the fine weights of 12 rays of the
    first half and of 2 of the second sum to no more than 1e-10."""
    inputs, _ = step_group
    inp = inputs["dd"]
    cfg = Config.from_dict(inp["cfg"]).resolved()
    pipe = NerfPipeline(cfg, "cpu")
    pipe.load_state_dicts(**inp["state"])
    from ddnerf_tpu_torch.models.nerf import RayBatch, ScheduleValues

    b = inp["batch"]
    out = pipe.render_rays(
        RayBatch.create(*(torch.tensor(b[k]) for k in
                          ("origins", "directions", "radii")), 2.0, 6.0),
        ScheduleValues(1.0, False), "validation")
    empty = (out[1]["weights"].sum(1) <= 1e-10).numpy()
    assert (empty[:32].sum(), empty[32:].sum()) == (12, 2)


@pytest.mark.parametrize("family", ["dd", "mip"])
def test_sharded_step_matches_jax_mesh_step(step_group, family):
    """The port's 2-rank gloo step against JAX's ``make_sharded_train_step``
    on a 2-device mesh from the same parameters and batch, held to
    ``tests/test_parallel.py``'s tolerances."""
    inputs, ranks = step_group
    inp = inputs[family]
    jcfg = JaxConfig.from_dict(inp["cfg"]).resolved()
    pipe = JaxPipeline(jcfg)
    state = create_train_state(jcfg, pipe, jax.random.PRNGKey(0))
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                        inp["params"]))
    mesh = jax_mesh.make_mesh(2)
    step = jax_mesh.make_sharded_train_step(
        jcfg.replace_at("parallel.donate_state", False), pipe, mesh)
    batch = jax_mesh.shard_batch(mesh, {k: jnp.asarray(v)
                                        for k, v in inp["batch"].items()})
    s2, m2 = step(state, batch)
    got = ranks[0][(family, False)]
    np.testing.assert_allclose(got["metrics"]["loss"], float(m2["loss"]),
                               rtol=1e-4)
    want = pipeline_state_from_params(jax.tree_util.tree_map(np.asarray,
                                                             s2.params))
    port = NerfPipeline(Config.from_dict(inp["cfg"]).resolved(), "cpu")
    names = [f"{net}.{n}" for net, m in (("coarse", port.coarse),
                                         ("fine", port.fine)) if m is not None
             for n, _ in m.named_parameters()]
    for name, p in zip(names, got["params"]):
        net, leaf = name.split(".", 1)
        np.testing.assert_allclose(p.numpy(), want[net][leaf].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)

    # The step moves no parameter by more than 5e-6, so the gradients
    # themselves too: against JAX's on the whole batch (what the sharded
    # step computes), at tests/test_torch_port_train.py's tolerances.
    b = {k: jnp.asarray(v) for k, v in inp["batch"].items()}

    def loss_fn(p):
        return jax_compute_loss(
            jcfg, pipe, p, JaxRays.create(b["origins"], b["directions"],
                                          b["radii"], 2.0, 6.0),
            b["rgb"], jax.random.PRNGKey(3), jax_schedule_values(jcfg, 0))

    _, jgrads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    for name, g in zip(names, got["grads"]):
        net, leaf = name.split(".", 1)
        w = params_to_state_dict(jgrads[net])[leaf].numpy()
        np.testing.assert_allclose(
            g.numpy(), w, rtol=5e-3, atol=5e-5 * max(1.0, np.abs(w).max()),
            err_msg=name)


@pytest.mark.parametrize("family", ["dd", "mip"])
def test_sharded_step_equals_one_rank_step(step_group, family):
    """Both ranks end with the same parameters, and they, the gradients
    and every metric equal one process's step on the whole batch."""
    inputs, ranks = step_group
    _, metrics, grads = _one_rank(inputs[family])
    got = ranks[0][(family, False)]
    for a, b in zip(got["params"], ranks[1][(family, False)]["params"]):
        assert torch.equal(a, b)
    assert set(got["metrics"]) == set(metrics)
    for key, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][key], v, rtol=RANKS_TOL,
                                   atol=RANKS_TOL, err_msg=key)
    for g2, g1 in zip(got["grads"], grads):
        np.testing.assert_allclose(g2.numpy(), g1.numpy(), rtol=RANKS_TOL,
                                   atol=RANKS_TOL * max(1.0, g1.abs().max()))


def test_step_without_the_count_all_reduce_differs(step_group):
    """The injected fault: each rank divides its masked dp sum by its own
    kept count (12 and 2 empty rays make the counts 20 and 30), the mean of
    per-rank masked means.  The coarse net's gradients then leave the
    one-rank values by far more than the correct step does (its largest
    leaf gap, relative to the leaf's largest element, read 5.0e-7 on the
    CPU, the fault's 9.3e-3)."""
    inputs, ranks = step_group
    _, _, grads = _one_rank(inputs["dd"])

    def largest_gap(got):
        return max(float((g2 - g1).abs().max() / g1.abs().max())
                   for g2, g1 in zip(got, grads) if g1.abs().max() > 0)

    assert largest_gap(ranks[0][("dd", False)]["grads"]) < RANKS_TOL
    assert largest_gap(ranks[0][("dd", True)]["grads"]) > 1000 * RANKS_TOL


def test_sampler_draws_from_its_own_block(step_group):
    """Rank r's rows come from pixel columns [r/2, (r+1)/2)."""
    _, ranks = step_group
    for rank, res in enumerate(ranks):
        for rows in res["sampler"]["draws"][False]:
            assert rows.shape == (32, 3)
            px = rows[:, 1]
            assert (px >= rank / 2).all() and (px < (rank + 1) / 2).all()


def test_sampler_single_image_mode_same_image_on_every_rank(step_group):
    """Under single_image_mode every rank draws from the same image at
    every step, and the image changes between steps."""
    _, ranks = step_group
    per_rank = ranks[0]["images"]
    assert per_rank == ranks[1]["images"]
    assert per_rank[0] == per_rank[1]
    assert all(len(img) == 1 for img in per_rank[0])
    assert len({img[0] for img in per_rank[0]}) > 1


def test_sampler_indivisible_batch_warns(step_group):
    _, ranks = step_group
    effective, rows, said = ranks[0]["sampler"]["odd"]
    assert (effective, rows) == (64, 32)
    assert any("effective batch is 64" in w for w in said)
