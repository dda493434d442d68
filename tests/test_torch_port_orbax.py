"""A run trained with the JAX package, carried into the port by
``scripts/orbax_to_ckpt.py``: 3 jitted steps of a 32-wide DDNeRF on the
synthetic scene saved through the JAX ``CheckpointManager`` (orbax) and
converted.  The port's eval of the converted directory writes the
results.txt of the JAX eval of the original (2e-3, the f32 slice); one
more step on the same batch in both packages gives the same parameters
(the trajectory test's tolerances) and the same update, which needs
Adam's moments and count to have come across; the port's train CLI
resumes the directory; and a converted file without the marker that
stands in for the generator's state refuses to resume."""

import importlib.util
import os
import re
import shutil
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddnerf_tpu.config import Config as JaxConfig
from ddnerf_tpu.data.assembly import get_datasets as jax_get_datasets
from ddnerf_tpu.eval.evaluate import eval_model as jax_eval_model
from ddnerf_tpu.models.nerf import NerfPipeline as JaxPipeline
from ddnerf_tpu.train import checkpoint as jax_ckpt
from ddnerf_tpu.train.state import create_train_state
from ddnerf_tpu.train.step import make_train_step
from ddnerf_tpu_torch.cli import train as train_cli
from ddnerf_tpu_torch.eval.evaluate import eval_model
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.train import checkpoint as ckpt
from ddnerf_tpu_torch.train.state import TrainState
from ddnerf_tpu_torch.train.step import train_step
from ddnerf_tpu_torch.utils.weights import params_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, RAYS, LR = 3, 64, 1e-3
TOL = 2e-3  # the f32 slice, as tests/test_torch_port_pipeline.py
# As tests/test_torch_port_trajectory.py, for one step.
WEIGHT_NORM_REL_TOL, WEIGHT_MAX_ABS = 1e-3, LR
# The update of the step after the conversion, ||u_port - u_jax|| /
# ||u_jax|| per leaf: summation order only when the moments came across;
# from fresh moments Adam's first update is lr * sign(g), another update
# (over the whole model; a leaf whose gradient kept its sign can agree).
UPDATE_REL_TOL, FRESH_UPDATE_REL_MIN = 1e-2, 0.1


def _script():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_ckpt", os.path.join(REPO, "scripts", "orbax_to_ckpt.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("orbax")
    jcfg = JaxConfig.from_dict({
        "experiment": {"id": "jax_run", "logdir": str(root),
                       "train_iters": 100, "randomseed": 5},
        "optimizer": {"lr_init": LR, "lr_final": 1e-4, "lr_delay_steps": 0},
        "nerf": {
            "type": "DDNerfModel", "coarse_hidden_size": 32,
            "fine_hidden_size": 32,
            "train": {"num_coarse": 6, "num_fine": 6, "num_random_rays": RAYS,
                      "perturb": False, "radiance_field_noise_std": 0.0},
            "validation": {"num_coarse": 6, "num_fine": 6, "perturb": False,
                           "radiance_field_noise_std": 0.0,
                           "chunksize": 1024},
        },
        "dataset": {"type": "blender", "synthetic": True,
                    "single_image_mode": False},
        "parallel": {"compute_dtype": "float32", "pallas_mlp": "off",
                     "fetch_dtype": "float32", "num_devices": 1},
    }).resolved()
    logdir = os.path.join(str(root), "jax_run")
    jtrain, _, jcfg = jax_get_datasets(jcfg)
    jpipe = JaxPipeline(jcfg)
    jstate = create_train_state(jcfg, jpipe, jax.random.PRNGKey(0))
    jstep = jax.jit(make_train_step(jcfg, jpipe))
    rng = np.random.default_rng(2)

    def batch():
        return dict(zip(("origins", "directions", "radii", "rgb"),
                        jtrain.sample_batch(rng, RAYS)))

    for _ in range(STEPS):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in batch().items()})
    jax_ckpt.save_config_snapshot(jcfg, logdir)
    manager = jax_ckpt.CheckpointManager(logdir)
    manager.save(jstate)
    manager.wait()
    manager.close()
    port_dir = os.path.join(str(root), "port_run")
    path = _script().convert(logdir, out=port_dir)
    return types.SimpleNamespace(
        jcfg=jcfg, jpipe=jpipe, jstate=jstate, jstep=jstep, logdir=logdir,
        port_dir=port_dir, path=path, next_batch=batch())


def test_conversion_writes_the_ports_layout(run):
    assert run.path == os.path.join(run.port_dir, f"checkpoint_{STEPS}.ckpt")
    assert os.path.isfile(os.path.join(run.port_dir, "config.yml"))
    saved = torch.load(run.path, map_location="cpu", weights_only=True)
    assert saved["iter"] == STEPS
    assert ckpt.GENERATOR_SEED_KEY in saved and ckpt.GENERATOR_KEY not in saved
    state = saved[ckpt.OPTIMIZER_KEY]["state"]
    # 13 layers in the coarse net, 12 in the fine one (no mu / sigma head).
    assert len(state) == (13 + 12) * 2
    assert {int(e["step"]) for e in state.values()} == {STEPS}
    want = params_to_state_dict(run.jstate.params["fine"])
    for name, value in want.items():
        torch.testing.assert_close(saved["model_2_state_dict"][name], value,
                                   rtol=0, atol=0)


def _results(path):
    with open(path) as f:
        return dict(re.findall(r"^((?:image \d+ , )?\w+): \t (\S+)$",
                               f.read(), re.M))


def test_port_eval_of_the_converted_run_matches_jax_eval(run):
    jax_eval_model(run.logdir, save_images=False, max_images=2)
    eval_model(run.port_dir, save_images=False, max_images=2, device="cpu")
    want = _results(os.path.join(run.logdir, "validation", "results.txt"))
    got = _results(os.path.join(run.port_dir, "validation", "results.txt"))
    assert set(got) == set(want) and "psnr_fine" in got
    assert "image 1 , ssim_v1_fine" in got
    for key, value in want.items():
        if key.endswith("time_sec"):  # each package's own render time
            continue
        np.testing.assert_allclose(float(got[key]), float(value), rtol=TOL,
                                   atol=TOL, err_msg=key)


def _port_state(run, path):
    cfg = ckpt.load_config_snapshot(run.port_dir)
    pipe = NerfPipeline(cfg, "cpu")
    state = TrainState(cfg, pipe)
    gen = torch.Generator()
    if path is not None:
        assert ckpt.load_train_checkpoint(path, pipe, state, gen) == STEPS
    return cfg, pipe, state, gen


def test_one_more_step_matches_jax(run, capsys):
    cfg, pipe, state, gen = _port_state(run, run.path)
    out = capsys.readouterr().out
    seed = ckpt.converted_seed(5, STEPS)
    assert f"seeded with {seed}, from experiment.randomseed 5 and step 3" \
        in out
    assert torch.equal(gen.get_state(),
                       torch.Generator().manual_seed(seed).get_state())
    before = {net: {n: p.detach().clone()
                    for n, p in getattr(pipe, net).named_parameters()}
              for net in ("coarse", "fine")}
    # The same weights, without the moments: Adam from its first update.
    _, fresh_pipe, fresh_state, _ = _port_state(run, None)
    fresh_pipe.load_state_dicts(before["coarse"], before["fine"])
    fresh_state.step = STEPS

    batch = run.next_batch
    jstate, jm = run.jstep(run.jstate, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    m = train_step(cfg, pipe, state,
                   {k: torch.tensor(v) for k, v in batch.items()})
    train_step(cfg, fresh_pipe, fresh_state,
               {k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=1e-4)
    assert state.step == int(jstate.step) == STEPS + 1
    updates, fresh_updates = [], []
    for net in ("coarse", "fine"):
        want = params_to_state_dict(jstate.params[net])
        fresh = dict(getattr(fresh_pipe, net).named_parameters())
        for name, p in getattr(pipe, net).named_parameters():
            diff = p.detach() - want[name]
            assert (diff.norm() / want[name].norm()).item() <= \
                WEIGHT_NORM_REL_TOL, (net, name)
            assert diff.abs().max().item() <= WEIGHT_MAX_ABS, (net, name)
            update = want[name] - before[net][name]
            gap = ((p.detach() - before[net][name] - update).norm()
                   / update.norm()).item()
            assert gap <= UPDATE_REL_TOL, (net, name, gap)
            updates.append(update.flatten())
            fresh_updates.append((fresh[name].detach()
                                  - before[net][name]).flatten())
    # Over the whole model: from fresh moments the step goes elsewhere.
    update, fresh_update = torch.cat(updates), torch.cat(fresh_updates)
    fresh_gap = ((fresh_update - update).norm() / update.norm()).item()
    assert fresh_gap >= FRESH_UPDATE_REL_MIN, fresh_gap


def test_port_train_cli_resumes_the_converted_run(run, tmp_path, capsys):
    """The converted directory copied elsewhere, as onto the card's
    machine: the CLI goes on from step 3 with the seeded generator."""
    logdir = str(tmp_path / "copied")
    shutil.copytree(run.port_dir, logdir)
    train_cli.main(["--config", os.path.join(logdir, "config.yml"),
                    "--max-iters", str(STEPS + 2), "--device", "cpu",
                    "experiment.logdir", str(tmp_path), "experiment.id",
                    "copied", "experiment.validate_every", "100"])
    out = capsys.readouterr().out
    assert f"at iteration {STEPS}" in out and "holds no generator state" in out
    assert re.search(rf"^\[TRAIN\] iter {STEPS + 1} loss \S+", out, re.M)
    saved = torch.load(ckpt.step_path(logdir, STEPS + 2), map_location="cpu",
                       weights_only=True)
    assert ckpt.GENERATOR_KEY in saved  # the resumed run saves its own


def test_converted_file_without_the_marker_refuses_to_resume(run, tmp_path):
    saved = torch.load(run.path, map_location="cpu", weights_only=True)
    del saved[ckpt.GENERATOR_SEED_KEY]
    path = str(tmp_path / f"checkpoint_{STEPS}.ckpt")
    torch.save(saved, path)
    with pytest.raises(ValueError, match="holds no generator_state: it can "
                                         "be evaluated, not resumed"):
        _port_state(run, path)
