"""The port's training loop against the JAX package's: the block loop's
records (``metrics.jsonl``: which iterations, which keys) and its block
boundaries, host-side ray sampling with a prefetched batch (the same rays as
the JAX package's host path, the host rng drawn no more often than a
synchronous loop, losses along 5 steps), ``--profile-steps``,
``--debug-nans`` and ``assert_finite_tree``, ``verbose=False``, and the
optimizer state's one file layout under the plain and the ``capturable``
Adam.  All on the CPU, where the block loop's body is the eager step."""

import ast
import glob
import inspect
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddnerf_tpu.config import Config as JaxConfig
from ddnerf_tpu.data.assembly import get_datasets as jax_get_datasets
from ddnerf_tpu.data.datasets import TrainRayDataset as JaxTrainRayDataset
from ddnerf_tpu.models.nerf import NerfPipeline as JaxPipeline
from ddnerf_tpu.train import loop as jax_loop
from ddnerf_tpu.train.state import create_train_state
from ddnerf_tpu.train.step import make_train_step
from ddnerf_tpu.utils.debug import assert_finite_tree as jax_assert_finite_tree
from ddnerf_tpu_torch.cli import train as train_cli
from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.data.assembly import get_datasets
from ddnerf_tpu_torch.data.datasets import (
    PrefetchedHostBatches,
    TrainRayDataset,
    load_train_store,
    sample_rays_on_device,
)
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.train import checkpoint as ckpt
from ddnerf_tpu_torch.train import loop as port_loop
from ddnerf_tpu_torch.train.state import TrainState
from ddnerf_tpu_torch.train.step import (
    EagerTrainStep,
    train_step,
    train_step_from_store,
)
from ddnerf_tpu_torch.utils import profiling
from ddnerf_tpu_torch.utils.debug import assert_finite_tree, nan_debug_mode
from ddnerf_tpu_torch.utils.weights import params_to_state_dict

# As tests/test_torch_port_trajectory.py: f32 on both sides, summation
# order only; the dp loss takes logs of small masses.
LOSS_RTOL, DP_LOSS_RTOL = 1e-4, 1e-3


def _dict(logdir, **over):
    d = {
        "experiment": {"id": "run", "logdir": str(logdir), "train_iters": 9,
                       "validate_every": 3, "save_every": 5, "print_every": 4},
        "optimizer": {"lr_init": 1e-3, "lr_final": 1e-4, "lr_delay_steps": 0},
        "nerf": {
            "type": "DDNerfModel", "coarse_hidden_size": 16,
            "fine_hidden_size": 16,
            "train": {"num_coarse": 4, "num_fine": 4, "num_random_rays": 32,
                      "perturb": False, "radiance_field_noise_std": 0.0},
            "validation": {"num_coarse": 4, "num_fine": 4, "perturb": False,
                           "radiance_field_noise_std": 0.0,
                           "chunksize": 4096},
        },
        "dataset": {"type": "blender", "synthetic": True,
                    "single_image_mode": False},
        "parallel": {"compute_dtype": "float32", "pallas_mlp": "off",
                     "num_devices": 1},
    }
    for section, values in over.items():
        d[section] = {**d.get(section, {}), **values}
    return d


def _cfg(logdir, **over):
    return Config.from_dict(_dict(logdir, **over)).resolved()


def _jcfg(logdir, **over):
    return JaxConfig.from_dict(_dict(logdir, **over)).resolved()


def _train_records(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "train"]


# ------------------------------------------------------------ boundaries


def _jax_next_boundary(print_every, validate_every, save_every, total):
    """The JAX loop's ``next_boundary``, a closure of its ``train``: its
    own source, compiled with the names it closes over."""
    tree = ast.parse(inspect.getsource(jax_loop))
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "next_boundary")
    scope = {"total_iters": total, "cfg": types.SimpleNamespace(
        experiment=types.SimpleNamespace(print_every=print_every,
                                         validate_every=validate_every,
                                         save_every=save_every))}
    exec(compile(ast.Module([fn], type_ignores=[]), "<next_boundary>", "exec"),
         scope)
    return scope["next_boundary"]


@pytest.mark.parametrize("everys", [(4, 3, 5), (5, 5, 5), (1, 7, 3),
                                    (100, 50, 20), (7, 11, 13), (2, 4, 8),
                                    (10, 1, 10), (6, 9, 4)])
def test_next_boundary_equals_the_jax_loops(everys):
    for total in (1, 2, 9, 30, 101):
        want = _jax_next_boundary(*everys, total)
        for i in range(total):
            got = port_loop.next_boundary(i, *everys, total)
            assert got == want(i), (i, total)
            assert i <= got <= total - 1


# --------------------------------------------------------------- records


@pytest.mark.parametrize("scalars_every", [1, 3])
def test_block_loop_writes_the_jax_loops_records(tmp_path, scalars_every,
                                                 capsys):
    """Print, validate and save events that do not divide each other (4, 3,
    5 over 9 iterations: blocks of 1, 3, 1, 1, 1, 2): the port's block
    loop (on the CPU its body is the eager step) writes a train record
    for the same iterations with the same keys as the JAX loop, and
    ``rays_per_sec`` on the same ones."""
    over = {"experiment": {"train_scalars_every": scalars_every}}
    _, jdir = jax_loop.train(_jcfg(tmp_path / "jax", **over),
                             use_tensorboard=False, verbose=False)
    _, pdir = port_loop.train(_cfg(tmp_path / "port", **over), device="cpu")
    out = capsys.readouterr().out
    assert "step mode: eager, blocks" in out
    want, got = _train_records(jdir), _train_records(pdir)
    assert [r["step"] for r in got] == [r["step"] for r in want]
    if scalars_every == 1:
        assert [r["step"] for r in got] == list(range(9))
    else:  # multiples of 3, the print events 4 and 8
        assert [r["step"] for r in got] == [0, 3, 4, 6, 8]
    for w, g in zip(want, got):
        assert set(g) == set(w), w["step"]
    # rays_per_sec rides on the record of a block's last iteration.
    for recs in (want, got):
        assert [r["step"] for r in recs if "rays_per_sec" in r] == [
            r["step"] for r in recs if r["step"] in (0, 3, 4, 5, 6, 8)]
    assert all(np.isfinite(r["loss"]) for r in got)
    # The lines: [TRAIN] at the print events and the last iteration, [VAL]
    # at the validation events.
    printed = {tag: [int(ln.split()[2]) for ln in out.splitlines()
                     if ln.startswith(tag)] for tag in ("[TRAIN]", "[VAL]")}
    assert printed == {"[TRAIN]": [0, 4, 8], "[VAL]": [0, 3, 6, 8]}
    assert ckpt.all_steps(pdir) == [9]


def test_per_iteration_loop_without_scalars_records_print_events(tmp_path):
    """``train_scalars_every: 0`` leaves the block loop (as in JAX): a
    record at the print events only."""
    cfg = _cfg(tmp_path, experiment={"train_scalars_every": 0})
    _, logdir = port_loop.train(cfg, device="cpu", verbose=False)
    recs = _train_records(logdir)
    assert [r["step"] for r in recs] == [0, 4, 8]
    assert all("rays_per_sec" in r for r in recs)


def test_verbose_false_silences_the_lines_not_the_records(tmp_path, capsys):
    _, logdir = port_loop.train(_cfg(tmp_path), device="cpu", verbose=False)
    out = capsys.readouterr().out
    assert "[TRAIN]" not in out and "[VAL]" not in out
    assert "step mode" not in out
    assert len(_train_records(logdir)) == 9
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        assert sum(json.loads(ln)["kind"] == "validation" for ln in f) == 4


def test_eager_block_equals_single_steps_bitwise(tmp_path):
    """``EagerTrainStep.run(k)`` is ``k`` calls of ``train_step_from_store``
    with their metrics stacked, nothing else."""
    cfg = _cfg(tmp_path, nerf={"train": {
        "num_coarse": 4, "num_fine": 4, "num_random_rays": 32,
        "perturb": True, "radiance_field_noise_std": 1.0}})
    store, _, cfg = load_train_store(cfg, "cpu")
    runs = []
    for blocks in ((5,), (2, 3), None):
        pipe = NerfPipeline(cfg, "cpu", seed=3)
        state = TrainState(cfg, pipe)
        gen = torch.Generator().manual_seed(9)
        if blocks is None:
            ms = [train_step_from_store(cfg, pipe, state, store, gen)
                  for _ in range(5)]
            names = list(ms[0])
            rows = torch.stack([torch.stack(list(m.values())) for m in ms])
        else:
            stepper = EagerTrainStep.from_store(cfg, pipe, state, store, gen)
            rows = torch.cat([stepper.run(k) for k in blocks])
            names = stepper.names
        runs.append((names, rows, [p.detach().clone()
                                   for p in pipe.parameters()]))
        assert state.step == 5
    for names, rows, params in runs[1:]:
        assert names == runs[0][0] and names[-1] == "lr"
        assert torch.equal(rows, runs[0][1])
        assert all(torch.equal(a, b) for a, b in zip(params, runs[0][2]))


def test_single_image_draw_is_the_indexed_store(tmp_path):
    """The flat gather of ``single_image_mode`` reads the rows that
    ``store[img, idx]`` names."""
    store = torch.arange(3 * 7 * 10, dtype=torch.float32).reshape(3, 7, 10)
    got = sample_rays_on_device(store, torch.Generator().manual_seed(4), 50,
                                True)
    gen = torch.Generator().manual_seed(4)
    img = torch.randint(0, 3, (), generator=gen)
    idx = torch.randint(0, 7, (50,), generator=gen)
    assert torch.equal(torch.cat(got, -1), store[int(img), idx])


# --------------------------------------------------- host-side sampling


class _Spy:
    """Records what a dataset class's ``sample_batch`` returns."""

    def __init__(self, monkeypatch, cls):
        self.batches = []
        real = cls.sample_batch

        def spy(ds, rng, num_rays):
            out = real(ds, rng, num_rays)
            self.batches.append(out)
            return out

        monkeypatch.setattr(cls, "sample_batch", spy)


def test_host_sampling_draws_the_jax_loops_batches(tmp_path, monkeypatch,
                                                   capsys):
    """``parallel.max_store_gb 0`` keeps the store on the host in both
    packages: over 5 iterations both loops draw exactly the same 5 batches
    from ``default_rng(randomseed)``, one per step and none after the
    last, and the port says which loop it runs."""
    over = {"parallel": {"max_store_gb": 0.0},
            "experiment": {"randomseed": 7}}
    jspy, pspy = _Spy(monkeypatch, JaxTrainRayDataset), _Spy(monkeypatch,
                                                             TrainRayDataset)
    jax_loop.train(_jcfg(tmp_path / "jax", **over), max_iters=5,
                   use_tensorboard=False, verbose=False)
    state, logdir = port_loop.train(_cfg(tmp_path / "port", **over),
                                    max_iters=5, device="cpu")
    out = capsys.readouterr().out
    assert "step mode: eager, one iteration at a time, rays sampled on the " \
           "host one batch ahead" in out
    assert state.step == 5
    assert len(jspy.batches) == len(pspy.batches) == 5
    for want, got in zip(jspy.batches, pspy.batches):
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    assert [r["step"] for r in _train_records(logdir)] == list(range(5))
    with pytest.raises(ValueError, match="step_mode='graph'"):
        port_loop.train(_cfg(tmp_path / "graph", **over), max_iters=2,
                        device="cpu", step_mode="graph")


def test_host_sampled_steps_match_jax_over_five_steps(tmp_path):
    """Both packages sample their own dataset with their own
    ``default_rng(0)``: the same rays, so from transplanted weights the
    losses of 5 Adam steps agree (the port through the prefetching
    stepper, JAX through its jitted ``make_train_step``)."""
    jcfg, cfg = _jcfg(tmp_path), _cfg(tmp_path)
    jtrain, _, jcfg = jax_get_datasets(jcfg)
    ptrain, _, cfg = get_datasets(cfg)
    jpipe = JaxPipeline(jcfg)
    jstate = create_train_state(jcfg, jpipe, jax.random.PRNGKey(0))
    jstep = jax.jit(make_train_step(jcfg, jpipe))
    pipe = NerfPipeline(cfg, "cpu")
    pipe.load_state_dicts(params_to_state_dict(jstate.params["coarse"]),
                          params_to_state_dict(jstate.params["fine"]))
    state = TrainState(cfg, pipe)
    batches = PrefetchedHostBatches(ptrain, 32, 0, "cpu", steps_expected=5)
    stepper = EagerTrainStep(cfg, pipe, state, batches.take, None,
                             after_dispatch=batches.prefetch)
    rows = stepper.run(5)
    assert batches.draws == 5
    with pytest.raises(RuntimeError, match="batch 6 of 5"):
        batches.take()
    jrng = np.random.default_rng(0)
    for i in range(5):
        ro, rd, radii, rgb = jtrain.sample_batch(jrng, 32)
        jstate, jm = jstep(jstate, {
            "origins": jnp.asarray(ro), "directions": jnp.asarray(rd),
            "radii": jnp.asarray(radii), "rgb": jnp.asarray(rgb)})
        # The keys tests/test_torch_port_trajectory.py compares.
        for key in ("loss", "loss_fine", "dp_loss", "psnr_fine", "lr"):
            np.testing.assert_allclose(
                rows[i, stepper.names.index(key)].item(), float(jm[key]),
                err_msg=f"{i} {key}",
                rtol=DP_LOSS_RTOL if key == "dp_loss" else LOSS_RTOL)
        assert set(stepper.names) == set(jm)


@pytest.mark.parametrize("prefetch", [True, False])
def test_prefetch_draws_the_synchronous_loops_batches(tmp_path, prefetch):
    """With or without the batch ahead: the same batches in the same
    order, ``steps_expected`` draws and not one more."""
    train_ds, _, _ = get_datasets(_cfg(tmp_path))
    batches = PrefetchedHostBatches(train_ds, 16, 3, "cpu", steps_expected=4,
                                    prefetch=prefetch)
    rng = np.random.default_rng(3)
    assert batches.draws == (1 if prefetch else 0)
    for step in range(4):
        got = batches.take()
        batches.prefetch()
        want = train_ds.sample_batch(rng, 16)
        for key, w in zip(("origins", "directions", "radii", "rgb"), want):
            np.testing.assert_array_equal(got[key].numpy(), w)
        assert batches.draws == (min(step + 2, 4) if prefetch else step + 1)
    assert batches.draws == 4


# ------------------------------------------------------ --profile-steps


@pytest.mark.parametrize("max_store_gb", [6.0, 0.0])
def test_profile_steps_writes_a_trace_and_advances_the_step(
        tmp_path, monkeypatch, capsys, max_store_gb):
    """``--profile-steps 3`` through the CLI, under the block loop and
    under the host-sampling loop: the stage table of 3 steps run with the
    tracer live, then a Chrome trace of 3 more under ``plugins/profile/``
    with the tracer's spans beside it, the digest printed, the step counter
    6 past the iterations (the JAX loop's 3, and 3 more for the stretch
    without the profiler), and under host sampling the profiled steps draw
    their batches too."""
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(_cfg(tmp_path).dump())
    spy = _Spy(monkeypatch, TrainRayDataset)
    train_cli.main(["--config", str(cfg_path), "--device", "cpu",
                    "--profile-steps", "3", "parallel.max_store_gb",
                    str(max_store_gb)])
    out = capsys.readouterr().out
    logdir = str(tmp_path / "run")
    traces = glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                                    "trace.json"))
    assert len(traces) == 1 and traces[0] in out
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert {"ddnerf.step.forward", "ddnerf.pipeline.mlp"} <= {
        e.get("name") for e in events}
    with open(os.path.join(os.path.dirname(traces[0]), "spans.json")) as f:
        spans = json.load(f)
    assert spans["clock_offset_ns"] is not None
    assert sum(s["name"] == "ddnerf.step.iteration" for s in spans["spans"]) == 3
    table = out[out.index("[stages] ddnerf.step.iteration"):]
    for stage in ("step.draw", "step.forward", "pipeline.encode",
                  "step.backward", "step.adam", "step.record"):
        assert stage in table
    assert "[profile] 3 steps in a" in out and "ms/step" in out
    assert "[setup] library builds 0, graph captures 0" in out  # eager
    assert "no device activity" in out  # a CPU run says so
    assert ckpt.all_steps(logdir) == [15]  # 9 iterations + 2 x 3 profiled
    assert [r["step"] for r in _train_records(logdir)] == list(range(9))
    assert len(spy.batches) == (15 if max_store_gb == 0.0 else 0)
    assert not profiling.enabled()


# ---------------------------------------------------------- --debug-nans


def test_debug_nans_names_the_leaf_that_is_not_finite(tmp_path, capsys):
    """A NaN planted in a checkpoint's ``fc_feat.weight``: the resumed run
    under ``--debug-nans`` stops before its first step and names the
    leaf; without the flag the same run goes on to a NaN loss."""
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(_cfg(tmp_path).dump())
    argv = ["--config", str(cfg_path), "--device", "cpu"]
    train_cli.main([*argv, "--max-iters", "2"])
    path = ckpt.checkpoint_path(str(tmp_path / "run"))
    file = torch.load(path, weights_only=True)
    file["model_1_state_dict"]["fc_feat.weight"][0, 0] = float("nan")
    torch.save(file, path)
    capsys.readouterr()
    with pytest.raises(AssertionError, match=r"non-finite values in the "
                       r"parameters before step 2:coarse/fc_feat\.weight"):
        train_cli.main([*argv, "--max-iters", "4", "--debug-nans"])
    assert "debug-nans: the eager step" in capsys.readouterr().out
    assert not torch.is_anomaly_enabled()  # the scope ended
    train_cli.main([*argv, "--max-iters", "4"])
    assert np.isnan(_train_records(str(tmp_path / "run"))[-1]["loss"])


def test_debug_nans_checks_loss_and_gradients_after_the_backward(tmp_path):
    """A target image with a NaN: the parameters are finite, the loss is
    the first leaf that is not.  Inside the ``--debug-nans`` scope autograd's
    anomaly detection is on as well and stops the backward first, at the
    function that made the NaN."""
    cfg = _cfg(tmp_path)
    pipe = NerfPipeline(cfg, "cpu")
    rng = np.random.default_rng(0)
    rd = rng.standard_normal((8, 3)).astype(np.float32)
    batch = {"origins": torch.zeros(8, 3),
             "directions": torch.tensor(rd / np.linalg.norm(rd, axis=-1,
                                                            keepdims=True)),
             "radii": torch.full((8, 1), 1e-3),
             "rgb": torch.full((8, 3), float("nan"))}
    with pytest.raises(AssertionError,
                       match="non-finite values in step 0:loss"):
        train_step(cfg, pipe, TrainState(cfg, pipe), batch, check_finite=True)
    with nan_debug_mode():
        with pytest.raises(RuntimeError, match="returned nan values"):
            train_step(cfg, pipe, TrainState(cfg, pipe), batch,
                       check_finite=True)
    train_step(cfg, pipe, TrainState(cfg, pipe), batch)  # unchecked: runs


@pytest.mark.parametrize("bad", [None, ("a", "w"), ("b", "c", "v")])
def test_assert_finite_tree_gives_the_jax_functions_verdict(bad):
    tree = {"a": {"w": np.ones((2, 3), np.float32), "x": np.zeros(4)},
            "b": {"c": {"v": np.arange(3.0)}}}
    if bad:
        node = tree
        for key in bad[:-1]:
            node = node[key]
        node[bad[-1]] = node[bad[-1]].copy()
        node[bad[-1]].flat[1] = np.nan if len(bad) == 2 else np.inf
    torch_tree = jax.tree_util.tree_map(torch.from_numpy, tree)
    if not bad:
        jax_assert_finite_tree(tree, "t")
        assert_finite_tree(torch_tree, "t")
        return
    with pytest.raises(AssertionError, match="non-finite values in t:") as j:
        jax_assert_finite_tree(tree, "t")
    with pytest.raises(AssertionError, match="non-finite values in t:"
                       + "/".join(bad)) as p:
        assert_finite_tree(torch_tree, "t")
    # The same leaf, in each package's spelling of the path.
    assert all(key in str(j.value) for key in bad) and str(p.value)


# ------------------------------------------- the optimizer state's layout


def _stepped_state(tmp_path, steps=2, seed=1):
    cfg = _cfg(tmp_path)
    store, _, cfg = load_train_store(cfg, "cpu")
    pipe = NerfPipeline(cfg, "cpu", seed=seed)
    state = TrainState(cfg, pipe)
    gen = torch.Generator().manual_seed(2)
    for _ in range(steps):
        train_step_from_store(cfg, pipe, state, store, gen)
    return cfg, store, pipe, state, gen


def _capturable_layout(sd, lr):
    """``sd`` as ``Adam(capturable=True)`` with a tensor rate would write
    it: ``lr`` a 0-d tensor, the flag set, float32 0-d step counts."""
    return {"state": {i: {k: v.clone() for k, v in e.items()}
                      for i, e in sd["state"].items()},
            "param_groups": [dict(g, lr=torch.tensor(lr, dtype=torch.float32),
                                  capturable=True)
                             for g in sd["param_groups"]]}


def test_capturable_layout_loads_into_the_plain_optimizer(tmp_path):
    """A file whose optimizer state has the ``capturable`` optimizer's
    layout continues on the CPU exactly as the plain layout does."""
    cfg, store, pipe, state, gen = _stepped_state(tmp_path)
    plain = state.optimizer_state_dict()
    assert plain["param_groups"][0]["capturable"] is False
    assert isinstance(plain["param_groups"][0]["lr"], float)
    assert plain["param_groups"][0]["lr"] == state.schedule(1)
    weights = [pipe.coarse.state_dict(), pipe.fine.state_dict()]
    weights = [{k: v.clone() for k, v in sd.items()} for sd in weights]
    finals = []
    for sd in (plain, _capturable_layout(plain, state.schedule(1))):
        p = NerfPipeline(cfg, "cpu", seed=5)
        p.load_state_dicts(*weights)
        s = TrainState(cfg, p)
        s.load_optimizer_state_dict(sd, 2)
        group = s.optimizer.param_groups[0]
        assert group["capturable"] is False and isinstance(group["lr"], float)
        assert s.step == 2 and float(s.lr) == np.float32(state.schedule(1))
        assert all(e["step"].device.type == "cpu" and float(e["step"]) == 2
                   for e in s.optimizer.state.values())
        g = torch.Generator()
        g.set_state(gen.get_state())
        train_step_from_store(cfg, p, s, store, g)
        finals.append([q.detach().clone() for q in p.parameters()])
        assert s.optimizer_state_dict()["param_groups"] == [
            dict(plain["param_groups"][0], lr=state.schedule(2))]
    assert all(torch.equal(a, b) for a, b in zip(*finals))


def test_plain_layout_loads_into_the_capturable_optimizer(tmp_path):
    """The reverse, as far as a CPU can show it: a state that runs the
    ``capturable`` optimizer takes a plain file and keeps its own mode
    (the rate as its 0-d tensor, the step counts as float32 tensors on the
    parameters' device), and writes the plain layout back."""
    cfg, _, pipe, state, _ = _stepped_state(tmp_path)
    plain = state.optimizer_state_dict()
    target = TrainState(cfg, NerfPipeline(cfg, "cpu", seed=5))
    target.capturable = True  # what a CUDA device selects
    target.load_optimizer_state_dict(plain, 2)
    group = target.optimizer.param_groups[0]
    assert group["capturable"] is True and group["lr"] is target.lr
    dev = pipe.parameters()[0].device
    for want, entry in zip(plain["state"].values(),
                           target.optimizer.state.values()):
        assert entry["step"].dtype == torch.float32
        assert entry["step"].device == dev and float(entry["step"]) == 2
        assert torch.equal(entry["exp_avg"], want["exp_avg"])
    back = target.optimizer_state_dict()
    assert back["param_groups"] == plain["param_groups"]
    assert all(torch.equal(back["state"][i][k], plain["state"][i][k])
               for i in plain["state"] for k in plain["state"][i])


def test_a_stepped_optimizer_is_loaded_in_place(tmp_path):
    """An optimizer that has stepped keeps its state tensors (a captured
    graph holds their addresses) and takes the file's values; a file
    whose Adam counts disagree with its ``iter`` is refused."""
    cfg, store, pipe, state, gen = _stepped_state(tmp_path, steps=2)
    path = ckpt.save_train_checkpoint(str(tmp_path), pipe, state, gen)
    saved = [p.detach().clone() for p in pipe.parameters()]
    train_step_from_store(cfg, pipe, state, store, gen)
    held = {id(p): {k: v.data_ptr() for k, v in e.items()}
            for p, e in state.optimizer.state.items()}
    assert ckpt.load_train_checkpoint(path, pipe, state, gen) == 2
    assert state.step == 2 and float(state.lr) == np.float32(state.schedule(1))
    for p, e in state.optimizer.state.items():
        assert {k: v.data_ptr() for k, v in e.items()} == held[id(p)]
        assert float(e["step"]) == 2
    assert all(torch.equal(p, w) for p, w in zip(pipe.parameters(), saved))
    with pytest.raises(ValueError, match=r"counts \[2\] updates.*iter is 3"):
        state.load_optimizer_state_dict(state.optimizer_state_dict(), 3)
