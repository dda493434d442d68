"""The plain reference stands apart from the program and agrees with it:
no module of the reference imports the port, no module of the benchmark
imports JAX or the JAX package, and at a tiny size on the CPU (where the
program's kernels run their plain versions) the reference follows the
program's training steps and frames."""

import ast

import pytest
import torch

from portbench import compare, harness, scene, testing
from portbench.drivers import render as render_driver
from portbench.drivers import train as train_driver
from portbench.reference import nerf as reference


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((harness.PACKAGE / "reference").glob("*.py"))
    files += [harness.PACKAGE / f for f in ("scene.py", "compare.py", "counts.py")]
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "ddnerf_tpu_torch" not in tops, path


def test_no_module_of_the_benchmark_imports_jax():
    for path in harness.PACKAGE.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "ddnerf_tpu_torch_extra", types.ModuleType("x"))
    assert "ddnerf_tpu_torch_extra" not in harness.forbidden_modules()
    assert "ddnerf_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax"]


@pytest.mark.parametrize("cell", ["dd_blender.train", "mip_blender.train"])
def test_reference_follows_the_programs_training_steps(cell):
    ctx = testing.tiny_context(cell)
    cfg = train_driver.program_config(ctx.config, ctx.traffic)
    prog = train_driver.Program(cfg, ctx.config["scene"], ctx.traffic, ctx.seed, ctx.device)
    got = prog.first_steps()
    ref = train_driver.reference_readings(cfg, ctx.traffic, prog.weights, prog.store,
                                          ctx.seed, reference.bf16)
    # the first step draws and computes alike: one loss to the last bits
    assert got["losses"][0] == pytest.approx(ref["losses"][0], rel=1e-6)
    numbers = compare.train_numbers(got, ref)
    limits = ctx.registry.limits(cell)
    assert all(numbers[k] <= limits[k] for k in numbers), numbers


def test_weights_follow_the_networks_parameter_order():
    ctx = testing.tiny_context("dd_blender.train")
    cfg = ctx.config["config"]
    w = scene.make_weights(cfg, 3, "cpu")
    from ddnerf_tpu_torch.config import Config
    from ddnerf_tpu_torch.models.nerf import NerfPipeline

    pipe = NerfPipeline(Config.from_dict(cfg).resolved(), "cpu")
    for net, (name, leaves) in zip(pipe.networks(), w.items()):
        assert list(leaves) == [n for n, _ in net.named_parameters()], name
    again = scene.make_weights(cfg, 3, "cpu")
    assert all(torch.equal(w[n][k], again[n][k]) for n in w for k in w[n])


@pytest.mark.parametrize("config", ["dd_blender", "mip_blender"])
def test_reference_renders_the_programs_frame(config):
    registry = harness.Registry()
    cf = testing.tiny_config(registry, config)
    cfg, sc = cf["config"], cf["scene"]
    prog = render_driver.Program(cfg, 99, "cpu")
    pose = scene.orbit_poses(8, -30.0, 4.0)[3]
    focal = scene.focal_of(sc)
    got = prog.frame(pose, sc["height"], sc["width"], focal)
    ref = render_driver.reference_frames(cfg, prog.weights, [pose], sc["height"],
                                         sc["width"], focal, reference.bf16, "cpu")
    numbers = compare.frame_numbers([got], ref)
    assert numbers == {"rgb_rmse": 0.0, "disp_rmse": 0.0}
