"""A run's ``correct`` comes out true for the sound program and false with
each fault a cell can have planted under its timed path, and for the
control (the reference at float8 in the program's place), at a tiny size
on the CPU through the cells' own drivers, past the look for a card."""

import contextlib

import pytest

from portbench import compare, faults, scene, testing
from portbench.drivers import render as render_driver
from portbench.drivers import train as train_driver
from portbench.reference import nerf as reference

TRAIN_CELLS = ["dd_blender.train", "mip_blender.train", "mip_blender.train_4096"]


def _run(cell, fault=None):
    ctx = testing.tiny_context(cell)
    driver = ctx.registry.driver(ctx.traffic["driver"])
    with fault() if fault else contextlib.nullcontext():
        out = driver.run(ctx)
    return ctx, out


@pytest.mark.parametrize("cell", TRAIN_CELLS + ["dd_blender.render"])
def test_the_sound_program_is_correct(cell):
    ctx, out = _run(cell)
    assert testing.judge(ctx, out), out["numbers"]


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
@pytest.mark.parametrize("cell", ["dd_blender.train", "mip_blender.train"])
def test_each_training_fault_is_not_correct(cell, fault):
    ctx, out = _run(cell, faults.TRAIN[fault])
    assert not testing.judge(ctx, out), out["numbers"]


@pytest.mark.parametrize("fault", sorted(faults.RENDER))
def test_each_render_fault_is_not_correct(fault):
    ctx, out = _run("dd_blender.render", faults.RENDER[fault])
    assert not testing.judge(ctx, out), out["numbers"]


@pytest.mark.parametrize("cell", ["dd_blender.train", "mip_blender.train"])
def test_the_training_control_is_not_correct(cell):
    ctx = testing.tiny_context(cell)
    cfg = train_driver.program_config(ctx.config, ctx.traffic)
    store = scene.make_store(ctx.config["scene"], ctx.seed, "cpu")
    weights = scene.make_weights(cfg, ctx.seed, "cpu")
    got = train_driver.reference_readings(cfg, ctx.traffic, weights, store, ctx.seed,
                                          reference.fp8)
    ref = train_driver.reference_readings(cfg, ctx.traffic, weights, store, ctx.seed,
                                          reference.bf16)
    numbers = compare.train_numbers(got, ref)
    limits = ctx.registry.limits(cell)
    assert any(numbers[k] > limits[k] for k in numbers), numbers


def test_the_render_control_is_not_correct():
    ctx = testing.tiny_context("dd_blender.render")
    cfg, sc = ctx.config["config"], ctx.config["scene"]
    weights = scene.make_weights(cfg, ctx.seed, "cpu")
    poses = list(scene.orbit_poses(8, -30.0, 4.0)[:2])
    args = (sc["height"], sc["width"], scene.focal_of(sc))
    got = render_driver.reference_frames(cfg, weights, poses, *args, reference.fp8, "cpu")
    ref = render_driver.reference_frames(cfg, weights, poses, *args, reference.bf16, "cpu")
    numbers = compare.frame_numbers(got, ref)
    limits = ctx.registry.limits("dd_blender.render")
    assert any(numbers[k] > limits[k] for k in numbers), numbers
