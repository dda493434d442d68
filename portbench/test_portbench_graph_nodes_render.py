"""``graph_nodes.render`` reads the program's ``render.graph_nodes``
counter: None on a training run and where no render graph was captured,
the counter's value once the program's registry holds one, reported in
the render cell alone, and never the training step's ``graph.nodes``."""

import pytest

from portbench import harness
from ddnerf_tpu_torch.utils import profiling

TRAIN = harness.LayerRun("train", items=100, window_s=10.0, flop_per_item=1e11,
                         bound_ms_per_item=1.0)
RENDER = harness.LayerRun("render", items=10, window_s=10.0, flop_per_item=1e12,
                          bound_ms_per_item=50.0)


@pytest.fixture
def counters(monkeypatch):
    """The registry with its ``render`` and ``graph`` groups emptied."""
    monkeypatch.setattr(profiling, "_COUNTERS",
                        dict(profiling._COUNTERS, render={}, graph={}))
    return profiling.counters("render")


def test_no_capture_no_reading(counters):
    reader = harness.Registry().reader("graph_nodes.render")
    assert reader.read(RENDER) is None  # an eager frame captured nothing
    profiling.set_counter("graph.nodes", 633)  # a training step's graph
    assert reader.read(RENDER) is None
    profiling.set_counter("render.graph_nodes", 7421)
    assert reader.read(TRAIN) is None


def test_the_counter_once_a_frame_was_captured(counters):
    reader = harness.Registry().reader("graph_nodes.render")
    profiling.set_counter("render.graph_nodes", 7421)
    assert counters == {"graph_nodes": 7421}
    assert reader.read(RENDER) == 7421.0


@pytest.mark.parametrize("cell,run,reported", [
    ("dd_blender.render", RENDER, True), ("dd_blender.train", TRAIN, False),
    ("mip_blender.train", TRAIN, False), ("mip_blender.train_4096", TRAIN, False)])
def test_reported_in_the_render_cell_alone(counters, cell, run, reported):
    reg = harness.Registry()
    assert "graph_nodes.render" not in harness.read_layer_metrics(reg, cell, run)
    profiling.set_counter("render.graph_nodes", 7421)
    got = harness.read_layer_metrics(reg, cell, run)
    assert ("graph_nodes.render" in got) == reported
    if reported:
        assert got["graph_nodes.render"] == {"value": 7421.0, "unit": "nodes"}
