"""``graph_nodes.train`` reads the program's ``graph.nodes`` counter: None
on a render run and where no graph was captured, the counter's value once
the program's registry holds one, and reported through the harness in each
training cell that lists it."""

import pytest

from portbench import harness
from ddnerf_tpu_torch.utils import profiling

TRAIN = harness.LayerRun("train", items=100, window_s=10.0, flop_per_item=1e11,
                         bound_ms_per_item=1.0)
RENDER = harness.LayerRun("render", items=10, window_s=10.0, flop_per_item=1e12,
                          bound_ms_per_item=50.0)


@pytest.fixture
def graph_counter(monkeypatch):
    """The registry with its ``graph`` group emptied for the test."""
    monkeypatch.setattr(profiling, "_COUNTERS",
                        dict(profiling._COUNTERS, graph={}))
    return profiling.counters("graph")


def test_no_graph_no_reading(graph_counter):
    reader = harness.Registry().reader("graph_nodes.train")
    assert reader.read(TRAIN) is None  # an eager run captured nothing
    profiling.set_counter("graph.nodes", 1041)
    assert reader.read(RENDER) is None


def test_the_counter_once_a_graph_was_captured(graph_counter):
    reader = harness.Registry().reader("graph_nodes.train")
    profiling.set_counter("graph.nodes", 1041)
    assert graph_counter == {"nodes": 1041}
    assert reader.read(TRAIN) == 1041.0


@pytest.mark.parametrize("cell", ["dd_blender.train", "mip_blender.train",
                                  "mip_blender.train_4096"])
def test_reported_in_each_training_cell(graph_counter, cell):
    reg = harness.Registry()
    assert "graph_nodes.train" not in harness.read_layer_metrics(reg, cell, TRAIN)
    profiling.set_counter("graph.nodes", 777)
    got = harness.read_layer_metrics(reg, cell, TRAIN)
    assert got["graph_nodes.train"] == {"value": 777.0, "unit": "nodes"}
    assert "graph_nodes.train" not in harness.read_layer_metrics(
        reg, "dd_blender.render", RENDER)
