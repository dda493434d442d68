"""The port's tracer (``utils/profiling.py``): off, a span is the shared null
context and records nothing while the counters still count; live, spans
nest with their parents' ids and their self time, lie on a CPU profile's
timeline at the tracer's clock offset, and follow the layer boundaries of
a render (one ``render.chunk`` a chunk) and of an eager train step;
``summarize`` takes device busy time as the union of overlapping
activities; the set-up line reads the set-up spans, the counters and
the host time a replayed step; a build of the kernel library counts
``kernels.library_builds`` and a load of the cached one does not.  Two
tests, marked ``cuda``, hold a captured step's ``graph.nodes`` to the
graph's own node count and count a capture anew once its graphs are
dropped (skipped without a card, decided in a fixture).

On a GPU machine:  python -m pytest tests/test_torch_port_tracing.py -m cuda --noconftest
"""

import ctypes
import math
import os
import stat
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.kernels import build
from ddnerf_tpu_torch.kernels import fused_mlp as fk
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.render.renderer import ImageRenderer
from ddnerf_tpu_torch.train.state import TrainState
from ddnerf_tpu_torch.train.step import EagerTrainStep
from ddnerf_tpu_torch.utils import profiling

CHUNK = 16
PIPELINE_DD = ["ddnerf.pipeline.sample", "ddnerf.pipeline.encode",
               "ddnerf.pipeline.mlp", "ddnerf.pipeline.composite",
               "ddnerf.pipeline.resample", "ddnerf.pipeline.encode",
               "ddnerf.pipeline.mlp", "ddnerf.pipeline.composite"]


@pytest.fixture
def tracer():
    """A live tracer with an empty record, off again afterwards."""
    profiling.reset()
    profiling.enable()
    yield profiling
    profiling.disable()
    profiling.reset()


def _cfg(model="DDNerfModel"):
    return Config.from_dict({
        "experiment": {"train_iters": 1000},
        "nerf": {"type": model, "coarse_hidden_size": 16,
                 "fine_hidden_size": 16,
                 "train": {"num_coarse": 4, "num_fine": 4,
                           "num_random_rays": 16, "perturb": False,
                           "radiance_field_noise_std": 0.0},
                 "validation": {"num_coarse": 4, "num_fine": 4,
                                "perturb": False, "chunksize": CHUNK,
                                "radiance_field_noise_std": 0.0}},
        "dataset": {"type": "blender", "near": 2.0, "far": 6.0},
        "parallel": {"compute_dtype": "float32", "num_devices": 1},
    }).resolved()


def _tree(snap):
    """id -> (name, [children's names in order])."""
    spans = snap["spans"]
    kids = {s["id"]: [] for s in spans}
    for s in sorted(spans, key=lambda s: s["id"]):
        if s["parent"] in kids:
            kids[s["parent"]].append(s)
    return {s["id"]: (s["name"], [k["name"] for k in kids[s["id"]]])
            for s in spans}, kids


def test_off_a_span_is_the_shared_null_context_and_records_nothing():
    profiling.disable()
    profiling.reset()
    assert not profiling.enabled()
    a, b = profiling.span("ddnerf.a"), profiling.span("ddnerf.b")
    assert a is b
    with a, profiling.span("ddnerf.c"):
        pass
    assert profiling.snapshot()["spans"] == []
    before = profiling.counter("tests.off") or 0
    profiling.count("tests.off", 2)
    assert profiling.counter("tests.off") == before + 2
    # the kernels' launch counts are the registry's groups, read as before
    assert fk.LAUNCHES is profiling.counters("kernels.launches")
    assert fk.CAPTURED is profiling.counters("kernels.captured")
    assert set(fk.LAUNCHES) == set(fk.CAPTURED) and "fused_mlp_fwd" in fk.LAUNCHES
    launches = dict(fk.LAUNCHES)
    net = NerfPipeline(_cfg(), "cpu").coarse
    fk.fused_mlp_forward(net, torch.rand(8, 96), torch.rand(2, 27), 4)
    assert fk.LAUNCHES == launches  # the plain version counts no launch
    values = profiling.counter_values()
    assert values["kernels.launches.fused_mlp_fwd"] == fk.LAUNCHES["fused_mlp_fwd"]


def test_live_spans_nest_with_parent_ids_and_self_time(tracer):
    with tracer.span("ddnerf.t.outer"):
        time.sleep(0.002)
        with tracer.span("ddnerf.t.inner"):
            time.sleep(0.004)
        with tracer.span("ddnerf.t.inner"):
            with tracer.span("ddnerf.t.leaf"):
                time.sleep(0.001)
    snap = tracer.snapshot()
    by_name = {}
    for s in snap["spans"]:
        by_name.setdefault(s["name"], []).append(s)
    (outer,), inners, (leaf,) = (by_name["ddnerf.t.outer"],
                                 by_name["ddnerf.t.inner"],
                                 by_name["ddnerf.t.leaf"])
    assert outer["parent"] is None
    assert [s["parent"] for s in inners] == [outer["id"]] * 2
    assert leaf["parent"] == inners[1]["id"]
    assert len({s["id"] for s in snap["spans"]}) == 4
    assert outer["host_self_ms"] == pytest.approx(
        outer["host_ms"] - sum(s["host_ms"] for s in inners))
    assert inners[1]["host_self_ms"] == pytest.approx(
        inners[1]["host_ms"] - leaf["host_ms"])
    assert leaf["host_self_ms"] == leaf["host_ms"] >= 1.0
    assert outer["host_self_ms"] >= 2.0
    assert all(s["device_ms"] is None for s in snap["spans"])  # no card
    assert snap["dropped"] == 0 and snap["clock_offset_ns"] is None


def test_the_record_is_bounded(tracer, monkeypatch):
    monkeypatch.setattr(profiling, "LIMIT", 3)
    for _ in range(5):
        with tracer.span("ddnerf.t.s"):
            pass
    snap = tracer.snapshot()
    assert len(snap["spans"]) == 3 and snap["dropped"] == 2


def test_live_spans_lie_on_a_cpu_profile_at_the_clock_offset(tracer):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        # the profiler's first annotation pays its own set-up before its
        # time stamp: not a span's
        with torch.profiler.record_function("warm-up"):
            torch.ones(4).sum()
        for _ in range(3):
            with tracer.span("ddnerf.t.outer"):
                with tracer.span("ddnerf.t.first"):
                    torch.ones(64).sum()
                with tracer.span("ddnerf.t.second"):
                    with tracer.span("ddnerf.t.third"):
                        torch.ones(64).sum()
                time.sleep(0.001)
    snap = tracer.snapshot(prof)
    offset = snap["clock_offset_ns"]
    assert offset is not None
    names = {"ddnerf.t.outer", "ddnerf.t.first", "ddnerf.t.second",
             "ddnerf.t.third"}
    events = sorted((e for e in prof.events() if e.name in names),
                    key=lambda e: e.time_range.start)
    spans = sorted(snap["spans"], key=lambda s: s["start_ns"])
    assert [e.name for e in events] == [s["name"] for s in spans]
    by_id = {s["id"]: s for s in spans}
    for e, s in zip(events, spans):
        # the same nesting: the profiler's parent is the tracer's
        parent = by_id[s["parent"]]["name"] if s["parent"] in by_id else None
        prof_parent = e.cpu_parent.name if e.cpu_parent is not None else None
        assert prof_parent == parent
        assert abs(s["profile_start_us"] - e.time_range.start) < 100.0


@pytest.mark.parametrize("frame", ["video", "image"])
def test_live_render_follows_the_renderer_and_pipeline_boundaries(tracer, frame):
    cfg = _cfg()
    renderer = ImageRenderer(cfg, NerfPipeline(cfg, "cpu", seed=0))
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 4.0
    h, w = 7, 11
    if frame == "video":
        renderer.render_video_frame_from_pose(pose, h, w, 10.0)
        tail = ["ddnerf.render.assemble", "ddnerf.render.quantize",
                "ddnerf.render.to_host"]
    else:
        renderer.render_image_from_pose(pose, h, w, 10.0)
        tail = ["ddnerf.render.assemble", "ddnerf.render.to_host"]
    snap = tracer.snapshot()
    tree, kids = _tree(snap)
    (root,) = [i for i, (name, _) in tree.items() if name == profiling.FRAME_ROOT]
    chunks = math.ceil(h * w / CHUNK)
    assert tree[root][1] == (["ddnerf.render.rays"]
                             + ["ddnerf.render.chunk"] * chunks + tail)
    for chunk in kids[root][1:1 + chunks]:
        assert tree[chunk["id"]][1] == PIPELINE_DD
    table = profiling.stage_table(snap, profiling.FRAME_ROOT)
    assert f"{float(chunks):6.1f}" in table and "render.chunk" in table


def test_live_eager_train_step_follows_the_step_boundaries(tracer):
    cfg = _cfg()
    pipe = NerfPipeline(cfg, "cpu", seed=0)
    state = TrainState(cfg, pipe)
    store = torch.rand(2, 40, 10, generator=torch.Generator().manual_seed(1))
    step = EagerTrainStep.from_store(cfg, pipe, state, store,
                                     torch.Generator().manual_seed(0))
    step.run(2)
    snap = tracer.snapshot()
    tree, kids = _tree(snap)
    roots = [i for i, (name, _) in tree.items() if name == profiling.STEP_ROOT]
    assert len(roots) == 2
    for root in roots:
        assert tree[root][1] == ["ddnerf.step.draw", "ddnerf.step.forward",
                                 "ddnerf.step.backward", "ddnerf.step.adam",
                                 "ddnerf.step.record"]
        forward = kids[root][1]
        assert tree[forward["id"]][1] == PIPELINE_DD + ["ddnerf.pipeline.dp_loss"]
    table = profiling.stage_table(snap, profiling.STEP_ROOT)
    lines = table.splitlines()
    assert "host ms of 2 eager" in lines[0]
    assert any(line.endswith("    step.adam") for line in lines)


def test_live_mipnerf_step_has_no_dp_loss(tracer):
    cfg = _cfg("GeneralMipNerfModel")
    pipe = NerfPipeline(cfg, "cpu", seed=0)
    step = EagerTrainStep.from_store(cfg, pipe, TrainState(cfg, pipe),
                                     torch.rand(2, 40, 10),
                                     torch.Generator().manual_seed(0))
    step.run(1)
    tree, kids = _tree(tracer.snapshot())
    (forward,) = [i for i, (name, _) in tree.items()
                  if name == "ddnerf.step.forward"]
    assert tree[forward][1] == PIPELINE_DD


def _event(name, start, end, cuda=True, annotation=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_time=end - start, is_user_annotation=annotation,
        device_type=(torch.autograd.DeviceType.CUDA if cuda
                     else torch.autograd.DeviceType.CPU))


def test_summarize_takes_busy_time_as_the_union_of_overlapping_activities():
    profiling.reset()
    # two steps over 0..1000 us; device activities overlap: their union is
    # 700 us of an 800 us span, where a sum reads 1000 (more than the span)
    events = [_event("host", 0.0, 1000.0, cuda=False),
              _event("kernel_a", 100.0, 400.0), _event("kernel_b", 200.0, 500.0),
              _event("kernel_a", 600.0, 800.0), _event("kernel_b", 700.0, 900.0),
              _event("ddnerf.step.forward", 100.0, 900.0, annotation=True)]
    prof = SimpleNamespace(events=lambda: events)
    out = profiling.summarize(prof, 2)
    assert "2 steps in a 1.00 ms window: 0.50 ms/step" in out
    assert "device busy 0.35 ms of a 0.40 ms span (87.5% busy)" in out
    assert "4 device activities" not in out and "2 device activities" in out
    assert "0.250 ms     1.0 launches  kernel_a" in out


def test_summarize_of_a_cpu_profile_says_so():
    prof = SimpleNamespace(events=lambda: [_event("host", 0.0, 10.0, cuda=False)])
    assert "no device activity" in profiling.summarize(prof, 1)


def test_setup_line_reads_the_setup_spans_counters_and_replays():
    def rec(i, name, kind="eager", parent=None, host=None):
        return {"id": i, "name": name, "kind": kind, "parent": parent,
                "host_ms": host}

    spans = [rec(1, "ddnerf.kernels.load_library", host=900.0),
             rec(2, "ddnerf.step.eager", host=40.0),
             rec(3, "ddnerf.step.eager", host=20.0),
             rec(4, "ddnerf.step.capture", host=150.0),
             rec(5, "ddnerf.step.replay", host=9.9),  # before the stretch
             rec(6, "ddnerf.step.replay", host=12.0)]
    spans += [rec(7 + j, profiling.STEP_ROOT, "replayed", parent=6)
              for j in range(4)]
    snap = {"spans": spans, "counters": {"kernels.library_builds": 1,
                                         "graph.captures": 2}}
    line = profiling.setup_line(snap)
    assert line == ("[setup] kernels.load_library 1 x 900.0 host ms; "
                    "step.eager 2 x 30.0 host ms; step.capture 1 x 150.0 "
                    "host ms; library builds 1, graph captures 2; replay "
                    "3.0000 host ms a step over 4")
    assert profiling.setup_line({"spans": [], "counters": {}}) == (
        "[setup] library builds 0, graph captures 0")


def test_a_library_build_is_counted_and_a_cached_load_is_not(
        tmp_path, monkeypatch):
    # a stand-in nvcc that writes each file named after -o
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = -o ]; then : > "$2"; fi\n  shift\n'
                    'done\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    before = profiling.counter("kernels.library_builds") or 0
    first = build.build(("-DTRACING_TEST",))
    assert not first.cached and first.path.exists()
    assert profiling.counter("kernels.library_builds") == before + 1
    again = build.build(("-DTRACING_TEST",))
    assert again.cached and again.path == first.path
    assert profiling.counter("kernels.library_builds") == before + 1
    assert set(os.listdir(first.path.parent)) == {first.path.name, "build.log"}


# ------------------------------------------------------------------ the card


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _libcuda_nodes(raw_graph):
    """(device operations, event nodes) of a graph, read through the CUDA
    graph calls of libcuda (not the tracer's runtime path)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    vp, sz = ctypes.c_void_p, ctypes.c_size_t
    cuda.cuGraphGetNodes.argtypes = [vp, ctypes.POINTER(vp), ctypes.POINTER(sz)]
    cuda.cuGraphNodeGetType.argtypes = [vp, ctypes.POINTER(ctypes.c_int)]
    n = sz(0)
    assert cuda.cuGraphGetNodes(raw_graph, None, ctypes.byref(n)) == 0
    nodes = (vp * n.value)()
    assert cuda.cuGraphGetNodes(raw_graph, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes[:n.value]:
        t = ctypes.c_int(-1)
        assert cuda.cuGraphNodeGetType(node, ctypes.byref(t)) == 0
        kinds.append(t.value)
    return sum(k in (0, 1, 2) for k in kinds), sum(k in (6, 7) for k in kinds)


@pytest.mark.cuda
@pytest.mark.parametrize("live", [False, True])
def test_captured_step_counts_its_graph_nodes(device, live, capfd):
    from ddnerf_tpu_torch.train.step import CapturedTrainStep

    cfg = _cfg().replace_at("parallel.compute_dtype", "bfloat16")
    pipe = NerfPipeline(cfg, device, seed=0)
    state = TrainState(cfg, pipe)
    store = torch.rand(2, 64, 10, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    profiling.reset()
    if live:
        profiling.enable()
    try:
        step = CapturedTrainStep(cfg, pipe, state, store, gen, max_block=4)
        step.run(4)  # three eager warm-ups, the capture, one replay
        step.run(4)
        torch.cuda.synchronize()
        snap = profiling.snapshot()
    finally:
        profiling.disable()
    ((graph, _, census),) = step._graphs.values()
    ops, events = _libcuda_nodes(graph.raw_cuda_graph())
    assert profiling.counter("graph.nodes") == census.ops == ops > 0
    err = capfd.readouterr().err
    line = next(x for x in err.splitlines() if x.startswith("[graph]"))
    assert f"{ops} device operations" in line
    if not live:
        assert events == 0  # today's graph, node for node
        assert census.spans == [] and line.endswith(
            "not split (the tracer was off at the capture)")
        return
    assert line.endswith(f"= {ops}")  # the split sums to the total
    timed = len(census.timed())
    assert events == 2 * timed > 0
    replayed = [s for s in snap["spans"] if s["kind"] == "replayed"
                and s["name"] == profiling.STEP_ROOT]
    assert len(replayed) == 5
    assert all(s["device_ms"] is not None and s["device_ms"] > 0
               for s in snap["spans"] if s["kind"] == "replayed")


@pytest.mark.cuda
def test_dropped_graphs_are_captured_anew_without_stage_events(device, capfd):
    from ddnerf_tpu_torch.train.step import CapturedTrainStep

    cfg = _cfg().replace_at("parallel.compute_dtype", "bfloat16")
    pipe = NerfPipeline(cfg, device, seed=0)
    state = TrainState(cfg, pipe)
    store = torch.rand(2, 64, 10, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    before = profiling.counter("graph.captures") or 0
    profiling.reset()
    profiling.enable()
    try:
        step = CapturedTrainStep(cfg, pipe, state, store, gen, max_block=4)
        step.run(4)  # three eager warm-ups, the capture, one replay
    finally:
        profiling.disable()
    ((live, _, live_census),) = step._graphs.values()
    live_ops, live_events = _libcuda_nodes(live.raw_cuda_graph())
    assert live_events > 0
    step.drop_graphs()
    step.run(2)  # captured anew, the tracer off
    torch.cuda.synchronize()
    ((graph, _, census),) = step._graphs.values()
    assert graph is not live
    assert _libcuda_nodes(graph.raw_cuda_graph()) == (live_ops, 0)
    assert profiling.counter("graph.captures") == before + 2
    assert profiling.counter("graph.nodes") == census.ops == live_ops
    lines = [x for x in capfd.readouterr().err.splitlines()
             if x.startswith("[graph]")]
    assert [x.split(",")[0] for x in lines] == [
        f"[graph] capture {before + 1}", f"[graph] capture {before + 2}"]
