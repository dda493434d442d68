"""The renderer's chunk graphs (``render/graphs.py``).

On the CPU: the chunk plan covers every ray once and in order, its ragged
tail has a graph key of its own, the key separates what a capture freezes
(rows, mode, maps, ``pdf_padding``, dtype), and ``render_flat`` there is
the eager chunk loop, unchanged, which captures nothing; and a renderer's
graphs go with it, by reference counting.

Marked ``cuda`` (skipped without a card, decided in a fixture): a frame
replayed from the graphs equals the eager frame bit for bit, for
``configs/blender_dd.yml`` and ``configs/blender_mipnerf.yml`` at 800×800
(39 full chunks and a ragged tail), through a second pose, after the
parameters change in place, after ``gaussian_smooth_factor`` changes,
across a ``pdf_padding`` flip (which captures anew), with validation
settings that draw, after ``load_state_dicts`` with new tensors (in place,
and rebound, which captures anew), and for an eval image's ``MAP_KEYS``;
and a capture that fails raises.

On a GPU machine:  python -m pytest tests/test_torch_port_render_graphs.py -m cuda
"""

import math
import os

import numpy as np
import pytest
import torch

from ddnerf_tpu_torch.config import Config, load_config
from ddnerf_tpu_torch.core.rays import get_ray_bundle
from ddnerf_tpu_torch.kernels import fused_mlp as fk
from ddnerf_tpu_torch.models.nerf import NerfPipeline, ScheduleValues
from ddnerf_tpu_torch.render.graphs import ChunkGraphs, chunk_plan
from ddnerf_tpu_torch.render.renderer import (
    MAP_KEYS,
    VIDEO_KEYS,
    ImageRenderer,
    quantize_video_frame,
)
from ddnerf_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, FOCAL = 800, 1111.11  # the benchmark's frame: lego's camera


def _pose(angle=0.0, radius=4.0):
    c, s = math.cos(angle), math.sin(angle)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    pose[:3, 3] = [radius * s, 0.0, radius * c]
    return pose


def _tiny_cfg(model="DDNerfModel", perturb=False, chunk=16):
    return Config.from_dict({
        "experiment": {"train_iters": 1000},
        "nerf": {"type": model, "coarse_hidden_size": 16,
                 "fine_hidden_size": 16,
                 "train": {"num_coarse": 4, "num_fine": 4,
                           "num_random_rays": 16},
                 "validation": {"num_coarse": 4, "num_fine": 4,
                                "perturb": perturb, "chunksize": chunk,
                                "radiance_field_noise_std": 1.0}},
        "dataset": {"type": "blender", "near": 2.0, "far": 6.0},
        "parallel": {"compute_dtype": "float32", "num_devices": 1},
    }).resolved()


# ------------------------------------------------------------------ CPU

@pytest.mark.parametrize("n,chunk", [(SIZE * SIZE, 16384), (16384 * 3, 16384),
                                     (77, 16), (5, 16), (1, 1), (0, 16)])
def test_the_chunk_plan_covers_every_ray_once_in_order(n, chunk):
    plan = chunk_plan(n, chunk)
    rays = [r for start, stop in plan for r in range(start, stop)]
    assert rays == list(range(n))
    assert all(0 < stop - start <= chunk for start, stop in plan)
    assert all(stop - start == chunk for start, stop in plan[:-1])
    if n == SIZE * SIZE:
        assert len(plan) == 40 and plan[-1] == (39 * 16384, n)


def test_the_tail_and_each_frozen_branch_get_their_own_key():
    cfg = _tiny_cfg()
    pipe = NerfPipeline(cfg, "cpu", seed=0)
    graphs = ChunkGraphs(pipe, "render", False)
    sched = ScheduleValues(1.7, False)
    keys = {graphs.key(stop - start, VIDEO_KEYS, sched)
            for start, stop in chunk_plan(SIZE * SIZE, 16384)}
    assert len(keys) == 2  # the 39 full chunks share one, the tail has one
    tail = graphs.key(1024, VIDEO_KEYS, sched)
    assert tail in keys and tail.rows == 1024
    full = graphs.key(16384, VIDEO_KEYS, sched)
    assert graphs.key(16384, list(VIDEO_KEYS), ScheduleValues(1.1, False)) == full
    assert graphs.key(16384, VIDEO_KEYS, ScheduleValues(1.7, True)) != full
    assert graphs.key(16384, MAP_KEYS, sched) != full
    assert full.dtype == torch.float32 and full.mode == "render"


def test_on_the_cpu_render_flat_is_the_eager_chunk_loop():
    cfg = _tiny_cfg(perturb=True)
    pipe = NerfPipeline(cfg, "cpu", seed=0)
    renderer = ImageRenderer(cfg, pipe, mode="render")
    assert ImageRenderer(cfg, pipe, mode="validation")._graphs is None
    ro, rd, radii = get_ray_bundle(7, 11, 10.0, _pose(), device="cpu")
    rays = (ro.reshape(-1, 3), rd.reshape(-1, 3), radii.reshape(-1, 1))
    sched = ScheduleValues.for_eval(cfg)
    got = renderer.render_flat(*rays, torch.Generator().manual_seed(0), sched)
    gen = torch.Generator().manual_seed(0)
    want = {0: {}, 1: {}}
    for start, stop in chunk_plan(77, 16):
        out = pipe.render_rays(renderer_rays(cfg, rays, start, stop), sched,
                               "render", gen)
        for i in (0, 1):
            for key in MAP_KEYS:
                if key in out[i]:
                    want[i].setdefault(key, []).append(out[i][key])
    for i in (0, 1):
        assert list(got[i]) == list(want[i])
        for key, parts in want[i].items():
            assert torch.equal(got[i][key], torch.cat(parts))
    assert renderer._graphs._chunks == {}  # the CPU captures nothing
    # The frames' generator is one object, seeded with 0 for every image.
    a = renderer.render_image_from_pose(_pose(), 7, 11, 10.0)
    b = renderer.render_image_from_pose(_pose(), 7, 11, 10.0)
    assert all(np.array_equal(a[i][k], b[i][k]) for i in a for k in a[i])
    assert np.array_equal(a[1]["rgb"].reshape(-1, 3), got[1]["rgb"].numpy())


def test_the_graphs_go_with_their_renderer():
    """No reference cycle holds a renderer's graphs: they are freed when
    the renderer is dropped, not by a garbage collection that could run
    while another graph is being captured (which that would invalidate)."""
    import gc
    import weakref

    cfg = _tiny_cfg()
    renderer = ImageRenderer(cfg, NerfPipeline(cfg, "cpu", seed=0))
    graphs = weakref.ref(renderer._graphs)
    gc.disable()
    try:
        del renderer
        assert graphs() is None
    finally:
        gc.enable()


def renderer_rays(cfg, rays, start, stop):
    from ddnerf_tpu_torch.models.nerf import RayBatch

    ds = cfg.dataset
    return RayBatch.create(*(r[start:stop] for r in rays), ds.near, ds.far)


# ----------------------------------------------------------------- card

@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_renderer(device, name, **changes):
    cfg = load_config(os.path.join(REPO, "configs", name))
    for path, value in changes.items():
        cfg = cfg.replace_at(path, value)
    pipe = NerfPipeline(cfg, device, seed=0)
    return ImageRenderer(cfg, pipe, mode="render")


def _flat_rays(device, pose, size=SIZE, focal=FOCAL):
    ro, rd, radii = get_ray_bundle(size, size, focal, pose, device=device)
    return ro.reshape(-1, 3), rd.reshape(-1, 3), radii.reshape(-1, 1)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_bitwise(got, want):
    assert [list(got[i]) for i in (0, 1)] == [list(want[i]) for i in (0, 1)]
    for i in (0, 1):
        for key, v in want[i].items():
            assert got[i][key].dtype == v.dtype, key
            assert torch.equal(_bits(got[i][key]), _bits(v)), (i, key)


def _graph_against_eager(renderer, rays, gen, sched=None, keys=VIDEO_KEYS):
    """One frame through the graphs (``gen`` reseeded with 0) and the
    same eagerly (a fresh generator seeded with 0), held bit for bit ->
    the graph frame's maps."""
    got = renderer.render_flat(*rays, gen.manual_seed(0), sched, keys)
    eager_gen = torch.Generator(device=rays[0].device).manual_seed(0)
    want = renderer._render_flat_eager(*rays, eager_gen, sched, keys)
    torch.cuda.synchronize()
    _assert_bitwise(got, want)
    return got


def _captures():
    return profiling.counter("graph.captures") or 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["blender_dd.yml", "blender_mipnerf.yml"])
def test_a_replayed_frame_is_the_eager_frame(device, name):
    renderer = _card_renderer(device, name)
    before, launches = _captures(), dict(fk.LAUNCHES)
    rgb, disp = renderer.render_video_frame_from_pose(_pose(), SIZE, SIZE, FOCAL)
    assert _captures() == before + 3  # the weight pack, 16,384 rays, 1,024
    # The capturing frame launches what the eager frame does: each new
    # shape's first chunk runs eagerly, the others replay.
    assert fk.LAUNCHES["fused_mlp_fwd"] - launches["fused_mlp_fwd"] == 2 * 40
    eager_gen = torch.Generator(device=device).manual_seed(0)
    want = renderer._render_flat_eager(*_flat_rays(device, _pose()), eager_gen,
                                       keys=VIDEO_KEYS)
    want_rgb, want_disp = quantize_video_frame(want[1]["rgb"], want[1]["disp"])
    assert np.array_equal(rgb, want_rgb.cpu().numpy().reshape(SIZE, SIZE, 3))
    assert np.array_equal(disp, want_disp.cpu().numpy().reshape(SIZE, SIZE))
    graphs = renderer._graphs
    full, tail = (graphs.key(rows, VIDEO_KEYS, ScheduleValues.for_eval(renderer.cfg))
                  for rows in (16384, 1024))
    assert set(graphs._chunks) == {full, tail}
    nodes = (39 * graphs._chunks[full].census.ops
             + graphs._chunks[tail].census.ops + graphs._pack[1].ops)
    assert profiling.counter("render.graph_nodes") == nodes
    # A second pose through the same graphs; the replays count the
    # kernels they hold (two forwards a chunk, one encode each).
    launches = dict(fk.LAUNCHES)
    gen = renderer._generator  # the graphs hold the frames' generator
    _graph_against_eager(renderer, _flat_rays(device, _pose(0.7)), gen)
    assert _captures() == before + 3
    assert fk.LAUNCHES["fused_mlp_fwd"] - launches["fused_mlp_fwd"] == 2 * 40 * 2
    assert fk.LAUNCHES["ipe_encode"] - launches["ipe_encode"] == 2 * 40 * 2


@pytest.mark.cuda
def test_parameters_changed_in_place_and_the_smooth_factor_are_read(device):
    renderer = _card_renderer(device, "blender_dd.yml")
    rays, gen = _flat_rays(device, _pose(0.3)), torch.Generator(device=device)
    first = _graph_against_eager(renderer, rays, gen)
    before = _captures()
    with torch.no_grad():
        for i, p in enumerate(renderer.pipeline.parameters()):
            p.mul_(0.9).add_(0.01 * (i % 3))
    changed = _graph_against_eager(renderer, rays, gen)
    assert not torch.equal(changed[1]["rgb"], first[1]["rgb"])
    smooth = _graph_against_eager(renderer, rays, gen, ScheduleValues(1.7, False))
    other = _graph_against_eager(renderer, rays, gen, ScheduleValues(0.6, False))
    assert not torch.equal(smooth[1]["rgb"], other[1]["rgb"])
    assert _captures() == before  # neither needed a new graph


@pytest.mark.cuda
def test_a_pdf_padding_flip_captures_a_new_graph(device):
    renderer = _card_renderer(device, "blender_dd.yml")
    rays, gen = _flat_rays(device, _pose(1.1)), torch.Generator(device=device)
    off = _graph_against_eager(renderer, rays, gen, ScheduleValues(1.7, False))
    before = _captures()
    on = _graph_against_eager(renderer, rays, gen, ScheduleValues(1.7, True))
    assert _captures() == before + 2  # full chunks and tail; the pack stays
    assert not torch.equal(on[1]["rgb"], off[1]["rgb"])
    _graph_against_eager(renderer, rays, gen, ScheduleValues(1.7, False))
    assert _captures() == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["blender_dd.yml", "blender_mipnerf.yml"])
def test_validation_settings_that_draw_give_the_eager_draws(device, name):
    renderer = _card_renderer(device, name, **{"nerf.validation.perturb": True})
    assert renderer._graphs.draws
    rays, gen = _flat_rays(device, _pose(2.0)), torch.Generator(device=device)
    a = _graph_against_eager(renderer, rays, gen)
    b = _graph_against_eager(renderer, rays, gen)  # reseeded: the same draws
    _assert_bitwise(a, b)
    plain = _card_renderer(device, name, **{"nerf.validation.perturb": False,
                                            "nerf.validation.radiance_field_noise_std": 0.0})
    assert not plain._graphs.draws
    _graph_against_eager(plain, rays, torch.Generator(device=device))


@pytest.mark.cuda
def test_load_state_dicts_with_new_tensors(device):
    renderer = _card_renderer(device, "blender_dd.yml")
    pipe = renderer.pipeline
    rays, gen = _flat_rays(device, _pose(0.5)), torch.Generator(device=device)
    first = _graph_against_eager(renderer, rays, gen)
    other = NerfPipeline(renderer.cfg, device, seed=7)
    before = _captures()
    pipe.load_state_dicts(other.coarse.state_dict(), other.fine.state_dict())
    loaded = _graph_against_eager(renderer, rays, gen)
    assert _captures() == before  # copied into the same storage
    assert not torch.equal(loaded[1]["rgb"], first[1]["rgb"])
    fresh = NerfPipeline(renderer.cfg, device, seed=11)
    pipe.coarse.load_state_dict(fresh.coarse.state_dict(), assign=True)
    pipe.fine.load_state_dict(fresh.fine.state_dict(), assign=True)
    _graph_against_eager(renderer, rays, gen)
    assert _captures() == before + 3  # storage moved: every graph anew


@pytest.mark.cuda
def test_an_eval_image_of_map_keys(device):
    renderer = _card_renderer(device, "blender_dd.yml")
    got = renderer.render_image_from_pose(_pose(0.9), SIZE, SIZE, FOCAL)
    eager_gen = torch.Generator(device=device).manual_seed(0)
    want = renderer._render_flat_eager(*_flat_rays(device, _pose(0.9)), eager_gen)
    assert [list(got[i]) for i in (0, 1)] == [list(want[i]) for i in (0, 1)]
    assert "corrected_disp_map" in got[0]
    for i in (0, 1):
        for key, v in want[i].items():
            w = v.float().cpu().numpy()
            w = w.reshape(SIZE, SIZE, -1) if w.ndim == 2 else w.reshape(SIZE, SIZE)
            assert np.array_equal(got[i][key].view(np.int32), w.view(np.int32)), key
    rays = _flat_rays(device, _pose(0.9))
    _graph_against_eager(renderer, rays, torch.Generator(device=device),
                         keys=MAP_KEYS)


@pytest.mark.cuda
def test_a_live_tracer_splits_the_frame_into_capture_and_replays(device, capfd):
    renderer = _card_renderer(device, "blender_dd.yml")
    profiling.reset()
    profiling.enable()
    try:  # 256 x 256: four chunks, the first rendered eagerly and captured
        renderer.render_video_frame_from_pose(_pose(), 256, 256, 355.0)
        renderer.render_video_frame_from_pose(_pose(0.2), 256, 256, 355.0)
        torch.cuda.synchronize()
        snap = profiling.snapshot()
    finally:
        profiling.disable()
        profiling.reset()
    by_id = {s["id"]: s for s in snap["spans"]}
    frames = [s for s in snap["spans"] if s["name"] == profiling.FRAME_ROOT]
    stages = [[s["name"] for s in snap["spans"] if s["parent"] == f["id"]]
              for f in frames]
    assert stages[0][1:3] == ["ddnerf.render.capture"] + ["ddnerf.render.replay"]
    assert stages[0].count("ddnerf.render.replay") == 3
    assert stages[1].count("ddnerf.render.replay") == 4
    assert "ddnerf.render.capture" not in stages[1]
    replayed = [s for s in snap["spans"] if s["kind"] == "replayed"
                and s["name"] == "ddnerf.render.chunk"]
    assert len(replayed) == 7
    assert all(by_id[s["parent"]]["name"] == "ddnerf.render.replay"
               and s["device_ms"] > 0 for s in replayed)
    table = profiling.stage_table(snap, profiling.FRAME_ROOT)
    assert "render.capture" in table and "render.replay" in table
    line = next(x for x in capfd.readouterr().err.splitlines()
                if x.startswith("[graph]") and "16384 rays" in x)
    full = renderer._graphs._chunks[renderer._graphs.key(
        16384, VIDEO_KEYS, ScheduleValues.for_eval(renderer.cfg))]
    assert line.endswith(f"= {full.census.ops}")  # split by stage
    assert profiling.counter("render.graph_nodes") == (
        4 * full.census.ops + renderer._graphs._pack[1].ops)


# A capture that fails leaves the process's CUDA generators mid-capture, so
# the failing frame runs in an interpreter of its own.
FAILING_CAPTURE = """
import numpy as np, torch
from ddnerf_tpu_torch.config import load_config
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.render.renderer import ImageRenderer

cfg = load_config("configs/blender_dd.yml")
renderer = ImageRenderer(cfg, NerfPipeline(cfg, "cuda", seed=0), mode="render")
chunk = renderer._chunk

def syncs_while_captured(*args):
    maps = chunk(*args)
    if torch.cuda.is_current_stream_capturing():
        maps[1]["rgb"].sum().item()  # a host read: no graph can hold it
    return maps

renderer._chunk = syncs_while_captured
pose = np.eye(4, dtype=np.float32)
pose[2, 3] = 4.0
try:
    renderer.render_video_frame_from_pose(pose, 64, 64, 80.0)
except RuntimeError as e:  # torch.AcceleratorError is one
    print("raised: RuntimeError", type(e).__name__)
else:
    print("rendered")
"""


@pytest.mark.cuda
def test_a_capture_that_fails_raises(device):
    import subprocess
    import sys

    done = subprocess.run([sys.executable, "-c", FAILING_CAPTURE], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert "raised: RuntimeError" in done.stdout, done.stdout + done.stderr
