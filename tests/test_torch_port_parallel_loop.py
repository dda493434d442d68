"""The port's drivers on two gloo ranks (``torchrun``'s environment, two
subprocesses with their own timeouts) against one process, on the CPU:

* training: 6 iterations and a rerun to 12 equal 12 straight, bitwise
  (records, checkpoint, every rank's generator); one writer; a rerun at
  world size 1 raises with both sizes; host sampling on two ranks equals
  one process on the same global batches; ``parallel.num_devices`` against
  the world size;
* eval and video: the maps, ``results.txt``, the image dumps, the point
  cloud and the video frames equal one process's, with the validation
  density noise on (each ray meets the same draws on any number of
  ranks), on the synthetic scene and on an NDC scene.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_port_parallel import REPO, _spawn, _tiny_dict

from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.data.images import read_image
from ddnerf_tpu_torch.data.synthetic import write_synthetic_llff
from ddnerf_tpu_torch.eval.evaluate import eval_model, load_pipeline
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.render.media import read_avi
from ddnerf_tpu_torch.render.renderer import ImageRenderer
from ddnerf_tpu_torch.render.video import render_model_video
from ddnerf_tpu_torch.train.checkpoint import (
    all_steps,
    save_config_snapshot,
    step_path,
)
from ddnerf_tpu_torch.train.loop import train
from ddnerf_tpu_torch.utils.weights import save_checkpoint

# Host sampling, two ranks against one on the same global batches: the
# step differs by the all-reduce's summation order, which Adam's first
# steps may amplify where a gradient element is near zero.
HOST_LOSS_RTOL = 1e-5
# A rank renders a chunk's share, one process the whole chunk: the CPU's
# matmul may round a row differently with the number of rows (read: a few
# elements of a map 1 ulp apart).  The image dumps, the frames and
# results.txt are equal all the same; on the card, where a row's kernel
# result does not depend on its tile, chip_smoke.py holds the maps bitwise.
CPU_MAP_RTOL = 1e-6

_LOOP_PROGRAM = r"""
import json, os, sys
import numpy as np
import torch
from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.data.assembly import get_datasets
from ddnerf_tpu_torch.eval.evaluate import eval_model, load_pipeline
from ddnerf_tpu_torch.parallel import mesh as pmesh
from ddnerf_tpu_torch.render.renderer import ImageRenderer
from ddnerf_tpu_torch.render.video import render_model_video
from ddnerf_tpu_torch.train.loop import train

root = sys.argv[1]
with open(f"{root}/cfgs.json") as f:
    cfgs = {k: Config.from_dict(v).resolved() for k, v in json.load(f).items()}
mesh = pmesh.init_group("cpu")
errors = []
for n in (1, 3):
    try:
        pmesh.maybe_mesh(cfgs["straight"].replace_at("parallel.num_devices", n),
                         "cpu")
    except ValueError as e:
        errors.append(str(e))
try:  # gloo's collectives cannot be captured
    train(cfgs["straight"], max_iters=1, device="cpu", step_mode="graph")
except ValueError as e:
    errors.append(str(e))
train(cfgs["straight"], max_iters=12, device="cpu")
train(cfgs["resumed"], max_iters=6, device="cpu")
train(cfgs["resumed"], max_iters=12, device="cpu")
train(cfgs["host"], max_iters=6, device="cpu")
straight = os.path.join(root, "straight", "run")
eval_model(straight, max_images=2, save_images=True, device="cpu")
render_model_video(straight, max_frames=2, save_images=True, device="cpu")
ndc = os.path.join(root, "ndc")
eval_model(ndc, max_images=1, save_images=True, extract_ptc=True,
           device="cpu")
render_model_video(ndc, max_frames=1, device="cpu")

# The validation maps of the trained run, dp loss included.
cfg = cfgs["straight"]
_, val_ds, cfg = get_datasets(cfg)
renderer = ImageRenderer(cfg, load_pipeline(straight, cfg, mesh.device,
                                             mesh=mesh), mode="validation")
pose, _ = val_ds.get_next_validation_pose()
out = renderer.render_image_from_pose(pose, val_ds.H, val_ds.W, val_ds.focal)
if mesh.primary:
    np.savez(f"{root}/maps.npz", **{f"{i}/{k}": np.asarray(v)
                                    for i in out for k, v in out[i].items()})
with open(f"{root}/rank{mesh.rank}.json", "w") as f:
    json.dump({"errors": errors}, f)
pmesh.destroy_group()
"""


def _records(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k not in ("time", "rays_per_sec")} for line in f]


def _ndc_logdir(root):
    """An LLFF scene on disk and a logdir of seeded weights for it."""
    write_synthetic_llff(os.path.join(root, "scene"), size=16, n=5, seed=1)
    cfg = Config.from_dict(_tiny_dict(
        root, experiment={"id": "ndc"},
        dataset={"type": "llff", "basedir": os.path.join(root, "scene"),
                 "downsample_factor": 2, "ndc_rays": True, "near": 0.0,
                 "far": 1.0, "llffhold": 2, "bd_factor": 0.75,
                 "synthetic": False},
        nerf={**_tiny_dict()["nerf"],
              "validation": {"num_coarse": 4, "num_fine": 4,
                             "perturb": False, "chunksize": 20}})).resolved()
    logdir = os.path.join(root, "ndc")
    save_config_snapshot(cfg, logdir)
    pipe = NerfPipeline(cfg, "cpu", seed=5)
    save_checkpoint(os.path.join(logdir, "checkpoint.ckpt"), pipe.coarse,
                    pipe.fine, step=3)
    return logdir


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The two-rank program's logdirs and outputs, and one process's copies
    of the logdirs it evaluates."""
    root = str(tmp_path_factory.mktemp("loop_group"))
    cfgs = {name: _tiny_dict(os.path.join(root, name)) for name in
            ("straight", "resumed", "host")}
    cfgs["host"] = _tiny_dict(os.path.join(root, "host"),
                              parallel={"compute_dtype": "float32",
                                        "max_store_gb": 0.0},
                              dataset={"single_image_mode": False})
    with open(os.path.join(root, "cfgs.json"), "w") as f:
        json.dump(cfgs, f)
    ndc = _ndc_logdir(root)
    outs = _spawn(_LOOP_PROGRAM, root)
    # One process, on the files the group trained.
    one = {}
    for name, src, ckpt in (
            ("straight", os.path.join(root, "straight", "run"),
             "checkpoint_12.ckpt"), ("ndc", ndc, "checkpoint.ckpt")):
        one[name] = os.path.join(root, "one", name)
        os.makedirs(one[name])
        for f in ("config.yml", ckpt):
            shutil.copy(os.path.join(src, f), one[name])
    eval_model(one["straight"], max_images=2, save_images=True, device="cpu")
    render_model_video(one["straight"], max_frames=2, save_images=True,
                       device="cpu")
    eval_model(one["ndc"], max_images=1, save_images=True, extract_ptc=True,
               device="cpu")
    render_model_video(one["ndc"], max_frames=1, device="cpu")
    host_one = Config.from_dict(cfgs["host"]).resolved().replace_at(
        "experiment.logdir", os.path.join(root, "one", "host"))
    train(host_one, max_iters=6, device="cpu", verbose=False)
    return root, one, outs


def test_resume_on_two_ranks_equals_a_straight_run(group):
    """6 iterations, then the same command to 12: the train records, the
    retained checkpoints and everything in them (both ranks' generator
    states, the shared image generator, Adam) equal 12 iterations
    straight, bitwise.  (Validation images follow the reference's
    round-robin rule on resume, which does not count the validation at a
    run's last iteration: the validation records differ, as they do in one
    process.)"""
    root, _, _ = group
    a, b = (os.path.join(root, name, "run") for name in ("straight",
                                                         "resumed"))

    def train_records(logdir):
        return [r for r in _records(logdir) if r["kind"] == "train"]

    assert train_records(a) == train_records(b)
    assert all_steps(a) == all_steps(b) == [10, 12]
    ca, cb = (torch.load(step_path(d, 12), weights_only=True) for d in (a, b))
    assert ca["world_size"] == 2 and len(ca["generator_states"]) == 2
    assert not torch.equal(*ca["generator_states"])
    assert torch.equal(ca["generator_state"], ca["generator_states"][0])
    assert "image_generator_state" in ca
    flat_a, flat_b = (torch.utils._pytree.tree_flatten(c) for c in (ca, cb))
    assert flat_a[1] == flat_b[1]
    for x, y in zip(flat_a[0], flat_b[0]):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y


def test_one_writer(group):
    """Rank 0 prints the group and the [TRAIN] / [VAL] lines, rank 1
    nothing; every iteration has one record; eval and video wrote their
    files once."""
    root, _, outs = group
    assert outs[0].startswith("2 ranks, backend gloo, cpu\n")
    assert "[TRAIN] iter 11" in outs[0] and "[VAL] iter 11" in outs[0]
    assert "results written to" in outs[0] and "video written to" in outs[0]
    assert outs[1] == ""
    records = [r for r in _records(os.path.join(root, "straight", "run"))
               if r["kind"] == "train"]
    assert [r["step"] for r in records] == list(range(12))


def test_rerun_at_world_size_one_raises(group):
    """A checkpoint of two ranks holds two generator states: one process
    may not go on from it, nor reuse rank 0's stream."""
    root, _, _ = group
    scratch = os.path.join(root, "rerun")
    shutil.copytree(os.path.join(root, "resumed"), scratch)
    cfg = Config.from_dict(_tiny_dict(scratch)).resolved()
    with pytest.raises(ValueError,
                       match="world size 2; this run has world size 1"):
        train(cfg, max_iters=14, device="cpu", verbose=False)


def test_num_devices_mismatch_and_graph_under_gloo_raise(group):
    """``parallel.num_devices`` 1 or 3 under two ranks, and a captured step
    on a gloo group, raise on every rank."""
    root, _, _ = group
    for rank in (0, 1):
        with open(os.path.join(root, f"rank{rank}.json")) as f:
            errors = json.load(f)["errors"]
        assert len(errors) == 3
        assert "single process" in errors[0] and "2 ranks" in errors[0]
        assert "num_devices: 3" in errors[1] and "world size is 2" in errors[1]
        assert "gloo group" in errors[2] and "--step-mode eager" in errors[2]


def test_host_sampling_two_ranks_equals_one_process(group):
    """Both runs draw the JAX loop's global batches; two ranks take half of
    each.  The losses of every iteration agree."""
    root, _, _ = group
    two = _records(os.path.join(root, "host", "run"))
    one = _records(os.path.join(root, "one", "host", "run"))
    losses = [[r["loss"] for r in recs if r["kind"] == "train"]
              for recs in (two, one)]
    assert len(losses[0]) == 6
    np.testing.assert_allclose(losses[0], losses[1], rtol=HOST_LOSS_RTOL)


def _results(path):
    with open(os.path.join(path, "validation", "results.txt")) as f:
        return [line for line in f if "model_time" not in line]


def test_eval_on_two_ranks_equals_one_process(group):
    """The same results.txt (but for the timings) and the same decoded
    image dumps, with the density noise of the validation config on."""
    root, one, _ = group
    two = os.path.join(root, "straight", "run")
    assert _results(two) == _results(one["straight"])
    for i in ("0", "1"):
        names = sorted(os.listdir(os.path.join(two, "validation", i)))
        assert names == sorted(os.listdir(os.path.join(one["straight"],
                                                       "validation", i)))
        for name in names:
            np.testing.assert_array_equal(
                read_image(os.path.join(two, "validation", i, name)),
                read_image(os.path.join(one["straight"], "validation", i,
                                        name)), err_msg=name)


def test_video_on_two_ranks_equals_one_process(group):
    root, one, _ = group
    two, _ = read_avi(os.path.join(root, "straight", "run", "video",
                                   "video.avi"))
    want, _ = read_avi(os.path.join(one["straight"], "video", "video.avi"))
    assert two.shape == (2, 64, 128, 3)
    np.testing.assert_array_equal(two, want)


def test_ndc_eval_and_frame_on_two_ranks_equal_one_process(group):
    """The NDC rays are projected over the whole image on every rank and
    the frame's disparity quantized after the gather: a per-strip
    projection or scale would show here."""
    root, one, _ = group
    two = os.path.join(root, "ndc")
    assert _results(two) == _results(one["ndc"])
    np.testing.assert_allclose(
        np.load(os.path.join(two, "validation", "ptc_0.npy")),
        np.load(os.path.join(one["ndc"], "validation", "ptc_0.npy")),
        rtol=CPU_MAP_RTOL, atol=CPU_MAP_RTOL)
    frames, _ = read_avi(os.path.join(two, "video", "video.avi"))
    want, _ = read_avi(os.path.join(one["ndc"], "video", "video.avi"))
    assert frames.shape == (1, 8, 16, 3) and frames[0, :, 8:].std() > 0
    np.testing.assert_array_equal(frames, want)


def test_validation_maps_on_two_ranks_equal_one_process(group):
    """The validation render's maps, and its dp loss (the chunks' values
    weighted by their real rays) to the tolerance of a different sum."""
    root, one, _ = group
    got = dict(np.load(os.path.join(root, "maps.npz")))
    cfg = Config.from_dict(_tiny_dict(os.path.join(root, "straight")))
    cfg = cfg.resolved()
    from ddnerf_tpu_torch.data.assembly import get_datasets

    _, val_ds, cfg = get_datasets(cfg)
    renderer = ImageRenderer(cfg, load_pipeline(one["straight"], cfg,
                                                torch.device("cpu")),
                             mode="validation")
    pose, _ = val_ds.get_next_validation_pose()
    out = renderer.render_image_from_pose(pose, val_ds.H, val_ds.W,
                                          val_ds.focal)
    want = {f"{i}/{k}": np.asarray(v) for i in out for k, v in out[i].items()}
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if key.endswith("dp_loss"):
            np.testing.assert_allclose(got[key], w, rtol=1e-5, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], w, rtol=CPU_MAP_RTOL,
                                       atol=CPU_MAP_RTOL, err_msg=key)


_COLMAP_PROGRAM = r"""
import sys
import numpy as np
import torch.distributed as dist
from ddnerf_tpu_torch.config import load_config
from ddnerf_tpu_torch.data.assembly import get_datasets
from ddnerf_tpu_torch.parallel import mesh as pmesh

root, config = sys.argv[1:3]
mesh = pmesh.init_group("cpu")
cfg = load_config(config).merge_from_list(
    ["dataset.basedir", f"{root}/scene"]).resolved()
dist.barrier()  # both ranks find no pose cache and build it together
train_ds, val_ds, cfg = get_datasets(cfg)
np.savez(f"{root}/rank{mesh.rank}.npz", store=train_ds.device_store(),
         images=val_ds.images, poses=val_ds.poses,
         near_far=[cfg.dataset.near, cfg.dataset.far])
pmesh.destroy_group()
"""


def test_two_ranks_load_one_colmap_only_scene(tmp_path):
    """C12 under torchrun: two gloo ranks load one scene that holds only a
    COLMAP model and its images, each building ``poses_bounds.npy`` (and
    the minify cache) at once; both read the arrays one process reads on
    its own copy of the scene."""
    from test_torch_port_colmap import write_colmap_scene

    from ddnerf_tpu_torch.config import load_config
    from ddnerf_tpu_torch.data.assembly import get_datasets

    root = str(tmp_path)
    write_colmap_scene(os.path.join(root, "scene"))
    shutil.copytree(os.path.join(root, "scene"), os.path.join(root, "one"))
    config = os.path.join(REPO, "configs", "ff_dd.yml")
    _spawn(_COLMAP_PROGRAM, root, config)
    train_ds, val_ds, cfg = get_datasets(load_config(config).merge_from_list(
        ["dataset.basedir", os.path.join(root, "one")]).resolved())
    want = {"store": train_ds.device_store(), "images": val_ds.images,
            "poses": val_ds.poses,
            "near_far": [cfg.dataset.near, cfg.dataset.far]}
    for rank in (0, 1):
        got = np.load(os.path.join(root, f"rank{rank}.npz"))
        assert sorted(got.files) == sorted(want)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert not [f for f in os.listdir(os.path.join(root, "scene"))
                if f.startswith(".")]
