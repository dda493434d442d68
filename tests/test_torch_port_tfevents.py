"""The port's TensorBoard events (``ddnerf_tpu_torch/viz/tfevents.py``)
against tensorboardX's: the same Documenter calls written once through
tensorboardX and once through the port's writer, in a process where
importing tensorboardX, tensorboard or protobuf fails, read back with
TensorBoard's ``event_accumulator``.  Tags, steps, scalars (bitwise, as
float32), decoded image pixels and histogram buckets must agree, and the
port's reader must decode its own files as TensorBoard does."""

import glob
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("tensorboardX", "tensorboard", "google.protobuf")
H, W = 8, 10  # image size of the validation outputs
RAYS = 2  # depth-analysis rays

# Writes the port's events with the writer-making modules blocked.
_PROGRAM = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of it raises ImportError
sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})
from ddnerf_tpu_torch.viz.documentation import Documenter
import test_torch_port_tfevents as t
doc = Documenter(sys.argv[1])
t.drive(doc)
doc.close()
"""


def _validation_output(rng, depth, empty_hist):
    def cycle(c):
        out = {"rgb": rng.random((H, W, 3)).astype(np.float32),
               "disp": rng.random((H, W)).astype(np.float32)}
        if c == 0 and depth:
            n = 0 if empty_hist else 37
            out["mus_hist"] = rng.normal(3.0, 1.0, n).astype(np.float32)
            out["sigmas_hist"] = rng.gamma(2.0, 0.1, n).astype(np.float32)
            out["smoothed_sigmas_hist"] = np.abs(
                rng.normal(0.0, 1e-3, n)).astype(np.float32)
            out["corrected_disp_map"] = rng.random((H, W)).astype(np.float32)
        return out

    return {0: cycle(0), 1: cycle(1)}


def _depth_output(rng):
    pdf = lambda: rng.random((RAYS, 1000)).astype(np.float32)  # noqa: E731
    return {0: {"uniform_incell_pdf": pdf(),
                "t_vals": np.sort(rng.uniform(2, 6, (RAYS, 5)), -1)},
            1: {"uniform_incell_pdf": pdf(), "gaussian_incell_pdf": pdf(),
                "smoothed_gaussian_incell_pdf": pdf(),
                "t_vals": np.sort(rng.uniform(2, 6, (RAYS, 9)), -1)}}


def drive(doc):
    """The Documenter calls both writers receive, from a fixed seed."""
    rng = np.random.default_rng(0)
    keys = ("loss", "loss_coarse", "loss_fine", "psnr_coarse", "psnr_fine",
            "lr", "dp_loss", "sig_reg", "sig_loss", "mus_reg", "mus_loss")
    for step in range(4):
        doc.write_train_iter(step, {k: rng.normal() for k in keys},
                             {"train/rays_per_sec": 1e5 * rng.random()})
    valid = ("loss", "loss_coarse", "loss_fine", "psnr_fine", "psnr_coarse",
             "dp_loss")
    target = rng.random((H, W, 3)).astype(np.float32)
    # Step 1: no section passed the pdf threshold (empty histogram input).
    for step, empty in ((1, True), (3, False)):
        doc.write_valid_iter(step, {k: rng.normal() for k in valid},
                             _validation_output(rng, True, empty), target,
                             is_ddnerf=True)
    doc.write_valid_iter(3, {k: rng.normal() for k in valid[:-1]},
                         _validation_output(rng, False, False), target,
                         is_ddnerf=False)
    doc.write_depth_analysis_rays(3, _depth_output(rng), [3.5, 0.0], 2.0,
                                  6.0)


def _events_file(logdir):
    files = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    assert len(files) == 1, files
    return files[0]


def _port_events(tmp_path):
    logdir = str(tmp_path / "port")
    subprocess.run([sys.executable, "-c", _PROGRAM, logdir], cwd=REPO,
                   check=True, timeout=120)
    return _events_file(logdir)


def _accumulate(path):
    """TensorBoard's own reader, as TensorBoard runs without TensorFlow
    (its record-reading stub; loading TensorFlow here takes ~15 s)."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setitem(sys.modules, "tensorflow", None)
        from tensorboard.backend.event_processing import event_accumulator as ea

        acc = ea.EventAccumulator(path, size_guidance={
            ea.SCALARS: 0, ea.IMAGES: 0, ea.HISTOGRAMS: 0})
        acc.Reload()
    return acc


def _pixels(encoded):
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(encoded)))


def test_port_events_equal_tensorboardx(tmp_path):
    from tensorboardX import SummaryWriter

    from ddnerf_tpu_torch.viz.documentation import Documenter

    tbx_dir = str(tmp_path / "tbx")
    doc = Documenter(tbx_dir, use_tensorboard=False)
    doc.writer = SummaryWriter(tbx_dir)
    drive(doc)
    doc.close()
    tbx, port = _accumulate(_events_file(tbx_dir)), _accumulate(
        _port_events(tmp_path))

    tags = tbx.Tags()
    for kind in ("scalars", "images", "histograms"):
        assert sorted(port.Tags()[kind]) == sorted(tags[kind]), kind
    assert len(tags["scalars"]) == 18 and len(tags["images"]) == 8
    assert len(tags["histograms"]) == 3
    for tag in tags["scalars"]:
        a, b = tbx.Scalars(tag), port.Scalars(tag)
        assert [(e.step, e.value) for e in a] == \
            [(e.step, e.value) for e in b], tag
        assert all(np.float32(e.value) == e.value for e in b)
    for tag in tags["images"]:
        a, b = tbx.Images(tag), port.Images(tag)
        assert [e.step for e in a] == [e.step for e in b], tag
        for x, y in zip(a, b):
            assert (x.width, x.height) == (y.width, y.height)
            np.testing.assert_array_equal(_pixels(y.encoded_image_string),
                                          _pixels(x.encoded_image_string))
    for tag in tags["histograms"]:
        a, b = tbx.Histograms(tag), port.Histograms(tag)
        assert [e.step for e in a] == [e.step for e in b] == [3], tag
        for x, y in zip(a, b):
            x, y = x.histogram_value, y.histogram_value
            assert list(y.bucket_limit) == list(x.bucket_limit)
            assert list(y.bucket) == list(x.bucket)
            assert (y.min, y.max, y.num) == (x.min, x.max, x.num)
            np.testing.assert_allclose([y.sum, y.sum_squares],
                                       [x.sum, x.sum_squares], rtol=1e-6)


def test_read_events_matches_event_accumulator(tmp_path):
    from ddnerf_tpu_torch.viz.tfevents import read_events

    path = _port_events(tmp_path)
    acc = _accumulate(path)
    events = read_events(path)
    assert events[0]["file_version"] == "brain.Event:2"
    seen = {"scalar": {}, "image": {}, "histogram": {}}
    for e in events[1:]:
        (v,) = e["values"]
        seen[v["kind"]].setdefault(v["tag"], []).append((e["step"], v))
    assert sorted(seen["scalar"]) == sorted(acc.Tags()["scalars"])
    assert sorted(seen["image"]) == sorted(acc.Tags()["images"])
    assert sorted(seen["histogram"]) == sorted(acc.Tags()["histograms"])
    for tag, got in seen["scalar"].items():
        assert [(s, v["value"]) for s, v in got] == \
            [(e.step, e.value) for e in acc.Scalars(tag)]
    for tag, got in seen["image"].items():
        for (s, v), e in zip(got, acc.Images(tag), strict=True):
            assert s == e.step and v["size"][:2] == (e.height, e.width)
            np.testing.assert_array_equal(
                v["value"], _pixels(e.encoded_image_string))
    for tag, got in seen["histogram"].items():
        for (s, v), e in zip(got, acc.Histograms(tag), strict=True):
            h = e.histogram_value
            assert s == e.step
            assert v["value"] == {
                "min": h.min, "max": h.max, "num": h.num, "sum": h.sum,
                "sum_squares": h.sum_squares,
                "bucket_limit": list(h.bucket_limit),
                "bucket": list(h.bucket)}


def test_read_events_refuses_corrupt_records(tmp_path):
    from ddnerf_tpu_torch.viz.tfevents import EventsWriter, read_events

    writer = EventsWriter(str(tmp_path))
    writer.add_scalar("a/b", 0.25, 7)
    writer.close()
    data = bytearray(open(writer.path, "rb").read())
    assert read_events(writer.path)[1]["values"][0]["value"] == 0.25
    for at, what in ((len(data) - 6, "payload CRC"), (3, "length CRC")):
        bad = bytearray(data)
        bad[at] ^= 1
        open(writer.path, "wb").write(bytes(bad))
        with pytest.raises(ValueError, match=what):
            read_events(writer.path)
    open(writer.path, "wb").write(bytes(data[:-3]))
    with pytest.raises(ValueError, match="truncated"):
        read_events(writer.path)


def test_documenter_raises_where_it_cannot_write_events(tmp_path,
                                                       monkeypatch):
    """No events are dropped: a logdir whose events file cannot be
    created raises, as does a write to a file that went away."""
    from ddnerf_tpu_torch.viz import tfevents
    from ddnerf_tpu_torch.viz.documentation import Documenter

    monkeypatch.setattr(tfevents, "time",
                        types.SimpleNamespace(time=lambda: 1700000000.5))
    monkeypatch.setattr(tfevents, "socket",
                        types.SimpleNamespace(gethostname=lambda: "host"))
    logdir = tmp_path / "run"
    (logdir / "events.out.tfevents.1700000000.host").mkdir(parents=True)
    with pytest.raises(IsADirectoryError):
        Documenter(str(logdir))
    doc = Documenter(str(tmp_path / "other"))
    doc.writer._f.close()
    with pytest.raises(ValueError, match="closed file"):
        doc.write_train_iter(0, {k: 0.0 for k in (
            "loss", "loss_coarse", "loss_fine", "psnr_coarse", "psnr_fine",
            "lr")})
    doc._jsonl.close()


def test_train_loop_writes_the_events_chip_smoke_reads(tmp_path):
    """A tiny CPU training run through the port's loop: its logdir holds
    the events ``chip_smoke.py::check_events`` requires on the card."""
    sys.path.insert(0, REPO)
    import chip_smoke

    from ddnerf_tpu_torch.config import Config
    from ddnerf_tpu_torch.train.loop import train

    cfg = Config.from_dict({
        "experiment": {"id": "ev", "logdir": str(tmp_path), "train_iters": 6,
                       "validate_every": 5, "save_every": 100,
                       "print_every": 5},
        "nerf": {"type": "DDNerfModel", "coarse_hidden_size": 16,
                 "fine_hidden_size": 16,
                 "train": {"num_coarse": 4, "num_fine": 4,
                           "num_random_rays": 32},
                 "validation": {"num_coarse": 4, "num_fine": 4,
                                "chunksize": 4096}},
        "dataset": {"type": "blender", "synthetic": True,
                    "single_image_mode": False},
        "parallel": {"num_devices": 1},
    }).resolved()
    _, logdir = train(cfg, device="cpu")
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        steps = [r["step"] for r in map(json.loads, f) if r["kind"] == "train"]
    summary = chip_smoke.check_events(logdir, "events")
    assert summary["train_steps"] == steps
    assert summary["images"] >= 5 and summary["histograms"] > 0
