"""Resume and retained checkpoints of the port's train loop: a run stopped
and rerun continues bitwise where it stopped, ``experiment.max_keep_ckpts``
step files are kept, a retained step is selected by ``--checkpoint``, a
checkpoint of the other model family is refused, and the save rule is the
JAX loop's."""

import json
import os

import pytest
import torch

from ddnerf_tpu.config import Config
from ddnerf_tpu_torch.cli import eval as eval_cli
from ddnerf_tpu_torch.cli import render_video as video_cli
from ddnerf_tpu_torch.cli import train as train_cli
from ddnerf_tpu_torch.eval.evaluate import load_pipeline
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.train import checkpoint as ckpt
from ddnerf_tpu_torch.train.loop import train
from ddnerf_tpu_torch.utils.weights import save_checkpoint


def _cfg(logdir, nerf_type="DDNerfModel", **experiment):
    return Config.from_dict({
        "experiment": {"id": "run", "logdir": str(logdir), "train_iters": 50,
                       "validate_every": 4, "save_every": 4, "print_every": 4,
                       **experiment},
        "nerf": {
            "type": nerf_type, "coarse_hidden_size": 16,
            "fine_hidden_size": 16,
            # Jitter and density noise on: the run consumes its generator.
            "train": {"num_coarse": 4, "num_fine": 4, "num_random_rays": 32,
                      "perturb": True, "radiance_field_noise_std": 1.0},
            "validation": {"num_coarse": 4, "num_fine": 4, "perturb": False,
                           "chunksize": 4096},
        },
        "dataset": {"type": "blender", "synthetic": True,
                    "single_image_mode": True},
        "parallel": {"compute_dtype": "bfloat16", "pallas_mlp": "auto"},
    }).resolved()


def _raw(logdir, name=None):
    """A file of ``logdir`` by name, or the one a reader finds by default."""
    path = os.path.join(logdir, name) if name else ckpt.checkpoint_path(logdir)
    return torch.load(path, weights_only=True)


def _assert_same_tree(a, b, path=""):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("nerf_type", ["DDNerfModel", "GeneralMipNerfModel"])
def test_stop_and_rerun_equals_one_run_bitwise(tmp_path, nerf_type, capsys):
    """12 iterations in one run against 6, stop, rerun to 12: parameters,
    Adam moments and step counts, the saved step and the generator's state
    are bitwise equal.  The plain versions the CPU runs are deterministic,
    so this holds only if the generator (ray draws, jitter, noise) is
    restored with everything else."""
    _, whole = train(_cfg(tmp_path / "whole", nerf_type), max_iters=12,
                     device="cpu")
    capsys.readouterr()
    state, parts = train(_cfg(tmp_path / "parts", nerf_type), max_iters=6,
                         device="cpu")
    assert state.step == 6 and ckpt.latest_step(parts) == 6
    capsys.readouterr()
    state, parts = train(_cfg(tmp_path / "parts", nerf_type), max_iters=12,
                         device="cpu")
    out = capsys.readouterr().out
    assert state.step == 12
    assert "resumed from" in out and "at iteration 6" in out
    # It went on, not back: iteration 8 is the first print event after 6.
    assert [ln.split()[2] for ln in out.splitlines()
            if ln.startswith("[TRAIN]")] == ["8", "11"]
    a, b = _raw(whole), _raw(parts)
    assert a["iter"] == b["iter"] == 12
    assert ("model_2_state_dict" in a) == (nerf_type == "DDNerfModel")
    _assert_same_tree(a, b)
    assert a[ckpt.OPTIMIZER_KEY]["state"] and ckpt.GENERATOR_KEY in a
    # metrics.jsonl was appended to: every iteration once.
    with open(os.path.join(parts, "metrics.jsonl")) as f:
        steps = [r["step"] for r in map(json.loads, f) if r["kind"] == "train"]
    assert steps == list(range(12))


def test_resume_restores_the_validation_round_robin(tmp_path, monkeypatch):
    """``val_ds.current_idx = (step // validate_every) % len(val_ds)``, as
    the reference (train_model.py:81)."""
    from ddnerf_tpu_torch.train import loop

    train(_cfg(tmp_path, validate_every=2), max_iters=6, device="cpu")
    seen = []
    real = loop._validate

    def spy(cfg, i, state, renderer, val_ds, doc, da_rays=None):
        seen.append((i, val_ds.current_idx))
        return real(cfg, i, state, renderer, val_ds, doc, da_rays)

    monkeypatch.setattr(loop, "_validate", spy)
    train(_cfg(tmp_path, validate_every=2), max_iters=8, device="cpu")
    assert seen == [(6, (6 // 2) % 2), (7, 0)]


def test_max_keep_ckpts_keeps_that_many_step_files(tmp_path, capsys):
    cfg = _cfg(tmp_path, save_every=2, max_keep_ckpts=3)
    _, logdir = train(cfg, max_iters=11, device="cpu")
    # Saved after iterations 2, 4, 6, 8, 10 (the last): steps 3 ... 11.
    assert ckpt.all_steps(logdir) == [7, 9, 11]
    assert ckpt.latest_step(logdir) == 11
    # One file per save: the newest step file is the default, no copy.
    assert ckpt.checkpoint_path(logdir) == ckpt.step_path(logdir, 11)
    assert sorted(n for n in os.listdir(logdir) if n.endswith(".ckpt")) == [
        "checkpoint_11.ckpt", "checkpoint_7.ckpt", "checkpoint_9.ckpt"]
    assert _raw(logdir)["iter"] == 11
    one = _cfg(tmp_path / "one", save_every=2)  # the default keeps one
    _, single = train(one, max_iters=7, device="cpu")
    assert ckpt.all_steps(single) == [7]
    capsys.readouterr()

    # A retained step through the eval and video CLIs; an absent one
    # raises with the steps there are.
    eval_cli.main(["--logdir", logdir, "--checkpoint", "9", "--max-images",
                   "1", "--device", "cpu"])
    assert "checkpoint_9.ckpt (iter 9)" in capsys.readouterr().out
    video_cli.main(["--logdir", logdir, "--checkpoint", "7", "--max-frames",
                    "1", "--device", "cpu"])
    assert "checkpoint_7.ckpt (iter 7)" in capsys.readouterr().out
    for cli in (eval_cli, video_cli):
        with pytest.raises(FileNotFoundError,
                           match=r"step 5 .*available: \[7, 9, 11\]"):
            cli.main(["--logdir", logdir, "--checkpoint", "5", "--device",
                      "cpu"])


def test_load_checkpoint_starts_another_logdir_from_a_run(tmp_path, capsys):
    """``--load-checkpoint`` takes a logdir or a checkpoint file."""
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(_cfg(tmp_path / "a").dump())
    train_cli.main(["--config", str(cfg_path), "--max-iters", "3", "--device",
                    "cpu"])
    first = str(tmp_path / "a" / "run")
    capsys.readouterr()
    for source in (first, os.path.join(first, "checkpoint_3.ckpt")):
        train_cli.main(["--config", str(cfg_path), "--max-iters", "5",
                        "--device", "cpu", "--load-checkpoint", source,
                        "experiment.logdir", str(tmp_path / "b"),
                        "experiment.id", os.path.basename(source)])
        out = capsys.readouterr().out
        assert "at iteration 3" in out
        assert [ln.split()[2] for ln in out.splitlines()
                if ln.startswith("[TRAIN]")] == ["4"]
    with pytest.raises(FileNotFoundError):
        train_cli.main(["--config", str(cfg_path), "--device", "cpu",
                        "--load-checkpoint", str(tmp_path / "nowhere")])


def test_a_checkpoint_without_training_state_is_not_resumed(tmp_path):
    """A file made for evaluation (networks only) in the logdir: the loop
    says that it cannot resume from it, and does not start over it."""
    cfg = _cfg(tmp_path)
    logdir = tmp_path / "run"
    logdir.mkdir()
    pipe = NerfPipeline(cfg, "cpu")
    save_checkpoint(str(logdir / "checkpoint.ckpt"), pipe.coarse, pipe.fine,
                    step=4)
    (logdir / "config.yml").write_text("the snapshot of the run before\n")
    with pytest.raises(ValueError, match="optimizer_state_dict"):
        train(cfg, max_iters=6, device="cpu")
    assert _raw(str(logdir))["iter"] == 4
    # The refused rerun left the snapshot that eval trusts alone.
    assert (logdir / "config.yml").read_text().startswith("the snapshot")


def test_a_rerun_with_nothing_left_says_so(tmp_path, capsys):
    train(_cfg(tmp_path), max_iters=4, device="cpu")
    before = _raw(str(tmp_path / "run"))
    capsys.readouterr()
    state, logdir = train(_cfg(tmp_path), max_iters=3, device="cpu")
    out = capsys.readouterr().out
    assert state.step == 4 and "nothing to train" in out
    assert "[TRAIN]" not in out
    _assert_same_tree(before, _raw(logdir))


@pytest.mark.parametrize("file_type,cfg_type", [
    ("GeneralMipNerfModel", "DDNerfModel"),
    ("DDNerfModel", "GeneralMipNerfModel")])
def test_checkpoint_of_the_other_family_is_refused(tmp_path, file_type,
                                                   cfg_type):
    pipe = NerfPipeline(_cfg(tmp_path, file_type), "cpu")
    path = str(tmp_path / "checkpoint.ckpt")
    save_checkpoint(path, pipe.coarse, pipe.fine, step=1)
    with pytest.raises(ValueError,
                       match="model_1_state_dict.*model_2_state_dict|"
                             "model_2_state_dict.*model_1_state_dict only"):
        load_pipeline(str(tmp_path), _cfg(tmp_path, cfg_type),
                      torch.device("cpu"))


def test_save_rule_is_the_jax_loops(tmp_path, capsys):
    """Saved at ``i > 0 and (i % save_every == 0 or i is the last)``: a run
    of one iteration saves nothing (``ddnerf_tpu/train/loop.py:247``), a
    run of two saves at its end."""
    _, logdir = train(_cfg(tmp_path / "one"), max_iters=1, device="cpu")
    assert ckpt.all_steps(logdir) == []
    assert not os.path.exists(os.path.join(logdir, "checkpoint.ckpt"))
    _, logdir = train(_cfg(tmp_path / "two"), max_iters=2, device="cpu")
    assert ckpt.all_steps(logdir) == [2]
    # The [VAL] line: the JAX package's format, the dp loss appended for
    # DDNeRF only.
    lines = [ln.split() for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[VAL]")]
    assert lines and all(ln[1:8:2] == ["iter", "loss", "psnr", "time"]
                         and ln[9] == "dp_loss" for ln in lines)
    train(_cfg(tmp_path / "mip", "GeneralMipNerfModel"), max_iters=1,
          device="cpu")
    lines = [ln.split() for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[VAL]")]
    assert lines and all(len(ln) == 9 and "dp_loss" not in ln for ln in lines)
