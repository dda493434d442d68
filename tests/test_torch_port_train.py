"""Port parity for the training slice: the schedules, the train-mode loss
and its gradient (the fused-MLP training Function's plain versions on the
CPU against the JAX package's fused Pallas train kernels in interpret
mode), microbatch accumulation, the pipeline's kernel policy, and the
training CLI followed by the eval CLI on its logdir."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddnerf_tpu.config import Config, load_config
from ddnerf_tpu.core import schedules as jsched
from ddnerf_tpu.data.assembly import get_datasets
from ddnerf_tpu.models.nerf import NerfPipeline as JaxPipeline
from ddnerf_tpu.models.nerf import RayBatch as JaxRays
from ddnerf_tpu.train.step import compute_loss as jax_compute_loss
from ddnerf_tpu.train.step import schedule_values as jax_schedule_values
from ddnerf_tpu_torch.cli import eval as eval_cli
from ddnerf_tpu_torch.cli import train as train_cli
from ddnerf_tpu_torch.core import schedules
from ddnerf_tpu_torch.data.datasets import load_train_store
from ddnerf_tpu_torch.kernels import fused_mlp as fk
from ddnerf_tpu_torch.models.nerf import NerfPipeline, RayBatch
from ddnerf_tpu_torch.train.state import TrainState
from ddnerf_tpu_torch.train.step import compute_loss, schedule_values, train_step
from ddnerf_tpu_torch.utils.weights import load_checkpoint, params_to_state_dict


def _cfg(**parallel):
    return Config.from_dict({
        "experiment": {"train_iters": 1000},
        "train_params": {"max_pdf_pad_iters": 400, "finnish_smooth": 600},
        "optimizer": {"lr_delay_steps": 100},
        "nerf": {
            "type": "DDNerfModel", "coarse_hidden_size": 32,
            "fine_hidden_size": 32,
            "train": {"num_coarse": 6, "num_fine": 6, "num_random_rays": 16,
                      "perturb": False, "radiance_field_noise_std": 0.0},
            "validation": {"num_coarse": 6, "num_fine": 6, "perturb": False,
                           "radiance_field_noise_std": 0.0},
        },
        "dataset": {"type": "blender", "near": 2.0, "far": 6.0},
        "parallel": {"compute_dtype": "float32", "num_devices": 1, **parallel},
    }).resolved()


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 399, 400, 500, 599, 600,
                                  1000, 1500])
def test_schedules_match_jax(step):
    """Step 0, inside the LR delay (100), the pdf-padding flip (400), the
    smoothing end (600), the midpoint and past max_steps (1000)."""
    for cfg in (_cfg(), _cfg().replace_at("train_params.pdf_padding", False)
                .replace_at("optimizer.lr_delay_steps", 0)):
        np.testing.assert_allclose(
            schedules.make_lr_schedule(cfg)(step),
            float(jsched.make_lr_schedule(cfg)(step)), rtol=1e-6)
        np.testing.assert_allclose(
            schedules.gaussian_smooth_factor(step, cfg),
            float(jsched.gaussian_smooth_factor(step, cfg)), rtol=1e-6)
        assert schedules.pdf_padding(step, cfg) == bool(
            jsched.pdf_padding(step, cfg))
        sched = schedule_values(cfg, step)
        assert isinstance(sched.pdf_padding, bool)
        assert isinstance(sched.gaussian_smooth_factor, float)


def _rays(n=8, seed=0):
    rng = np.random.default_rng(seed)
    ro = rng.standard_normal((n, 3)).astype(np.float32)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True) * 0.8  # non-unit norms
    radii = np.abs(rng.standard_normal((n, 1))).astype(np.float32) * 0.01
    target = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return ro, rd, radii, target


def _grads(pipe):
    return {"coarse": {n: p.grad for n, p in pipe.coarse.named_parameters()},
            "fine": {n: p.grad for n, p in pipe.fine.named_parameters()}}


def test_train_loss_and_gradients_match_jax_fused_train_kernels():
    """Port under ``pallas_mlp: auto`` (CPU: the training Function's plain
    versions) against JAX ``pallas_mlp: train`` with per-ray dirs (the
    fused Pallas kernels in interpret mode), f32, no jitter or noise.
    Tolerances of tests/test_pipeline_pallas.py:72-75."""
    jcfg = _cfg(pallas_mlp="train", kernel_per_ray_dirs=True)
    jpipe = JaxPipeline(jcfg)
    params = jpipe.init_params(jax.random.PRNGKey(0))
    ro, rd, radii, target = _rays()
    sched = jax_schedule_values(jcfg, 10)

    def loss_fn(p):
        return jax_compute_loss(
            jcfg, jpipe, p, JaxRays.create(*map(jnp.asarray, (ro, rd, radii)),
                                           2.0, 6.0),
            jnp.asarray(target), jax.random.PRNGKey(3), sched)

    (want_loss, want_m), want_g = jax.value_and_grad(loss_fn, has_aux=True)(
        params)

    cfg = _cfg(pallas_mlp="auto")
    pipe = NerfPipeline(cfg, "cpu")
    assert pipe.use_train_kernel
    pipe.load_state_dicts(params_to_state_dict(params["coarse"]),
                          params_to_state_dict(params["fine"]))
    loss, m = compute_loss(
        cfg, pipe, RayBatch.create(*map(torch.tensor, (ro, rd, radii)), 2.0,
                                   6.0),
        torch.tensor(target), schedule_values(cfg, 10))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for key in ("loss_coarse", "loss_fine", "dp_loss", "mus_reg", "sig_reg"):
        np.testing.assert_allclose(m[key].item(), float(want_m[key]),
                                   rtol=1e-4, atol=1e-7, err_msg=key)
    got = _grads(pipe)
    for net in ("coarse", "fine"):
        want = params_to_state_dict(want_g[net])
        for name, g in got[net].items():
            b = want[name].numpy()
            np.testing.assert_allclose(
                g.numpy(), b, rtol=5e-3,
                atol=5e-5 * max(1.0, float(np.abs(b).max())),
                err_msg=f"{net} {name}")


@pytest.mark.parametrize("policy,train_kernel,render_kernel", [
    ("off", False, False), ("render", False, True), ("train", True, False),
    ("auto", True, True), ("all", True, True)])
def test_kernel_policy_per_direction(policy, train_kernel, render_kernel):
    pipe = NerfPipeline(_cfg(pallas_mlp=policy), "cpu")
    assert pipe.use_train_kernel == train_kernel
    assert pipe.use_kernel == render_kernel


def test_microbatch_accumulation_matches_one_batch():
    """parallel.microbatch_rays = half the batch: the mean of the two chunk
    gradients and metrics equals the one-batch step (summation order)."""
    ro, rd, radii, target = _rays(16, seed=1)
    batch = {"origins": torch.tensor(ro), "directions": torch.tensor(rd),
             "radii": torch.tensor(radii), "rgb": torch.tensor(target)}
    results = []
    for mb in (0, 8):
        cfg = _cfg(pallas_mlp="auto", microbatch_rays=mb)
        pipe = NerfPipeline(cfg, "cpu", seed=0)
        state = TrainState(cfg, pipe)
        metrics = train_step(cfg, pipe, state, batch)
        assert state.step == 1
        results.append((metrics, _grads(pipe)))
    (m1, g1), (m2, g2) = results
    for key in m1:
        np.testing.assert_allclose(m2[key].item(), m1[key].item(), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    for net in g1:
        for name in g1[net]:
            np.testing.assert_allclose(g2[net][name].numpy(),
                                       g1[net][name].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{net} {name}")


def test_adam_state_matches_optax_defaults():
    cfg = _cfg()
    state = TrainState(cfg, NerfPipeline(cfg, "cpu"))
    group = state.optimizer.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["weight_decay"] == 0 and not group["amsgrad"]
    with pytest.raises(ValueError, match="optimizer"):
        TrainState(cfg.replace_at("optimizer.type", "SGD"),
                   NerfPipeline(cfg, "cpu"))


@pytest.fixture
def train_config(tmp_path):
    path = tmp_path / "cfg.yml"
    path.write_text(f"""
experiment: {{id: run, logdir: {tmp_path / 'logs'}, train_iters: 50,
  validate_every: 2, save_every: 2, print_every: 2}}
nerf:
  type: DDNerfModel
  coarse_hidden_size: 16
  fine_hidden_size: 16
  train: {{num_coarse: 4, num_fine: 4, num_random_rays: 32, chunksize: 1024}}
  validation: {{num_coarse: 4, num_fine: 4, perturb: false, chunksize: 300}}
dataset: {{type: blender, synthetic: true, single_image_mode: true}}
parallel: {{compute_dtype: bfloat16, pallas_mlp: auto}}
""")
    return str(path), str(tmp_path / "logs" / "run")


def test_train_cli_then_eval_cli_on_cpu(train_config, capsys):
    cfg_path, logdir = train_config
    train_cli.main(["--config", cfg_path, "--max-iters", "3", "--device",
                    "cpu", "train_params.dp_coeficient", "0.2"])
    out = capsys.readouterr().out
    assert [ln.split()[2] for ln in out.splitlines()
            if ln.startswith("[TRAIN]")] == ["0", "2"]
    assert sum(ln.startswith("[VAL]") for ln in out.splitlines()) == 2
    launches = json.loads(out.split("kernel launches: ")[1].splitlines()[0])
    assert set(launches.values()) == {0}  # CPU: the plain versions ran
    snapshot = Config.from_yaml(os.path.join(logdir, "config.yml"))
    assert snapshot.train_params.dp_coeficient == 0.2  # the CLI override
    ckpt = load_checkpoint(os.path.join(logdir, "checkpoint_3.ckpt"))
    assert ckpt["step"] == 3
    raw = torch.load(os.path.join(logdir, "checkpoint_3.ckpt"),
                     weights_only=True)
    assert raw["optimizer_state_dict"]["state"]  # Adam moments saved
    records = [json.loads(line) for line in
               open(os.path.join(logdir, "metrics.jsonl"))]
    train = [r for r in records if r["kind"] == "train"]
    assert [r["step"] for r in train] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["dp_loss"])
               for r in train)
    val = [r for r in records if r["kind"] == "validation"]
    assert len(val) == 2 and all(np.isfinite(r["dp_loss"]) for r in val)

    eval_cli.main(["--logdir", logdir, "--max-images", "1", "--device",
                   "cpu"])
    out = capsys.readouterr().out
    assert "(iter 3)" in out
    text = open(os.path.join(logdir, "validation", "results.txt")).read()
    assert "psnr_fine" in text


def test_load_train_store_matches_jax_store_and_refuses_above_limit(
        train_config):
    cfg = load_config(train_config[0])
    store, val_ds, cfg_out = load_train_store(cfg, "cpu")
    train_ds, want_val, want_cfg = get_datasets(cfg)
    want = train_ds.device_store()
    assert store.device.type == "cpu" and store.shape[-1] == 10
    np.testing.assert_array_equal(store.numpy(), want)
    assert (val_ds.H, val_ds.W) == (want_val.H, want_val.W)
    assert (cfg_out.dataset.near, cfg_out.dataset.far) == (
        want_cfg.dataset.near, want_cfg.dataset.far)
    # At or above parallel.max_store_gb the store stays on the host: the
    # dataset itself comes back, for the loop to sample on the host.
    limit_gb = 0.5 * want.nbytes / 1024**3
    host, _, _ = load_train_store(
        cfg.replace_at("parallel.max_store_gb", limit_gb), "cpu")
    assert not isinstance(host, torch.Tensor)
    np.testing.assert_array_equal(host.device_store(), want)
    batch = host.sample_batch(np.random.default_rng(0), 8)
    assert [b.shape for b in batch] == [(8, 3), (8, 3), (8, 1), (8, 3)]


def test_train_cli_refuses_cuda_without_a_card(train_config, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(["--config", train_config[0], "--max-iters", "1"])


def test_training_launch_counts_stay_zero_on_cpu():
    cfg = _cfg(pallas_mlp="auto")
    pipe = NerfPipeline(cfg, "cpu")
    ro, rd, radii, target = _rays()
    before = dict(fk.LAUNCHES)
    loss, _ = compute_loss(cfg, pipe, RayBatch.create(
        *map(torch.tensor, (ro, rd, radii)), 2.0, 6.0), torch.tensor(target),
        schedule_values(cfg, 0))
    loss.backward()
    assert fk.LAUNCHES == before
    assert all(p.grad is not None for p in pipe.parameters())
