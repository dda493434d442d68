"""The training loop, on one device or on every rank of a data-parallel
group.

Counterpart of ``ddnerf_tpu/train/loop.py`` (reference
train_model.py:19-264): config snapshot, seeded networks, resume from the
logdir's newest checkpoint (or from ``load_checkpoint``), then one of the
JAX loop's two forms over the step (``train/step.py``):

* the block loop, when the ray store is on the device and
  ``experiment.train_scalars_every >= 1``: blocks that end at the nearest
  print / validate / save / final iteration, every iteration's scalars
  stacked on the device and read in ONE copy per block, then the block's
  records, the ``[TRAIN]`` line, the validation and the checkpoint.  On a
  CUDA device the step is a captured CUDA graph and a block is that many
  replays (``step_mode="graph"``, the default there); ``step_mode="eager"``
  and the CPU run the eager step under the same loop;
* the per-iteration loop otherwise: ``train_scalars_every < 1``, or a ray
  store at or above ``parallel.max_store_gb``, which stays on the host and
  is sampled there with the next batch uploaded while the step runs
  (``data/datasets.py::PrefetchedHostBatches``; always the eager step).

Train scalars go through the ``Documenter`` (``metrics.jsonl`` and a
TensorBoard events file); a whole-image validation runs
at ``validate_every`` (with the NDC depth un-warp and, under
``train_params.depth_analysis_rays``, the per-ray depth-analysis figures),
the retained checkpoints are written at ``save_every`` and at the end.
``profile_steps`` traces that many steady steps (``utils/profiling.py``);
inside ``utils/debug.py::nan_debug_mode`` the step is the eager one with a
finite check of every step.  Both model families.

Under ``torchrun`` with more than one rank (``parallel/mesh.py``) every rank
runs this loop on its share of each step's rays, as the JAX loop runs on a
mesh (``ddnerf_tpu/train/loop.py:63-146``): the device store is this rank's
pixel block, sampled by :class:`~ddnerf_tpu_torch.parallel.mesh.
ShardedStoreSampler`; the host-sampling path draws the whole global batch
from the seeded generator on every rank and takes this rank's slice; the
validation image is rendered sharded.  The step is the captured one under
NCCL and the eager one under gloo.  Rank 0 alone prints and writes (the
records, the snapshot, the checkpoints with every rank's generator state,
the profile), and the rays/s line counts the effective global batch.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ddnerf_tpu_torch.viz.documentation import Documenter
from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.core.rays import switch_t_ndc_to_regular
from ddnerf_tpu_torch.data.datasets import (
    PrefetchedHostBatches,
    load_train_store,
)
from ddnerf_tpu_torch.eval.depth_analysis import run_depth_analysis
from ddnerf_tpu_torch.eval.evaluate import resolve_device
from ddnerf_tpu_torch.models.nerf import NerfPipeline
from ddnerf_tpu_torch.parallel import mesh as pmesh
from ddnerf_tpu_torch.parallel.distributed import process_ray_slice
from ddnerf_tpu_torch.render.renderer import ImageRenderer
from ddnerf_tpu_torch.train import checkpoint as ckpt
from ddnerf_tpu_torch.train.state import TrainState
from ddnerf_tpu_torch.train.step import (
    CapturedTrainStep,
    EagerTrainStep,
    schedule_values,
)
from ddnerf_tpu_torch.utils.debug import nan_debug_enabled
from ddnerf_tpu_torch.utils.profiling import summarize, trace

STEP_MODES = ("graph", "eager")


def _resume_path(logdir: str, load_checkpoint: str) -> Optional[str]:
    """The checkpoint a run starts from: ``load_checkpoint`` (a checkpoint
    file, or a logdir that holds one: ``ddnerf_tpu/train/loop.py:70-82``),
    else the logdir's own newest, else none."""
    if load_checkpoint:
        if os.path.isfile(load_checkpoint):
            return load_checkpoint
        return ckpt.checkpoint_path(load_checkpoint)
    try:
        return ckpt.checkpoint_path(logdir)
    except FileNotFoundError:
        return None


def next_boundary(i: int, print_every: int, validate_every: int,
                  save_every: int, total: int) -> int:
    """Last iteration of the block starting at ``i``: the nearest event
    iteration (print / validate / save / final), so every event still sees
    the exact post-step state (``ddnerf_tpu/train/loop.py:275-284``)."""
    ends = [total - 1]
    for every in (print_every, validate_every, save_every):
        ends.append(i if i % every == 0 else i + every - i % every)
    return min(ends)


def train(cfg: Config, max_iters: Optional[int] = None, device="cuda",
          load_checkpoint: str = "", verbose: bool = True,
          profile_steps: int = 0, step_mode: Optional[str] = None):
    """Train ``cfg`` on ``device`` up to iteration ``max_iters`` (default
    ``experiment.train_iters``).  A logdir that already holds a checkpoint
    is continued from it: networks, Adam state, step, the generator and the
    validation round-robin are restored, and the loop runs the remaining
    iterations.  Returns (state, logdir).

    ``step_mode``: ``"graph"`` (the captured step; the default on a CUDA
    device with the store resident) or ``"eager"`` (the default on the CPU
    and with host-side sampling, and forced inside ``nan_debug_mode``).
    ``"graph"`` where it cannot run raises; it never gives way to eager,
    and that includes a gloo group, whose collectives no graph can hold.
    ``verbose=False`` silences the ``[TRAIN]`` / ``[VAL]`` lines, not the
    records.  ``profile_steps`` > 0 traces that many steady steps under
    ``logdir/plugins/profile/``; ``state.step`` advances by them, as in
    the JAX loop, and their digest is printed at the end."""
    if step_mode not in (None, *STEP_MODES):
        raise ValueError(f"step_mode={step_mode!r}: expected one of "
                         f"{' | '.join(STEP_MODES)}")
    mesh = pmesh.maybe_mesh(cfg, device)
    dev = resolve_device(device) if mesh is None else mesh.device
    primary = mesh is None or mesh.primary
    verbose = verbose and primary
    logdir = os.path.join(cfg.experiment.logdir, cfg.experiment.id)
    os.makedirs(logdir, exist_ok=True)
    # Dataset build may rescale near/far (pose normalization).
    store, val_ds, cfg = load_train_store(cfg, dev, mesh)
    use_device_store = isinstance(store, torch.Tensor)
    resume = _resume_path(logdir, load_checkpoint)

    exp = cfg.experiment
    seed = exp.randomseed
    pipeline = NerfPipeline(cfg, dev, seed=seed, mesh=mesh)
    state = TrainState(cfg, pipeline)
    sampler = image_generator = None
    sharded = mesh is not None and mesh.sharded
    if not sharded:
        generator = torch.Generator(device=dev).manual_seed(seed)
    elif use_device_store:
        sampler = pmesh.ShardedStoreSampler(
            mesh, store, cfg.nerf.train.num_random_rays,
            cfg.dataset.single_image_mode, seed)
        generator, image_generator = sampler.generator, sampler.image_generator
    else:
        generator = torch.Generator(device=dev).manual_seed(
            pmesh.rank_seed(seed, mesh.rank))
    if resume is not None:
        step = ckpt.load_train_checkpoint(resume, pipeline, state, generator,
                                          mesh, image_generator)
        # Round-robin parity on resume (train_model.py:81).
        val_ds.current_idx = (step // exp.validate_every) % len(val_ds)
        if primary:
            print(f"resumed from {resume} at iteration {step}", flush=True)
    # Only now: a checkpoint this config cannot continue has raised above
    # and left the snapshot that eval reads as it was.
    if primary:
        ckpt.save_config_snapshot(cfg, logdir)
    renderer = ImageRenderer(cfg, pipeline, mode="validation")
    total = max_iters or exp.train_iters
    start = state.step
    if start >= total and primary:
        print(f"nothing to train: iteration {start} is at or past the last "
              f"({total})", flush=True)
    rays_per_iter = pmesh.effective_train_rays(cfg, mesh)
    da_rays = (val_ds.load_depth_analysis_rays(cfg)
               if cfg.train_params.depth_analysis_rays else None)
    scalars_every = exp.train_scalars_every
    # Device-buffered per-iteration scalars (ddnerf_tpu/train/loop.py:
    # 198-201): blocks whose scalars stay on the device until the block ends.
    block_mode = use_device_store and scalars_every >= 1

    # ---- the step
    debug = nan_debug_enabled()
    if debug and primary:
        print("debug-nans: the eager step with a finite check of every "
              "step (anomaly detection cannot see inside a graph replay)",
              flush=True)
    if debug:
        step_mode = "eager"
    nccl_or_none = mesh is None or mesh.backend == "nccl"
    if step_mode is None:
        step_mode = ("graph" if dev.type == "cuda" and use_device_store
                     and nccl_or_none else "eager")
    if step_mode == "graph" and not nccl_or_none:
        raise ValueError(
            f"step_mode='graph' captures the step's collectives, which a "
            f"{mesh.backend} group cannot hold ({mesh.describe()}): use "
            f"--step-mode eager, or one card per rank (--device cuda) for "
            f"NCCL")
    if step_mode == "graph" and not (dev.type == "cuda" and use_device_store):
        raise ValueError(
            "step_mode='graph' captures the step that draws its rays from "
            "the device-resident store on a CUDA device; this run is on "
            f"{dev} with the store "
            f"{'resident' if use_device_store else 'on the host'}")
    longest = min(exp.print_every, exp.validate_every, exp.save_every)
    if use_device_store:
        if step_mode == "graph":
            stepper = CapturedTrainStep(
                cfg, pipeline, state, store, generator,
                max_block=max(longest if block_mode else 1, profile_steps),
                sampler=sampler)
        else:
            stepper = EagerTrainStep.from_store(cfg, pipeline, state, store,
                                                generator, check_finite=debug,
                                                sampler=sampler)
    else:
        steps_expected = total - start
        if profile_steps and start + 2 < total:
            steps_expected += profile_steps  # the profiled steps draw too
        if sharded:
            pmesh.warn_indivisible(cfg.nerf.train.num_random_rays, mesh.size)
        # On a mesh every rank draws the global batch and keeps its slice.
        batches = PrefetchedHostBatches(
            store, rays_per_iter, seed, dev, max(steps_expected, 0),
            rows=process_ray_slice(rays_per_iter) if sharded else None)
        stepper = EagerTrainStep(cfg, pipeline, state, batches.take,
                                 generator, after_dispatch=batches.prefetch,
                                 check_finite=debug)
    if verbose and start < total:
        said = [f"step mode: {step_mode}" + (
            " (one captured CUDA graph per step)" if step_mode == "graph"
            else "")]
        said.append(f"blocks of up to {longest} iterations with their "
                    f"scalars read once per block" if block_mode
                    else "one iteration at a time")
        if not use_device_store:
            said.append("rays sampled on the host one batch ahead")
        if mesh is not None:
            said.append(f"{rays_per_iter} rays per step over {mesh.size} "
                        f"rank(s) of axis {cfg.parallel.data_axis!r}, "
                        f"gradients all-reduced")
        print(", ".join(said), flush=True)

    def is_event(i, every):
        return i % every == 0 or i == total - 1

    def train_rate(iters_done):
        # rays/s since this run's start, first-step set-up included.
        return iters_done * rays_per_iter / (time.time() - t_start)

    def print_train(i, m, rate):
        if verbose:
            print(f"[TRAIN] iter {i} loss {m['loss']:.4f} "
                  f"psnr {m['psnr_fine']:.2f} lr {m['lr']:.2e} "
                  f"({rate:,.0f} rays/s)", flush=True)

    profiled = False

    def profiled_steps():
        """``profile_steps`` steps under the profiler (rank 0's only),
        their scalars dropped: the step counter moves on, the iteration
        does not."""
        nonlocal profiled
        profiled = True
        with trace(logdir, enable=primary) as prof:
            stepper.run(profile_steps)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return prof

    quiet = {} if verbose else {"verbose": False}

    def events_after(i):
        if is_event(i, exp.validate_every):
            _validate(cfg, i, state, renderer, val_ds, doc, da_rays,
                      **quiet)
        if i > 0 and is_event(i, exp.save_every):
            ckpt.save_train_checkpoint(logdir, pipeline, state, generator,
                                       max_to_keep=exp.max_keep_ckpts,
                                       mesh=mesh,
                                       image_generator=image_generator)

    prof = None
    doc = Documenter(logdir, primary=primary)
    try:
        t_start = time.time()
        if not block_mode:
            for i in range(start, total):
                if profile_steps and i == start + 2:  # past the set-up steps
                    prof = profiled_steps()
                row = stepper.run(1)[0]
                if is_event(i, exp.print_every):
                    m = dict(zip(stepper.names, row.tolist()))
                    rate = train_rate(i - start + 1)
                    m["rays_per_sec"] = rate
                    print_train(i, m, rate)
                    doc.write_train_iter(
                        i, m, extra_scalars={"train/rays_per_sec": rate})
                elif scalars_every >= 1 and i % scalars_every == 0:
                    # The host-sampling loop honours the density knob too,
                    # at the cost of a device read per write.
                    doc.write_train_iter(
                        i, dict(zip(stepper.names, row.tolist())))
                events_after(i)
        else:
            i = start
            while i < total:
                last = next_boundary(i, exp.print_every, exp.validate_every,
                                     exp.save_every, total)
                k = last - i + 1
                # One copy for the whole block, then per-iteration records.
                mh = stepper.run(k).cpu().numpy()
                if profile_steps and not profiled and i > start:
                    prof = profiled_steps()
                names = stepper.names
                rate = train_rate(last - start + 1)
                print_event = is_event(last, exp.print_every)
                for j in range(k):
                    it = i + j
                    # Print events always get a record (per-iteration
                    # loop parity), even when not divisible by
                    # train_scalars_every.
                    if (it % scalars_every == 0 or it == total - 1
                            or (it == last and print_event)):
                        rec = dict(zip(names, mh[j].tolist()))
                        if it == last:
                            rec["rays_per_sec"] = rate
                        doc.write_train_iter(
                            it, rec,
                            extra_scalars={"train/rays_per_sec": rate}
                            if it == last else None)
                if print_event:
                    print_train(last, dict(zip(names, mh[-1].tolist())), rate)
                events_after(last)
                i = last + 1
        if prof is not None and verbose:
            print(f"[profile] trace of {profile_steps} steps: "
                  f"{prof.trace_path}")
            print(summarize(prof, profile_steps), flush=True)
        if mesh is not None and step_mode == "graph" and verbose:
            print(f"[graph] each captured step holds {stepper.collectives} "
                  f"all-reduce(s) over the {mesh.size} rank(s)", flush=True)
    finally:
        doc.close()
    return state, logdir


def _validate(cfg: Config, i: int, state: TrainState,
              renderer: ImageRenderer, val_ds, doc: Documenter,
              da_rays=None, verbose: bool = True) -> None:
    """Whole-image validation: metrics, the NDC depth un-warp, for DDNeRF
    the dp loss and the μ/σ histograms, and the depth-analysis figures of
    ``da_rays`` (``load_depth_analysis_rays``'s tuple) when given
    (loop.py:350-403).  ``verbose=False`` keeps the ``[VAL]`` line back.
    On a mesh every rank renders its share of the image, and rank 0 alone
    goes on to the metrics, the figures and the records."""
    t_val = time.time()
    sched = schedule_values(cfg, state.step)
    pose, gt = val_ds.get_next_validation_pose()
    out = renderer.render_image_from_pose(
        pose, val_ds.H, val_ds.W, val_ds.focal, sched=sched)
    mesh = renderer.pipeline.mesh
    if mesh is not None and not mesh.primary:
        return
    vm = validation_metrics(cfg, out, gt)
    if cfg.dataset.ndc_rays:
        ro_reg, rd_reg, _ = val_ds.get_current_regular_validation_rays(
            fixed=cfg.dataset.fix_validation_unwarp_rays)
        for j in (0, 1):
            out[j]["depth"] = switch_t_ndc_to_regular(out[j]["depth"], ro_reg,
                                                      rd_reg)
    if cfg.is_ddnerf():
        w = out[0]["weights"].reshape(-1, out[0]["weights"].shape[-1])
        pdf = w / np.maximum(w.sum(-1, keepdims=True), 1e-12)
        mask = pdf > 0.1
        for key in ("mus", "sigmas", "smoothed_sigmas"):
            out[0][f"{key}_hist"] = out[0][key].reshape(-1,
                                                        pdf.shape[-1])[mask]
    doc.write_valid_iter(i, vm, out, gt, cfg.is_ddnerf())
    if da_rays is not None:
        da_origins, da_directions, da_radii, da_depth, _ = da_rays
        da_out = run_depth_analysis(cfg, renderer.pipeline, da_origins,
                                    da_directions, da_radii, sched)
        doc.write_depth_analysis_rays(i, da_out, da_depth, cfg.dataset.near,
                                      cfg.dataset.far)
    line = (f"[VAL] iter {i} loss {vm['loss']:.4f} "
            f"psnr {vm['psnr_fine']:.2f} time {time.time() - t_val:.1f}s")
    if "dp_loss" in vm:  # DDNeRF: appended to the JAX package's line
        line += f" dp_loss {vm['dp_loss']:.4f}"
    if verbose:
        print(line, flush=True)


def validation_metrics(cfg: Config, out, gt):
    """Whole-image validation losses (train_model.py:209-223; the JAX
    loop's ``_validation_metrics``); the dp loss only for DDNeRF."""
    gt = np.asarray(gt, np.float32)
    loss_coarse = float(np.mean((out[0]["rgb"] - gt) ** 2))
    loss_fine = float(np.mean((out[1]["rgb"] - gt) ** 2))
    coefs = cfg.train_params.loss_coeficients
    loss = coefs[0] * loss_coarse + coefs[1] * loss_fine
    m = {
        "loss_coarse": loss_coarse,
        "loss_fine": loss_fine,
        "psnr_coarse": -10.0 * np.log10(max(loss_coarse, 1e-5)),
        "psnr_fine": -10.0 * np.log10(max(loss_fine, 1e-5)),
    }
    if cfg.is_ddnerf():
        dp = float(out[1]["dp_loss"])
        loss += cfg.train_params.dp_coeficient * dp
        m["dp_loss"] = dp
    m["loss"] = loss
    return m
