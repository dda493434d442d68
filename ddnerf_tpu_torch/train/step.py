"""The train step: schedules, forward (coarse→fine), loss assembly
(Σ coefⱼ·MSE, and + dp_coef·dp_loss for DDNeRF), backward and the Adam
update.

Counterpart of ``ddnerf_tpu/train/step.py`` (reference
train_model.py:132-177).  Two forms of the same step:

* eager, :func:`train_step` / :func:`train_step_from_store`: a plain
  function, what the CPU and the host-sampling loop run;
* captured, :class:`CapturedTrainStep`: the whole step from the ray draw to
  the Adam update recorded once into a ``torch.cuda.CUDAGraph`` and replayed
  per iteration, the counterpart of ``jax.jit(make_train_step_from_store)``;
  a run of ``k`` replays that stack their metrics in a device buffer is the
  counterpart of ``make_stacked_train_step_from_store``'s ``lax.scan`` block.

Both are driven through one interface, ``run(k) -> [k, n_metrics]`` on the
device with the metric names in ``names`` (:class:`EagerTrainStep` wraps the
eager form), so the loop reads a block's scalars in one copy.

On a data-parallel group (``pipeline.mesh``, ``parallel/mesh.py``) each rank
runs the same step on its share of the rays; the gradients and the scalar
metrics are averaged over the ranks in one all-reduce after the backward,
and the dp loss divides by the global kept count.  NCCL's collectives are
captured with the rest of the step; gloo's cannot be, so a gloo group runs
the eager step.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.core import schedules
from ddnerf_tpu_torch.core.math import img2mse, mse2psnr
from ddnerf_tpu_torch.data.datasets import sample_rays_on_device
from ddnerf_tpu_torch.kernels import fused_mlp
from ddnerf_tpu_torch.models.nerf import NerfPipeline, RayBatch, ScheduleValues
from ddnerf_tpu_torch.train.state import TrainState
from ddnerf_tpu_torch.utils.debug import assert_finite_tree

Batch = Dict[str, torch.Tensor]  # origins, directions, radii, rgb


def schedule_values(cfg: Config, step: int) -> ScheduleValues:
    return ScheduleValues(
        gaussian_smooth_factor=schedules.gaussian_smooth_factor(step, cfg),
        pdf_padding=schedules.pdf_padding(step, cfg),
    )


def compute_loss(cfg: Config, pipeline: NerfPipeline, rays: RayBatch,
                 target: torch.Tensor, sched: ScheduleValues,
                 generator: Optional[torch.Generator] = None,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss assembly mirroring train_model.py:156-167; the dp loss and the
    μ/σ regularizer metrics only for DDNeRF (``ddnerf_tpu/train/step.py:
    66-73``).  PSNR is not taken here: under microbatching it comes from
    the aggregated MSEs."""
    out = pipeline.render_rays(rays, sched, "train", generator)
    loss_coarse = img2mse(out[0]["rgb"], target)
    loss_fine = img2mse(out[1]["rgb"], target)
    coefs = cfg.train_params.loss_coeficients
    loss = coefs[0] * loss_coarse + coefs[1] * loss_fine
    metrics = {"loss_coarse": loss_coarse, "loss_fine": loss_fine}
    if cfg.is_ddnerf():
        dp_loss = out[1]["dp_loss"]
        loss = loss + cfg.train_params.dp_coeficient * dp_loss
        metrics["dp_loss"] = dp_loss
        for key in ("mus_loss", "sig_loss", "mus_reg", "sig_reg"):
            metrics[key] = out[0][key]
    metrics["loss"] = loss
    return loss, metrics


def _microbatches(cfg: Config, num_rays: int) -> int:
    """Equal chunks the step's gradients accumulate over (1: none)."""
    mb = cfg.parallel.microbatch_rays
    return num_rays // mb if mb and num_rays > mb and num_rays % mb == 0 else 1


def _gradients(cfg: Config, pipeline: NerfPipeline, batch: Batch,
               sched: ScheduleValues, generator: Optional[torch.Generator],
               ) -> Dict[str, torch.Tensor]:
    """Forward and backward on ``batch``: leaves the gradients in the
    parameters' ``.grad`` (accumulated over equal chunks of
    ``parallel.microbatch_rays`` rays when it divides the batch: the mean
    of the chunk means, ``step.py:125-140``) and returns the detached
    scalar metrics with the PSNRs."""
    near, far = cfg.dataset.near, cfg.dataset.far
    params = pipeline.parameters()
    mesh = pipeline.mesh
    for p in params:
        p.grad = None

    def accumulate(part: Batch) -> Dict[str, torch.Tensor]:
        rays = RayBatch.create(part["origins"], part["directions"],
                               part["radii"], near, far)
        loss, m = compute_loss(cfg, pipeline, rays, part["rgb"], sched,
                               generator)
        loss.backward()  # .grad accumulates over chunks
        return {key: v.detach() for key, v in m.items()}

    num_rays = batch["origins"].shape[0]
    k = _microbatches(cfg, num_rays)
    if k > 1:
        mb = num_rays // k
        sums: Dict[str, torch.Tensor] = {}
        for j in range(k):
            part = {key: v[j * mb:(j + 1) * mb] for key, v in batch.items()}
            for key, v in accumulate(part).items():
                sums[key] = sums[key] + v if key in sums else v
        with torch.no_grad():
            for p in params:
                p.grad /= k
        metrics = {key: v / k for key, v in sums.items()}
    else:
        metrics = accumulate(batch)
    if mesh is not None:  # the global batch's gradients and metrics
        metrics = mesh.average(params, metrics)
    metrics["psnr_coarse"] = mse2psnr(metrics["loss_coarse"])
    metrics["psnr_fine"] = mse2psnr(metrics["loss_fine"])
    return metrics


def _named_leaves(pipeline: NerfPipeline, grad: bool):
    names = ("coarse",) if pipeline.shared_net else ("coarse", "fine")
    return {name: {n: (p.grad if grad else p.detach())
                   for n, p in net.named_parameters()}
            for name, net in zip(names, pipeline.networks())}


def train_step(cfg: Config, pipeline: NerfPipeline, state: TrainState,
               batch: Batch, generator: Optional[torch.Generator] = None,
               check_finite: bool = False) -> Dict[str, torch.Tensor]:
    """One step on ``batch``: gradients, then the Adam update at
    ``lr(state.step)``.  Returns detached scalar metrics on the device,
    the rate among them.  ``check_finite`` (``--debug-nans``) reads the
    parameters before the step and the loss and every gradient after the
    backward, and raises naming the first leaf that is not finite."""
    if check_finite:
        assert_finite_tree(_named_leaves(pipeline, grad=False),
                           f"the parameters before step {state.step}")
    sched = schedule_values(cfg, state.step)
    metrics = _gradients(cfg, pipeline, batch, sched, generator)
    if check_finite:
        assert_finite_tree({"loss": metrics["loss"],
                            "grad": _named_leaves(pipeline, grad=True)},
                           f"step {state.step}")
    state.apply_gradients()
    metrics["lr"] = state.lr.clone()
    return metrics


def _draw_batch(cfg: Config, store: torch.Tensor,
                generator: torch.Generator) -> Batch:
    ro, rd, radii, rgb = sample_rays_on_device(
        store, generator, cfg.nerf.train.num_random_rays,
        cfg.dataset.single_image_mode)
    return {"origins": ro, "directions": rd, "radii": radii, "rgb": rgb}


def train_step_from_store(cfg: Config, pipeline: NerfPipeline,
                          state: TrainState, store: torch.Tensor,
                          generator: torch.Generator,
                          check_finite: bool = False,
                          ) -> Dict[str, torch.Tensor]:
    """:func:`train_step` on a batch drawn from the device-resident ray
    store ``[n_img, n_pix, 10]`` (step.py:156-172); ``generator`` draws the
    rays, then the jitter and the density noise."""
    return train_step(cfg, pipeline, state, _draw_batch(cfg, store, generator),
                      generator, check_finite)


def _row(metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.stack([v.float() for v in metrics.values()])


class EagerTrainStep:
    """The eager step behind the block interface: ``run(k)`` takes ``k``
    steps and returns their metrics stacked ``[k, n_metrics]`` on the
    device, in the order of ``names``, without a host read.  ``take``
    gives each step's batch; ``after_dispatch``, when given, runs right
    after a step was dispatched (the host-sampling loop's prefetch)."""

    mode = "eager"

    def __init__(self, cfg: Config, pipeline: NerfPipeline, state: TrainState,
                 take: Callable[[], Batch],
                 generator: Optional[torch.Generator],
                 after_dispatch: Optional[Callable[[], None]] = None,
                 check_finite: bool = False):
        self.cfg, self.pipeline, self.state = cfg, pipeline, state
        self.take, self.after_dispatch = take, after_dispatch
        self.generator, self.check_finite = generator, check_finite
        self.names: List[str] = []

    @classmethod
    def from_store(cls, cfg: Config, pipeline: NerfPipeline,
                   state: TrainState, store: torch.Tensor,
                   generator: torch.Generator, check_finite: bool = False,
                   sampler=None):
        """Batches drawn from the device-resident ``store``, or by
        ``sampler`` (a rank's :class:`~ddnerf_tpu_torch.parallel.mesh.
        ShardedStoreSampler`) when given."""
        take = (sampler.draw if sampler is not None
                else lambda: _draw_batch(cfg, store, generator))
        return cls(cfg, pipeline, state, take, generator,
                   check_finite=check_finite)

    def run(self, k: int) -> torch.Tensor:
        rows = []
        for _ in range(k):
            metrics = train_step(self.cfg, self.pipeline, self.state,
                                 self.take(), self.generator,
                                 self.check_finite)
            if self.after_dispatch is not None:
                self.after_dispatch()
            self.names = list(metrics)
            rows.append(_row(metrics))
        return torch.stack(rows)


class CapturedTrainStep:
    """:func:`train_step_from_store` as a CUDA graph: one graph holds a
    whole step (the ray draw from the resident store, both cycles' forward,
    the loss, the backward, the Adam update and the write of the step's
    metrics into row ``row`` of a device buffer), and an iteration is one
    replay.

    What a replay cannot take from Python it reads from device memory that
    the host fills before a run of replays: the learning rate and the
    ``gaussian_smooth_factor`` of each step from ``table[row]`` (the values
    the host schedules compute, in their float32 arithmetic), and ``row``
    itself, which the graph advances.  ``pdf_padding`` is a Python branch of
    the resampler that flips once in a run: there is one graph per value,
    captured when first needed.  The graphs share the parameters, Adam's
    state (``capturable``, so its step counts are on the device) and the
    generator, which is registered with each graph so that every replay
    advances it as the eager step does; each graph owns the ``.grad``
    tensors its backward writes.  Under ``parallel.microbatch_rays`` one
    graph holds the whole accumulating step: one draw, then the ``k``
    chunks' forwards and backwards (the first chunk's backward makes the
    graph's ``.grad``, the later ones add into it; the weight pack is made
    once, by the first chunk, and shared), ``/= k`` and the update.  A
    chunk's activations go back to the graph's pool when its backward is
    done, and the next chunk's are made there, so the step's peak memory
    is a chunk's, as in the eager step.

    The first ``WARMUP`` iterations run eagerly on a side stream, as
    capturing asks, and are iterations like any other: a captured run of N
    iterations and an eager one see the same sequence, bit for bit.  There
    is no fallback: a capture that fails raises.

    ``run(k)`` (``k <= max_block``) returns the first ``k`` rows of the
    buffer, valid until the next ``run``.

    ``sampler`` (a rank's :class:`~ddnerf_tpu_torch.parallel.mesh.
    ShardedStoreSampler`, whose ``store`` and ``generator`` are then the
    ones passed) draws the batch in place of the whole-store draw, and each
    of its generators is registered.  On a data-parallel group the step's
    all-reduces are recorded too (``collectives`` counts those of one
    replay); the communicator exists by then, because the warm-up
    iterations ran them.  A gloo group's collectives cannot be captured:
    such a step raises.
    """

    mode = "graph"
    WARMUP = 3

    def __init__(self, cfg: Config, pipeline: NerfPipeline, state: TrainState,
                 store: torch.Tensor, generator: torch.Generator,
                 max_block: int = 1, sampler=None):
        mesh = pipeline.mesh
        if mesh is not None and mesh.backend != "nccl":
            raise ValueError(
                f"a captured step cannot hold the collectives of a "
                f"{mesh.backend} group ({mesh.describe()}): run it with "
                f"--step-mode eager (step_mode='eager')")
        if store.device.type != "cuda" or generator.device.type != "cuda":
            raise ValueError(
                f"a captured step needs the store and the generator on a "
                f"CUDA device; got {store.device} and {generator.device}")
        self.cfg, self.pipeline, self.state = cfg, pipeline, state
        self.store, self.generator = store, generator
        if sampler is not None:
            self._draw, self._generators = sampler.draw, sampler.generators
        else:
            self._draw = lambda: _draw_batch(cfg, store, generator)
            self._generators = [generator]
        self.collectives = 0
        self.max_block = int(max_block)
        dev = store.device
        self.names: List[str] = []
        self.row = torch.zeros(1, dtype=torch.int64, device=dev)
        self.table = torch.zeros((self.max_block, 2), dtype=torch.float32,
                                 device=dev)
        self.buffer: Optional[torch.Tensor] = None  # made at the first step
        self.warmup_left = self.WARMUP
        self._side = torch.cuda.Stream(dev)
        self._graphs: Dict[bool, Tuple[torch.cuda.CUDAGraph,
                                       Dict[str, int]]] = {}

    # ------------------------------------------------------------ pieces

    def _eager(self, j: int) -> None:
        """A warm-up iteration, on the side stream, into buffer row ``j``."""
        main = torch.cuda.current_stream(self.store.device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            metrics = train_step(self.cfg, self.pipeline, self.state,
                                 self._draw(), self.generator)
            if self.buffer is None:
                self.names = list(metrics)
                self.buffer = torch.zeros(
                    (self.max_block, len(metrics)), dtype=torch.float32,
                    device=self.store.device)
            self.buffer[j] = _row(metrics)
        main.wait_stream(self._side)
        self.warmup_left -= 1

    def _capture(self, pdf_padding: bool):
        """Record one step with this ``pdf_padding`` -> (graph, the fused
        kernels' launch nodes it holds, by name)."""
        cfg, pipeline, state = self.cfg, self.pipeline, self.state
        nets = pipeline.networks()
        graph = torch.cuda.CUDAGraph()
        for gen in self._generators:
            graph.register_generator_state(gen)
        before = dict(fused_mlp.CAPTURED)
        mesh = pipeline.mesh
        collectives = mesh.collectives if mesh is not None else 0
        for net in nets:  # so that the pack is made inside the graph
            fused_mlp.forget_packed(net)
        with torch.cuda.graph(graph):
            lr, smooth = self.table.index_select(0, self.row)[0].unbind(0)
            state.lr.copy_(lr)
            sched = ScheduleValues(gaussian_smooth_factor=smooth,
                                   pdf_padding=pdf_padding)
            metrics = _gradients(cfg, pipeline, self._draw(), sched,
                                 self.generator)
            state.optimizer.step()
            metrics["lr"] = state.lr
            if list(metrics) != self.names:
                raise RuntimeError(f"the captured step's metrics "
                                   f"{list(metrics)} are not {self.names}")
            self.buffer.index_copy_(0, self.row, _row(metrics)[None])
            self.row.add_(1)
        for net in nets:  # that pack is the graph's, and is stale outside
            fused_mlp.forget_packed(net)
        if mesh is not None:
            self.collectives = mesh.collectives - collectives
        nodes = {name: n - before[name]
                 for name, n in fused_mlp.CAPTURED.items() if n != before[name]}
        return graph, nodes

    # --------------------------------------------------------------- run

    def run(self, k: int) -> torch.Tensor:
        if not 0 < k <= self.max_block:
            raise ValueError(f"a block of {k} iterations; this step was "
                             f"made for 1..{self.max_block}")
        state = self.state
        j = 0
        while j < k and self.warmup_left > 0:
            self._eager(j)
            j += 1
        if j == k:
            return self.buffer[:k]
        first = state.step
        steps = range(first, first + k - j)
        values = np.zeros((self.max_block, 2), np.float32)
        values[j:k, 0] = [state.schedule(s) for s in steps]
        values[j:k, 1] = [schedules.gaussian_smooth_factor(s, self.cfg)
                          for s in steps]
        self.table.copy_(torch.from_numpy(values))
        self.row.fill_(j)
        for s in steps:
            pad = schedules.pdf_padding(s, self.cfg)
            if pad not in self._graphs:
                self._graphs[pad] = self._capture(pad)
            graph, nodes = self._graphs[pad]
            graph.replay()
            state.step += 1
            for name, n in nodes.items():
                fused_mlp.LAUNCHES[name] += n
        # The replays moved the parameters where no version counter saw it.
        for net in self.pipeline.networks():
            fused_mlp.forget_packed(net)
        return self.buffer[:k]
