"""The training cells: ``train/step.py::CapturedTrainStep.run(k)`` driven in
blocks of the config's ``experiment.print_every`` iterations, one read-back
of the block's metric rows each, as ``train/loop.py::train`` drives it
between its events (validation and checkpoints are left out).

Set-up makes the ray store and the weights from the seed on the card,
builds the pipeline, the optimizer state and the step at the traffic's
first iteration, and takes the first ``JUDGED`` steps through ``run``:
the captured step's eager warm-up iterations, the capture and its first
replays.  Their losses, the gradient Adam got at the first step and at
the first replayed step (from its moments) and the parameters after
them are what the plain reference is held to, once the window has
closed.  Then one block warms the replays up and the window runs blocks
until ``--seconds`` have passed; ``train_rays_per_s`` is the rays of all
its steps over its wall time, ending in the last block's read-back.  A
traced run then profiles ``traced_steps`` more steps.
"""

from __future__ import annotations

import copy
import gc
import time

import torch
from torch.profiler import record_function

from portbench import compare, counts, scene, tracing
from portbench import harness
from portbench.harness import LayerRun
from portbench.reference import nerf as reference

JUDGED = 6


def block_of(cfg_dict: dict) -> int:
    """Iterations between two read-backs: the config's ``print_every``, as
    ``train/loop.py::train`` reads the metrics back."""
    return cfg_dict["experiment"]["print_every"]


def program_config(config_file: dict, traffic: dict) -> dict:
    """The configuration dict as the cell runs it: the traffic sets the
    rays of a step."""
    cfg = copy.deepcopy(config_file["config"])
    cfg["nerf"]["train"]["num_random_rays"] = traffic["rays_per_step"]
    return cfg


class Program:
    """The system under test at the cell's sizes, from the seed."""

    def __init__(self, cfg_dict: dict, scene_spec: dict, traffic: dict,
                 seed: int, device, clock=None):
        stage = clock.stage if clock is not None else (lambda name: None)
        from ddnerf_tpu_torch.config import Config
        from ddnerf_tpu_torch.models.nerf import NerfPipeline
        from ddnerf_tpu_torch.train.state import TrainState
        from ddnerf_tpu_torch.train.step import CapturedTrainStep, EagerTrainStep

        stage("imports")
        device = torch.device(device)
        harness.start_device(device, stage)
        self.store = scene.make_store(scene_spec, seed, device)
        stage("store")
        self.cfg = Config.from_dict(cfg_dict).resolved()
        self.weights = scene.make_weights(cfg_dict, seed, device)
        stage("weights")
        self.pipeline = NerfPipeline(self.cfg, device, seed=0)
        self.pipeline.load_state_dicts(*self.weights.values())
        stage("pipeline")
        self.state = TrainState(self.cfg, self.pipeline)
        self.state.step = traffic["first_iteration"]
        self.seed = seed
        gen = torch.Generator(device=device).manual_seed(scene.sub_seed(seed, "steps"))
        if device.type == "cuda":
            self.step = CapturedTrainStep(self.cfg, self.pipeline, self.state, self.store,
                                          gen, max_block=block_of(cfg_dict))
        else:  # the tests' CPU run: the same step, eager
            self.step = EagerTrainStep.from_store(self.cfg, self.pipeline,
                                                  self.state, self.store, gen)
        self.names = [f"{net}.{leaf}" for net, leaves in self.weights.items()
                      for leaf in leaves]
        stage("optimizer and step")

    def _loss_column(self) -> int:
        return self.step.names.index("loss")

    def _moments(self):
        """Adam's first moments, zero where it holds none (no step yet)."""
        opt = self.state.optimizer
        return [opt.state[p]["exp_avg"].detach().clone() if p in opt.state
                else torch.zeros_like(p) for p in self.pipeline.parameters()]

    def first_steps(self) -> compare.Readings:
        """The judged steps: 1 (eager), 2-3, 4 (the first replay on a
        card), 5-6 -> the readings they are judged by."""
        losses = []

        def run(k):
            rows = self.step.run(k).cpu()
            losses.extend(rows[:, self._loss_column()].tolist())

        run(1)
        m1 = self._moments()
        run(2)
        m3 = self._moments()
        run(1)
        m4 = self._moments()
        run(JUDGED - 4)
        g1 = {n: m / (1 - compare.ADAM_B1) for n, m in zip(self.names, m1)}
        g4 = {n: (b - compare.ADAM_B1 * a) / (1 - compare.ADAM_B1)
              for n, a, b in zip(self.names, m3, m4)}
        last = {n: p.detach().clone() for n, p in
                zip(self.names, self.pipeline.parameters())}
        first = {f"{net}.{leaf}": v for net, leaves in self.weights.items()
                 for leaf, v in leaves.items()}
        return compare.train_readings(losses, g1, g4, last, first)

    def window(self, seconds: float, block: int):
        """Blocks of ``block`` replays until ``seconds`` have passed ->
        (steps, wall seconds, steps whose loss is not finite)."""
        col = self._loss_column()
        steps = failed = 0
        t0 = time.perf_counter()
        while True:
            with record_function("portbench.replay_block"):
                rows = self.step.run(block)
            with record_function("portbench.read_back"):
                host = rows.cpu()
            steps += block
            failed += int((~torch.isfinite(host[:, col])).sum())
            wall = time.perf_counter() - t0
            if wall >= seconds:
                return steps, wall, failed

    def traced(self, steps: int):
        """``steps`` more steps under the profiler, as one block and its
        read-back -> the stretch's digest."""
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with record_function(tracing.STRETCH):
                with record_function("portbench.replay_block"):
                    rows = self.step.run(steps)
                with record_function("portbench.read_back"):
                    rows.cpu()
                torch.cuda.synchronize()
        return tracing.digest(*tracing.from_profile(prof))


def reference_readings(cfg_dict: dict, traffic: dict, weights, store, seed: int,
                       quant) -> compare.Readings:
    """The plain reference over the judged steps, on the same store and
    weights, its draws from a generator seeded as the program's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    setup = reference.Setup(cfg_dict)
    gen = torch.Generator(device=store.device).manual_seed(scene.sub_seed(seed, "steps"))
    out = reference.follow_training(setup, weights, store, gen,
                                    traffic["first_iteration"], JUDGED, quant)
    first = {f"{net}.{leaf}": v for net, leaves in weights.items()
             for leaf, v in leaves.items()}
    return compare.train_readings(out["losses"], out["grads"][0], out["grads"][3],
                                  out["params"], first)


def step_work(cfg_dict: dict, traffic: dict):
    """(MLP operations, least ms of its kernels) of one step."""
    specs = scene.net_specs(cfg_dict)
    nets = [(h, d) for _, h, d in specs]
    if len(nets) == 1:
        nets = nets * 2  # mip-NeRF's shared net in both cycles
    t = cfg_dict["nerf"]["train"]
    return counts.train_step_work(nets, traffic["rays_per_step"],
                                  (t["num_coarse"], t["num_fine"]))


def run(ctx) -> dict:
    cfg_dict = program_config(ctx.config, ctx.traffic)
    traffic = ctx.traffic
    prog = Program(cfg_dict, ctx.config["scene"], traffic, ctx.seed, ctx.device, ctx.clock)
    judged = prog.first_steps()
    ctx.clock.stage("capture and judged steps")
    block = block_of(cfg_dict)
    prog.window(0.0, block)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    ctx.clock.stage("warm-up")
    harness.settle()
    setup_s = ctx.clock.total()
    steps, wall, failed = prog.window(ctx.seconds, block)
    digest = prog.traced(traffic["traced_steps"]) if ctx.trace else None
    peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
    weights, store = prog.weights, prog.store
    del prog
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(cfg_dict, traffic, weights, store, ctx.seed,
                             reference.QUANTS[cfg_dict["parallel"]["compute_dtype"]])
    flop, bound_ms = step_work(cfg_dict, traffic)
    return {
        "numbers": compare.train_numbers(judged, ref),
        "attempted": steps,
        "failed": failed,
        "end_to_end": {"train_rays_per_s": steps * traffic["rays_per_step"] / wall,
                       "setup_s": setup_s},
        "layer": LayerRun("train", steps, wall, flop, bound_ms, digest,
                          traffic["traced_steps"]),
        "peak_bytes": peak,
    }
