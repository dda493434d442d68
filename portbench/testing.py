"""Tiny versions of the cells for the CPU tests: the same configurations and
traffic with 64-wide networks, 16 + 16 samples, 256 rays, blocks of two
steps and two small views, run through the same drivers (the program's
plain paths stand in for its kernels on the CPU)."""

from __future__ import annotations

import copy
import time

from portbench import harness

HIDDEN, SAMPLES, RAYS, BLOCK, SIDE = 64, 16, 256, 2, 16


class TinyClock(harness.SetupClock):
    def stage(self, name: str) -> None:
        self.stages[name] = 0.0


def tiny_config(registry: harness.Registry, name: str) -> dict:
    cf = copy.deepcopy(registry.config(name))
    nerf = cf["config"]["nerf"]
    nerf["coarse_hidden_size"] = nerf["fine_hidden_size"] = HIDDEN
    for mode in ("train", "validation"):
        nerf[mode].update(num_coarse=SAMPLES, num_fine=SAMPLES, chunksize=100)
    cf["config"]["experiment"]["print_every"] = BLOCK
    cf["scene"].update(views=2, height=SIDE, width=SIDE)
    return cf


def tiny_context(cell: str, seed: int = 12345678901, seconds: float = 0.0):
    """A run's context for ``cell`` at the tiny sizes, on the CPU."""
    from types import SimpleNamespace

    import torch

    registry = harness.Registry()
    w = registry.cell(cell)
    traffic = dict(registry.traffic(w["traffic"]))
    if traffic["driver"] == "train":
        traffic.update(rays_per_step=RAYS)
    else:
        traffic.update(orbit_frames=8)
    return SimpleNamespace(registry=registry, cell=w, config=tiny_config(registry, w["config"]),
                           traffic=traffic, seed=seed, seconds=seconds, trace=False,
                           clock=TinyClock(time.perf_counter()),
                           device=torch.device("cpu"))


def judge(ctx, out) -> bool:
    """``correct`` as ``run.py`` decides it, against the cell's limits."""
    return harness.judge(out, ctx.registry.limits(ctx.cell["name"]))[1]
