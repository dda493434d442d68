"""Data parallelism over ranks: the group, the accounting, the sharded
store sampler and the step's collectives.

Counterpart of ``ddnerf_tpu/parallel/mesh.py``.  A JAX process picks its
devices and lays a 1-D ``("data",)`` mesh over them; XLA then inserts the
gradient all-reduce from the sharding annotations.  A torch process drives
one device and is launched once per device (``torchrun --nproc_per_node
N``), so here the launcher fixes the count and the collectives are written
out:

* :class:`Mesh`, made by :func:`maybe_mesh` from torchrun's environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``PORT``,
  and ``TORCHELASTIC_RUN_ID``, by which a launch of one rank is known),
  holds the rank, the world size, this rank's device and the backend:
  NCCL where every rank has a card of its own (``--device cuda`` maps rank
  ``LOCAL_RANK`` to ``cuda:LOCAL_RANK``), gloo on the CPU and where the
  ranks share a card (``--device cuda:K`` is honoured on every rank).  A
  process that torchrun did not launch has no group and no mesh, and
  nothing changes.  torchrun with one rank forms a group of one: its
  collectives run (under NCCL, inside the captured step) and change no
  bit, and the data, the draws and the checkpoints are the single
  process's (:attr:`Mesh.sharded` is false).  ``parallel.num_devices``:
  0 = every rank launched, 1 = a single process, N = the world size must
  be N; a mismatch raises, never narrows;
* the train step's loss is the global batch's: each rank draws an equal
  share of the rays, the gradients and the step's scalar metrics are
  all-reduced in ONE flat buffer and divided by D (:meth:`Mesh.average`),
  and the dp loss's masked mean divides by the kept count all-reduced in
  the forward (:meth:`Mesh.masked_mean`, ``core/dd.py::estimate_dp_loss``),
  because a mean of per-rank masked means is not the global one;
* :class:`ShardedStoreSampler`: each rank draws ``ceil(R / D)`` rows from
  its own pixel block of the store (``parallel/distributed.py``), the
  pixel indices from a generator seeded from (seed, rank), and under
  ``dataset.single_image_mode`` every rank draws the same image from a
  generator seeded alike on all ranks and used for nothing else.

Whole-image renders shard each chunk's rays over the ranks and gather the
maps (``render/renderer.py``).  The group's collectives run on whatever
the backend takes: NCCL ones inside a captured step, gloo ones (which a
CUDA graph cannot hold) in the eager step only.
"""

from __future__ import annotations

import contextlib
import json
import os
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.kernels.fused_mlp import LAUNCHES


def launched_world() -> Dict[str, int]:
    """torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` (a run without
    torchrun: rank 0 of 1)."""
    env = os.environ
    return {"rank": int(env.get("RANK", "0")),
            "world": int(env.get("WORLD_SIZE", "1")),
            "local_rank": int(env.get("LOCAL_RANK", "0"))}


def check_num_devices(cfg: Config, world: int) -> None:
    """``parallel.num_devices`` against the launched world size."""
    n = cfg.parallel.num_devices
    if n < 0:
        raise ValueError(f"parallel.num_devices={n}: expected 0 (every "
                         "rank launched), 1 or the world size")
    if n == 1 and world > 1:
        raise ValueError(
            f"parallel.num_devices: 1 asks for a single process, but "
            f"{world} ranks were launched (torchrun --nproc_per_node "
            f"{world}): launch one process, or set parallel.num_devices 0")
    if n > 1 and n != world:
        raise ValueError(
            f"parallel.num_devices: {n}, but the world size is {world}: "
            f"launch {n} ranks (torchrun --nproc_per_node {n} ...), or set "
            f"parallel.num_devices 0 to take every rank launched")


def rank_device(name: str, local_rank: int) -> torch.device:
    """This rank's device: ``cuda`` is card ``LOCAL_RANK``, which must
    exist; ``cuda:K`` and ``cpu`` are taken as given."""
    device = torch.device(name)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but "
                           "torch.cuda.is_available() is False")
    index = local_rank if device.index is None else device.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"rank with LOCAL_RANK {local_rank} asks for cuda:{index}, but "
            f"this machine has {torch.cuda.device_count()} card(s): launch "
            f"at most that many ranks per node, or name one card "
            f"(--device cuda:0) for all of them to share")
    return torch.device("cuda", index)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s own generator, from (seed, rank)."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


@dataclass
class Mesh:
    """One rank's view of the data-parallel group: the counterpart of a
    1-D ``jax.sharding.Mesh`` of ``size`` devices.
    ``collectives`` counts the collectives issued, and, under CUDA-graph
    capture, recorded.  ``global_dp_count=False`` drops the dp loss's
    count all-reduce (each rank then takes its own masked mean): a fault
    to show that the tests see it, never a mode."""

    rank: int
    size: int
    local_rank: int
    device: torch.device
    backend: str
    global_dp_count: bool = True
    collectives: int = 0

    @property
    def primary(self) -> bool:
        """The one rank that prints and writes."""
        return self.rank == 0

    @property
    def sharded(self) -> bool:
        """More than one rank: the rays, the store and the renders are
        split, each rank has its own generator, and a checkpoint holds every
        rank's state.  A group of one keeps the single process's."""
        return self.size > 1

    def describe(self) -> str:
        if self.backend == "nccl":
            where = f"{self.device} on rank {self.rank}, one card per rank"
        else:
            where = f"{self.device} shared" if self.device.type == "cuda" \
                else str(self.device)
        ranks = f"{self.size} rank{'s' if self.size > 1 else ''}"
        return f"{ranks}, backend {self.backend}, {where}"

    # --------------------------------------------------------- collectives

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place."""
        dist.all_reduce(t)
        self.collectives += 1
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) -> ``[size, *t.shape]``."""
        t = t.contiguous()
        out = torch.empty((self.size, *t.shape), dtype=t.dtype,
                          device=t.device)
        dist.all_gather(list(out.unbind(0)), t)
        self.collectives += 1
        return out

    def gather_objects(self, obj) -> List:
        """Every rank's picklable ``obj``, in rank order, on every rank."""
        out: List = [None] * self.size
        dist.all_gather_object(out, obj)
        self.collectives += 1
        return out

    def masked_mean(self, total: torch.Tensor,
                    count: torch.Tensor) -> torch.Tensor:
        """This rank's part of a mean over the kept rays of the global
        batch (the dp loss, ``core/dd.py::estimate_dp_loss``): its masked
        sum ``total`` times D over the kept ``count`` summed over the
        ranks, so that the mean of the ranks' values, and of their
        gradients, is the global masked mean."""
        if not self.global_dp_count:
            return total / torch.clamp(count, min=1)
        return total * self.size / torch.clamp(self.all_reduce(count), min=1)

    def average(self, params: List[torch.nn.Parameter],
                metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Mean over the ranks of every parameter's ``.grad`` and of the
        step's 0-d ``metrics``, in ONE all-reduce of one flat buffer.  The
        gradients come back as views of that buffer (``.grad`` is
        reassigned); the metrics are returned."""
        grads = [p.grad.reshape(-1) for p in params]
        values = torch.stack([v.float() for v in metrics.values()])
        flat = self.all_reduce(torch.cat(grads + [values])).div_(self.size)
        parts = flat.split([g.numel() for g in grads] + [len(metrics)])
        for p, g in zip(params, parts):
            p.grad = g.view_as(p)
        return dict(zip(metrics, parts[-1].unbind(0)))


def launched_by_torchrun() -> bool:
    """More than one rank, or torchrun's own launch of one."""
    return (launched_world()["world"] > 1
            or "TORCHELASTIC_RUN_ID" in os.environ)


def init_group(device: str = "cuda") -> Optional[Mesh]:
    """Form the group that torchrun launched, or take the one this process
    formed before -> this rank's :class:`Mesh` (None for a process
    torchrun did not launch: no group).  Rank 0 prints the group in the
    run's first line when it forms it.  A group that fails to form raises;
    nothing switches backend."""
    if not launched_by_torchrun():
        return None
    w = launched_world()
    dev = rank_device(device, w["local_rank"])
    # NCCL needs a card per rank; ranks that share one (or the CPU) take
    # gloo, which also runs collectives on CUDA tensors.
    own_card = dev.type == "cuda" and torch.device(device).index is None
    backend = "nccl" if own_card else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    formed = not dist.is_initialized()
    if formed:
        dist.init_process_group(
            backend, init_method="env://", rank=w["rank"],
            world_size=w["world"],
            **({"device_id": dev} if backend == "nccl" else {}))
    elif (dist.get_world_size() != w["world"]
          or dist.get_backend() != backend):
        raise RuntimeError(
            f"a process group of {dist.get_world_size()} ranks on "
            f"{dist.get_backend()} exists; this run needs {w['world']} on "
            f"{backend}")
    mesh = Mesh(rank=w["rank"], size=w["world"], local_rank=w["local_rank"],
                device=dev, backend=backend)
    if formed and mesh.primary:
        print(mesh.describe(), flush=True)
    return mesh


def destroy_group() -> None:
    """Leave the group :func:`init_group` formed (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def launched(device: str = "cuda"):
    """The CLIs' scope: the group torchrun launched (or None), destroyed at
    the end."""
    try:
        yield init_group(device)
    finally:
        destroy_group()


def launch_report(mesh: Optional[Mesh]) -> Optional[str]:
    """The CLIs' closing lines: which kernels the run went through
    (``kernels/fused_mlp.py::LAUNCHES``; 0 = the plain versions ran), as
    ``kernel launches: {...}`` and, on a group of several ranks, ``kernel
    launches per rank: [...]``.  Every rank calls it (the counts are
    gathered); rank 0 gets the text, the others None."""
    said = "kernel launches: " + json.dumps(LAUNCHES, sort_keys=True)
    if mesh is None:
        return said
    per_rank = mesh.gather_objects(dict(LAUNCHES))
    if not mesh.primary:
        return None
    if mesh.sharded:
        said += "\nkernel launches per rank: " + json.dumps(per_rank,
                                                            sort_keys=True)
    return said


def maybe_mesh(cfg: Config, device: str = "cuda") -> Optional[Mesh]:
    """The mesh every driver (train / eval / video) runs on: None for a
    single process that torchrun did not launch, else this rank's
    :class:`Mesh` (the group is formed here if no CLI formed it).
    ``parallel.num_devices`` must agree with the world size
    (:func:`check_num_devices`)."""
    check_num_devices(cfg, launched_world()["world"])
    return init_group(device)


# ------------------------------------------------------------- accounting

def _effective_batch(num_rays: int, n_dev: int) -> int:
    """The sharded sampler's rounding rule: the per-rank draw is
    ceil-rounded, so the effective batch is ``ceil(num_rays / D) * D``."""
    return -(-num_rays // n_dev) * n_dev


def effective_train_rays(cfg: Config, mesh: Optional[Mesh]) -> int:
    """Rays drawn per step over all ranks; the rays/s line and the records
    count these, not the configured number."""
    if mesh is None or not mesh.sharded:
        return cfg.nerf.train.num_random_rays
    return _effective_batch(cfg.nerf.train.num_random_rays, mesh.size)


def warn_indivisible(num_rays: int, n_dev: int) -> int:
    """The per-rank draw; warns when ``num_rays`` does not divide."""
    per_dev = _effective_batch(num_rays, n_dev) // n_dev
    if per_dev * n_dev != num_rays:
        warnings.warn(
            f"num_random_rays={num_rays} does not divide the {n_dev}-rank "
            f"mesh; the effective batch is {per_dev * n_dev} rays per step "
            "(loss means, gradient scale, and rays/s accounting use the "
            "effective size)", stacklevel=3)
    return per_dev


# ------------------------------------------------------- the store sampler

class ShardedStoreSampler:
    """Per-rank batch draws from this rank's pixel block ``store``
    (``[n_img, n_pix_padded / D, 10]``, :func:`~ddnerf_tpu_torch.parallel.
    distributed.build_sharded_store`): ``draw()`` -> this rank's
    ``ceil(num_rays / D)`` rows as ``{origins, directions, radii, rgb}``,
    with no collective.  ``generator`` (seeded from (seed, rank)) draws the
    pixel indices and then the step's jitter and density noise;
    ``image_generator`` (single-image mode only; seeded alike on every
    rank) draws the image index alone, so that all ranks take the same
    image at every step.  ``generators`` lists both, for a CUDA graph to
    register and for a checkpoint to hold."""

    def __init__(self, mesh: Mesh, store: torch.Tensor, num_rays: int,
                 single_image_mode: bool, seed: int):
        self.store = store
        self.per_rank = warn_indivisible(num_rays, mesh.size)
        self.effective_num_rays = self.per_rank * mesh.size
        dev = store.device
        self.generator = torch.Generator(device=dev).manual_seed(
            rank_seed(seed, mesh.rank))
        self.image_generator = (torch.Generator(device=dev).manual_seed(seed)
                                if single_image_mode else None)

    @property
    def generators(self) -> List[torch.Generator]:
        return [g for g in (self.generator, self.image_generator)
                if g is not None]

    def draw(self) -> Dict[str, torch.Tensor]:
        store, dev = self.store, self.store.device
        n_img, n_pix, _ = store.shape
        flat_store = store.reshape(n_img * n_pix, -1)
        if self.image_generator is not None:
            img = torch.randint(0, n_img, (), generator=self.image_generator,
                                device=dev)
            idx = torch.randint(0, n_pix, (self.per_rank,),
                                generator=self.generator, device=dev)
            rows = flat_store[img * n_pix + idx]
        else:
            flat = torch.randint(0, n_img * n_pix, (self.per_rank,),
                                 generator=self.generator, device=dev)
            rows = flat_store[flat]
        return {"origins": rows[:, 0:3], "directions": rows[:, 3:6],
                "radii": rows[:, 6:7], "rgb": rows[:, 7:10]}
