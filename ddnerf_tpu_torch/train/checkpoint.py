"""Config snapshot and checkpoints of a run's logdir.

Counterpart of ``ddnerf_tpu/train/checkpoint.py``: the config snapshot
(``config.yml``, the source of truth for eval) and the retained
checkpoints.  Each save writes one reference-format file
(:mod:`ddnerf_tpu_torch.utils.weights`), ``checkpoint_{step}.ckpt``, and
the newest ``experiment.max_keep_ckpts`` of them are kept; a reader that
names no step gets the newest, or ``checkpoint.ckpt`` (the name the
reference wrote) in a logdir that holds no step file.  Beside the networks
and ``iter`` a file holds what a resumed run needs to continue as if it
had never stopped: the Adam state and the state of the generator that
draws the rays, the jitter and the density noise.  A run on a
data-parallel group of several ranks (``parallel/mesh.py``) saves from rank
0 alone, with every rank's generator state (gathered) and the world size;
it resumes only at that world size.  A single process (or a group of one)
writes the layout it always wrote.  Orbax checkpoints of the JAX package
are not read here (the port imports no orbax): ``scripts/orbax_to_ckpt.py``
converts one into this layout where JAX is installed.  A JAX run's random
key has no counterpart among the generator's states, so a converted file
carries :data:`GENERATOR_SEED_KEY` in place of ``generator_state``, and the
run it resumes draws from a generator seeded anew (:func:`converted_seed`).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.utils.weights import save_checkpoint

CHECKPOINT_NAME = "checkpoint.ckpt"
OPTIMIZER_KEY = "optimizer_state_dict"
GENERATOR_KEY = "generator_state"
# Written by a data-parallel run only.
GENERATORS_KEY = "generator_states"  # every rank's, in rank order
IMAGE_GENERATOR_KEY = "image_generator_state"  # single-image mode's
WORLD_KEY = "world_size"
# Written instead of GENERATOR_KEY by a conversion from a JAX run: why the
# file holds no generator state.
GENERATOR_SEED_KEY = "generator_seeded_on_resume"
_STEP_FILE = re.compile(r"^checkpoint_(\d+)\.ckpt$")


def save_config_snapshot(cfg: Config, logdir: str) -> None:
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "config.yml"), "w") as f:
        f.write(cfg.dump())


def load_config_snapshot(logdir: str) -> Config:
    """``logdir/config.yml`` (written at train start), resolved."""
    return Config.from_yaml(os.path.join(logdir, "config.yml")).resolved()


def step_path(logdir: str, step: int) -> str:
    return os.path.join(logdir, f"checkpoint_{int(step)}.ckpt")


def all_steps(logdir: str) -> List[int]:
    """The steps of the retained ``checkpoint_{step}.ckpt`` files, sorted."""
    if not os.path.isdir(logdir):
        return []
    found = (_STEP_FILE.match(name) for name in os.listdir(logdir))
    return sorted(int(m.group(1)) for m in found if m)


def latest_step(logdir: str) -> Optional[int]:
    steps = all_steps(logdir)
    return steps[-1] if steps else None


def checkpoint_path(logdir: str, step: Optional[int] = None) -> str:
    """The file of a retained ``step``; when ``step`` is None the newest
    step file, or a reference-made ``checkpoint.ckpt`` where there is no
    step file.  ``FileNotFoundError`` names the steps there are
    (``ddnerf_tpu/train/checkpoint.py:70-87``)."""
    if step is None:
        step = latest_step(logdir)
    if step is None:
        path = os.path.join(logdir, CHECKPOINT_NAME)
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"no checkpoint_{{step}}.ckpt and no {CHECKPOINT_NAME} under "
                f"{logdir!r}")
        return path
    path = step_path(logdir, step)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"checkpoint step {step} not under {logdir!r}; available: "
            f"{all_steps(logdir)}")
    return path


def save_train_checkpoint(logdir: str, pipeline, state,
                          generator: torch.Generator,
                          max_to_keep: int = 1, mesh=None,
                          image_generator: Optional[torch.Generator] = None,
                          ) -> str:
    """Save the run at ``state.step`` (the number of updates applied, as
    the JAX package saves): the networks, the optimizer's state dict under
    ``optimizer_state_dict`` and ``generator``'s state under
    ``generator_state``, as ``checkpoint_{step}.ckpt``; then drop all but
    the newest ``max_to_keep`` step files.  The optimizer's state is written
    in one layout whether the plain or the ``capturable`` optimizer ran
    (``TrainState.optimizer_state_dict``).  Returns the file's path.

    On a ``mesh`` every rank calls this: the generators' states are
    gathered (``generator``: each rank's own; ``image_generator``: the one
    the ranks share, if any) and rank 0 writes the file."""
    path = step_path(logdir, state.step)
    gen_state = generator.get_state()
    ranks = {}
    if mesh is not None and mesh.sharded:
        ranks[GENERATORS_KEY] = mesh.gather_objects(gen_state)
        ranks[WORLD_KEY] = mesh.size
        if image_generator is not None:
            ranks[IMAGE_GENERATOR_KEY] = image_generator.get_state()
        if not mesh.primary:
            return path
    save_checkpoint(path, pipeline.coarse, pipeline.fine, step=state.step,
                    extra={OPTIMIZER_KEY: state.optimizer_state_dict(),
                           GENERATOR_KEY: gen_state, **ranks})
    for old in all_steps(logdir)[:-max(1, int(max_to_keep))]:
        os.remove(step_path(logdir, old))
    return path


def converted_seed(randomseed: int, step: int) -> int:
    """The seed of the generator a converted run resumes with: a function
    of ``experiment.randomseed`` and the step, so that two resumes of one
    file draw the same rays."""
    words = np.random.SeedSequence([int(randomseed), int(step)])
    return int(words.generate_state(1, np.uint64)[0]) >> 1


def load_train_checkpoint(path: str, pipeline, state,
                          generator: torch.Generator, mesh=None,
                          image_generator: Optional[torch.Generator] = None,
                          ) -> int:
    """Restore a run saved by :func:`save_train_checkpoint` into
    ``pipeline`` (networks), ``state`` (Adam moments and ``step``) and
    ``generator``, all in place: a step captured into a CUDA graph goes
    on from the loaded run without a new capture.  A file converted from a
    JAX run (:data:`GENERATOR_SEED_KEY` instead of a generator state) seeds
    ``generator`` with :func:`converted_seed` of the pipeline's
    ``experiment.randomseed`` and the step, and says so; it holds no world
    size, so it resumes in a single process (or a group of one) only.  A
    file without the optimizer's state, or without both the generator's
    state and that marker (a reference checkpoint made for evaluation),
    cannot resume training: ``ValueError``.  So does a file written at another world size
    than this run's (``mesh``: every rank loads the same file and takes its
    own generator state).  Returns the restored step."""
    ckpt: Dict[str, Any] = torch.load(path, map_location="cpu",
                                      weights_only=True)
    seeded = GENERATOR_KEY not in ckpt and GENERATOR_SEED_KEY in ckpt
    needed = (OPTIMIZER_KEY,) if seeded else (OPTIMIZER_KEY, GENERATOR_KEY)
    missing = [k for k in needed if k not in ckpt]
    if missing:
        raise ValueError(f"{path!r} holds no {' / '.join(missing)}: it can "
                         "be evaluated, not resumed")
    written, here = int(ckpt.get(WORLD_KEY, 1)), 1 if mesh is None else mesh.size
    if written != here:
        raise ValueError(
            f"{path!r} was written by a run of world size {written}; this "
            f"run has world size {here}: resume it with {written} rank(s), "
            "each rank's generator state is its own")
    pipeline.load_state_dicts(ckpt["model_1_state_dict"],
                              ckpt.get("model_2_state_dict"))
    state.load_optimizer_state_dict(ckpt[OPTIMIZER_KEY], int(ckpt["iter"]))
    if seeded:
        seed = converted_seed(pipeline.cfg.experiment.randomseed, state.step)
        generator.manual_seed(seed)
        print(f"{path!r} holds no generator state "
              f"({ckpt[GENERATOR_SEED_KEY]}): the generator is seeded "
              f"with {seed}, from experiment.randomseed "
              f"{pipeline.cfg.experiment.randomseed} and step "
              f"{state.step}", flush=True)
    elif here == 1:
        generator.set_state(ckpt[GENERATOR_KEY])
    else:
        generator.set_state(ckpt[GENERATORS_KEY][mesh.rank])
        if image_generator is not None:
            image_generator.set_state(ckpt[IMAGE_GENERATOR_KEY])
    return state.step
