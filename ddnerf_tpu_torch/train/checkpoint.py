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
draws the rays, the jitter and the density noise.  Orbax checkpoints of the
JAX package are not read here (the port imports no orbax).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch

from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.utils.weights import save_checkpoint

CHECKPOINT_NAME = "checkpoint.ckpt"
OPTIMIZER_KEY = "optimizer_state_dict"
GENERATOR_KEY = "generator_state"
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
                          max_to_keep: int = 1) -> str:
    """Save the run at ``state.step`` (the number of updates applied, as
    the JAX package saves): the networks, the optimizer's state dict under
    ``optimizer_state_dict`` and ``generator``'s state under
    ``generator_state``, as ``checkpoint_{step}.ckpt``; then drop all but
    the newest ``max_to_keep`` step files.  The optimizer's state is written
    in one layout whether the plain or the ``capturable`` optimizer ran
    (``TrainState.optimizer_state_dict``).  Returns the file's path."""
    path = step_path(logdir, state.step)
    save_checkpoint(path, pipeline.coarse, pipeline.fine, step=state.step,
                    extra={OPTIMIZER_KEY: state.optimizer_state_dict(),
                           GENERATOR_KEY: generator.get_state()})
    for old in all_steps(logdir)[:-max(1, int(max_to_keep))]:
        os.remove(step_path(logdir, old))
    return path


def load_train_checkpoint(path: str, pipeline, state,
                          generator: torch.Generator) -> int:
    """Restore a run saved by :func:`save_train_checkpoint` into
    ``pipeline`` (networks), ``state`` (Adam moments and ``step``) and
    ``generator``, all in place: a step captured into a CUDA graph goes
    on from the loaded run without a new capture.  A file without the
    optimizer's or the generator's state (a reference checkpoint made for
    evaluation) cannot resume training: ``ValueError``.  Returns the
    restored step."""
    ckpt: Dict[str, Any] = torch.load(path, map_location="cpu",
                                      weights_only=True)
    missing = [k for k in (OPTIMIZER_KEY, GENERATOR_KEY) if k not in ckpt]
    if missing:
        raise ValueError(f"{path!r} holds no {' / '.join(missing)}: it can "
                         "be evaluated, not resumed")
    pipeline.load_state_dicts(ckpt["model_1_state_dict"],
                              ckpt.get("model_2_state_dict"))
    state.load_optimizer_state_dict(ckpt[OPTIMIZER_KEY], int(ckpt["iter"]))
    generator.set_state(ckpt[GENERATOR_KEY])
    return state.step
