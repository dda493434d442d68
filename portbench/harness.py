"""What every cell shares: finding a cell's configuration, traffic mix,
driver and metric readers by the names in ``BENCHMARK.json``, the set-up
clock, the device record, the guard against JAX in the process, and the
result line.

A cell is ``BENCHMARK.json``'s workload entry; its ``config`` names
``portbench/configs/<config>.json``, its ``traffic`` names
``portbench/traffic/<traffic>.json``, whose ``driver`` names
``portbench/drivers/<driver>.py``; each per-layer metric is read by
``portbench/metrics/<name>.py``.  Adding any of them is adding a file.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
# Top-level module names the benchmark's process may not hold (the JAX
# stack and the JAX package the port was made from), compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ddnerf_tpu")


class Registry:
    """The benchmark's files under ``root`` (a checkout)."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.package = self.root / "portbench"
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; there are "
                         f"{[w['name'] for w in self.bench['workloads']]}")

    def config(self, name: str) -> dict:
        return json.loads((self.package / "configs" / f"{name}.json").read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.package / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.package / "limits" / f"{cell}.json").read_text())

    def driver(self, name: str) -> ModuleType:
        return _load(self.package / "drivers" / f"{name}.py", f"portbench_driver_{name}")

    def reader(self, metric: str) -> ModuleType:
        return _load(self.package / "metrics" / f"{metric}.py",
                     "portbench_metric_" + metric.replace(".", "_"))

    def metrics(self, cell: str, section: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics ``cell`` reports:
        those without a ``workloads`` list and those whose list names it."""
        return [m for m in self.bench[section]
                if "workloads" not in m or cell in m["workloads"]]


def _load(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise SystemExit(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class SetupClock:
    """Set-up time from the process's start, by stage: each stage is
    printed to standard error as it ends."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.last = t0
        self.stages: Dict[str, float] = {}

    def stage(self, name: str) -> None:
        now = time.perf_counter()
        self.stages[name] = now - self.last
        self.last = now
        print(f"[setup] {name} {self.stages[name]:.3f} s (total "
              f"{now - self.t0:.3f} s)", file=sys.stderr, flush=True)

    def total(self) -> float:
        return time.perf_counter() - self.t0


def settle() -> None:
    """The end of set-up: collect what set-up left and freeze the survivors
    out of the collector's later passes, so that a full collection in the
    window walks only what the window makes."""
    gc.collect()
    gc.freeze()


def start_device(device, stage) -> None:
    """On a card: the CUDA context, then the program's kernel library
    (built into the checkout's ``kernels/_build/`` only by its first run),
    each a set-up stage."""
    if device.type != "cuda":
        return
    import torch

    torch.cuda.init()
    torch.empty(1, device=device)
    stage("cuda context")
    from ddnerf_tpu_torch.kernels import build

    build.load_library()
    stage("kernel library")


def forbidden_modules() -> List[str]:
    """The entries of ``sys.modules`` whose top-level name is forbidden."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def require_cards(count: int) -> None:
    """Exit without a result unless ``count`` CUDA cards are visible."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA device (torch.cuda.is_available() "
                         "is false); a cell runs on the card or not at all")
    if torch.cuda.device_count() < count:
        raise SystemExit(f"portbench: the cell needs {count} cards, "
                         f"{torch.cuda.device_count()} are visible")


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unread"
    except (OSError, subprocess.SubprocessError):
        return "unread"


def device_record(count: int, peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def check(name: str, value: float, limit: float) -> dict:
    """One compared number: passes when finite and at most ``limit``."""
    return {"name": name, "value": value, "limit": limit,
            "ok": math.isfinite(value) and value <= limit}


def judge(out: dict, limits: dict):
    """A driver's output against the cell's limits -> (each compared number
    beside its limit, ``correct``): every number within its limit, some
    work attempted and none of it failed."""
    checks = [check(name, value, limits[name]) for name, value in out["numbers"].items()]
    correct = (all(c["ok"] for c in checks) and out["failed"] == 0
               and out["attempted"] > 0)
    return checks, correct


def emit(result: dict, checks: List[dict]) -> None:
    """The run's last lines: each compared number beside its limit on
    standard error, then the result line on standard output, with the
    compared numbers under ``checks``, its last key."""
    result = dict(result)
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    sys.stdout.flush()
    for c in checks:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


@dataclass
class LayerRun:
    """What a cell's run hands its per-layer metric readers: the work of
    the window (``items`` steps or frames in ``window_s`` on the host's
    clock), the MLP operations and the kernels' least time of one item,
    from the shapes, and the traced stretch's digest over
    ``traced_items`` items (None in an untraced run)."""

    kind: str  # "train" or "render"
    items: int
    window_s: float
    flop_per_item: float
    bound_ms_per_item: float
    trace: Optional[object] = None
    traced_items: int = 0


def read_layer_metrics(registry: Registry, cell: str, run) -> Dict[str, dict]:
    """Each per-layer metric of ``cell`` that its reader finds in ``run``
    (a reader that finds nothing returns None and the metric is left
    out)."""
    out = {}
    for m in registry.metrics(cell, "per_layer"):
        value: Optional[float] = registry.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = metric(value, m["unit"])
    return out
