"""Run one cell of the port's benchmark once, on the card of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is a workload of ``BENCHMARK.json``; its configuration, traffic
mix, driver and metric readers are files under ``portbench/`` found by
name (``portbench/harness.py``).  With ``--trace 0`` the result carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(read from a profiled stretch after the window) and the trace's
``busy_s`` / ``window_s`` and ``breakdown``.  The last line of standard
output is the result as one JSON object; each number compared with the
plain reference is printed beside its limit on the last lines of
standard error and under the result's last key, ``checks``.

Without a CUDA card, with fewer cards than the cell asks for, or with
JAX or the JAX package in the process once the window has closed, the
run exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# Caches inside the checkout, at fixed paths: the kernel library builds
# into ddnerf_tpu_torch/kernels/_build/ by itself; Triton, if anything
# loads it, caches here.  A library that could pull JAX in is told not to.
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "portbench" / ".cache" / "triton")
os.environ.setdefault("USE_FLAX", "0")
# One process with few threads: the host's work is the main thread's.
os.environ.setdefault("OMP_NUM_THREADS", "1")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import harness

    registry = harness.Registry(ROOT)
    cell = registry.cell(args.workload)
    harness.require_cards(cell["chips"])
    import torch

    config = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    limits = registry.limits(cell["name"])
    clock = harness.SetupClock(T0)
    ctx = SimpleNamespace(registry=registry, cell=cell, config=config, traffic=traffic,
                  seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  clock=clock, device=torch.device("cuda", 0))
    out = registry.driver(traffic["driver"]).run(ctx)

    power = harness.power_limit()
    checks, correct = harness.judge(out, limits)
    device = harness.device_record(cell["chips"], out["peak_bytes"])
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    if args.trace:
        layer = out["layer"]
        metrics = harness.read_layer_metrics(registry, cell["name"], layer)
        if layer.trace is not None:
            device["busy_s"] = layer.trace.busy_s
            device["window_s"] = layer.trace.window_s
            result["breakdown"] = {
                "device_ops": [[n, s] for n, s in layer.trace.top_ops],
                "idle_gaps": [[n, s] for n, s in layer.trace.idle_gaps]}
    else:
        metrics = {m["name"]: harness.metric(out["end_to_end"][m["name"]], m["unit"])
                   for m in registry.metrics(cell["name"], "end_to_end")}
    print(f"[device] {power}; stages {clock.stages}", file=sys.stderr)
    result["metrics"] = metrics
    result["device"] = device
    # The last look before the result: whatever the run loaded, the metric
    # readers included, is in the process by now.
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process holds {found}, which the port may not "
              f"load; no result", file=sys.stderr)
        return 3
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
