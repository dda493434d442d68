"""Read the numbers that ``correct`` compares, over many seeds in one
process, on the card at a cell's own sizes: the program's (a training
cell's judged steps; a render cell's judged frames, no window), the
control's (the plain reference at the precision below the configuration's,
float8 e4m3 for bfloat16, in the program's place) and, with ``--fault``,
the program's with a planted fault (``portbench/faults.py``).  The
limits in ``portbench/limits/<cell>.json`` are set from these readings.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3
        [--control-seeds 4,5,6] [--fault NAME --fault-seeds 7,8,9]

One JSON line a reading on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s.strip()]


def _free():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default="")
    p.add_argument("--fault-seeds", default="")
    args = p.parse_args(argv)

    from portbench import compare, faults, harness, scene
    from portbench.reference import nerf as reference

    registry = harness.Registry(ROOT)
    cell = registry.cell(args.workload)
    harness.require_cards(cell["chips"])
    import torch

    config, traffic = registry.config(cell["config"]), registry.traffic(cell["traffic"])
    driver = registry.driver(traffic["driver"])
    dev = torch.device("cuda", 0)
    cdt = config["config"]["parallel"]["compute_dtype"]
    runs = [("program", s) for s in _seeds(args.seeds)]
    runs += [("control", s) for s in _seeds(args.control_seeds)]
    runs += [(f"fault:{args.fault}", s) for s in _seeds(args.fault_seeds)]
    for kind, seed in runs:
        t0 = time.perf_counter()
        fault = (getattr(faults, kind.split(":", 1)[1])() if kind.startswith("fault:")
                 else contextlib.nullcontext())
        if traffic["driver"] == "train":
            cfg = driver.program_config(config, traffic)
            if kind == "control":
                store = scene.make_store(config["scene"], seed, dev)
                weights = scene.make_weights(cfg, seed, dev)
                got = driver.reference_readings(cfg, traffic, weights, store, seed,
                                                reference.fp8)
            else:
                with fault:
                    prog = driver.Program(cfg, config["scene"], traffic, seed, dev)
                    got = prog.first_steps()
                weights, store = prog.weights, prog.store
                del prog
                _free()
            ref = driver.reference_readings(cfg, traffic, weights, store, seed,
                                            reference.QUANTS[cdt])
            numbers = compare.train_numbers(got, ref)
            numbers["worst"] = compare.train_worst(got, ref)
            del store
        else:
            cfg = config["config"]
            sc = config["scene"]
            h, w, focal = sc["height"], sc["width"], scene.focal_of(sc)
            orbit = scene.orbit_poses(traffic["orbit_frames"], traffic["elevation_deg"],
                                      traffic["orbit_radius"])
            picks = driver.judged_frames(seed, len(orbit), traffic["judged_frames"])
            poses = [orbit[i] for i in picks]
            if kind == "control":
                weights = scene.make_weights(cfg, seed, dev)
                got = driver.reference_frames(cfg, weights, poses, h, w, focal,
                                              reference.fp8, dev)
            else:
                with fault:
                    prog = driver.Program(cfg, seed, dev)
                    got = [prog.frame(pose, h, w, focal) for pose in poses]
                weights = prog.weights
                del prog
                _free()
            ref = driver.reference_frames(cfg, weights, poses, h, w, focal,
                                          reference.QUANTS[cdt], dev)
            numbers = compare.frame_numbers(got, ref)
        _free()
        print(json.dumps({"cell": cell["name"], "kind": kind, "seed": seed,
                          "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process holds {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
