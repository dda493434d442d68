"""On a machine with the card: each cell runs through ``run.py`` briefly
and comes out correct, with a result line of the contract's keys; the
traced form carries the per-layer metrics and the breakdown.  Without a
card these skip (decided inside each test)."""

import json
import subprocess
import sys

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.Registry().bench["workloads"]]


def _run(cell, trace, seed=2_718_281_828):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run(
        [sys.executable, str(harness.PACKAGE / "run.py"), "--workload", cell,
         "--seed", str(seed), "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_correct_on_the_card(cell):
    result = _run(cell, 0)
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    wanted = {m["name"] for m in harness.Registry().metrics(cell, "end_to_end")}
    assert set(result["metrics"]) == wanted


@pytest.mark.cuda
def test_a_traced_run_reads_the_layers():
    result = _run("dd_blender.train", 1)
    assert result["correct"]
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert result["breakdown"]["device_ops"] and result["breakdown"]["idle_gaps"]
    wanted = {m["name"] for m in harness.Registry().metrics("dd_blender.train", "per_layer")}
    assert set(result["metrics"]) == wanted
    assert 0 < result["metrics"]["mlp_roofline.train"]["value"] <= 100
