"""The guard against JAX is the run's last look before its result: a
per-layer metric reader that loads a module named ``jax`` leaves the run
without a result and with a non-zero exit, though the reader runs after the
window.  Driven in a fresh process, past the look for a card, through a stub
cell whose driver does no work."""

import json
import shutil
import subprocess
import sys
import textwrap

import pytest

from portbench import harness

STUB_DRIVER = """
from portbench.harness import LayerRun


def run(ctx):
    return {"numbers": {"gap": 0.0}, "attempted": 1, "failed": 0,
            "end_to_end": {"setup_s": 1.0},
            "layer": LayerRun("train", 1, 1.0, 1.0, 1.0), "peak_bytes": 0}
"""

MAIN = """
import sys
from pathlib import Path
from portbench import harness, run
harness.require_cards = lambda count: None
harness.device_record = lambda count, peak: {{"platform": "gpu", "kind": "stub",
                                             "count": count, "memory_peak_bytes": peak}}
run.ROOT = Path({root!r})
sys.exit(run.main(["--workload", "stub.cell", "--seed", "3000000001",
                   "--seconds", "0", "--trace", "1"]))
"""


def _tree(tmp_path, reader_imports: str):
    root = tmp_path / "checkout"
    shutil.copytree(harness.PACKAGE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "stub.cell", "config": bench["configs"][0]["name"],
                               "traffic": "stub", "chips": 1, "why": "stub"})
    bench["per_layer"].append({"name": "standin.train", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "step",
                               "moves": "setup_s", "workloads": ["stub.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    pkg = root / "portbench"
    (pkg / "drivers" / "stub.py").write_text(STUB_DRIVER)
    (pkg / "traffic" / "stub.json").write_text(json.dumps({"driver": "stub"}))
    (pkg / "limits" / "stub.cell.json").write_text(json.dumps({"gap": 1.0}))
    (pkg / "metrics" / "standin.train.py").write_text(
        reader_imports + "\n\ndef read(run):\n    return 1.0\n")
    standin = tmp_path / "standin" / "jax"
    standin.mkdir(parents=True)
    (standin / "__init__.py").write_text('"""A stand-in for JAX."""\n')
    return root, tmp_path / "standin"


@pytest.mark.parametrize("reader_imports,prints_result", [
    ("", True),
    ("import jax  # noqa: F401", False),
])
def test_a_reader_that_loads_jax_leaves_no_result(tmp_path, reader_imports, prints_result):
    root, standin = _tree(tmp_path, reader_imports)
    env = {"PYTHONPATH": f"{harness.ROOT}:{standin}", "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(MAIN.format(root=str(root)))],
                          capture_output=True, text=True, timeout=300, env=env)
    lines = proc.stdout.strip().splitlines()
    if prints_result:
        assert proc.returncode == 0, proc.stderr[-3000:]
        result = json.loads(lines[-1])
        assert result["correct"] and result["metrics"]["standin.train"]["value"] == 1.0
    else:
        assert proc.returncode != 0
        assert not any(line.startswith("{") for line in lines), proc.stdout
        assert "['jax']" in proc.stderr, proc.stderr[-3000:]
