"""The harness finds everything by name, so a cell, a configuration, a
traffic mix and a per-layer metric are added as files alone; and
``BENCHMARK.json`` keeps to the form the benchmark's contract gives."""

import json
import math
import re
import shutil
import statistics

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_a_cell_config_traffic_and_metric_added_as_files(tmp_path):
    shutil.copytree(harness.PACKAGE, tmp_path / "portbench")
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    pkg = tmp_path / "portbench"
    cfg = json.loads((pkg / "configs" / "mip_blender.json").read_text())
    (pkg / "configs" / "mip_wide.json").write_text(json.dumps(cfg))
    traffic = json.loads((pkg / "traffic" / "train.json").read_text())
    (pkg / "traffic" / "train_1024.json").write_text(json.dumps(dict(traffic, rays_per_step=1024)))
    (pkg / "limits" / "mip_wide.train_1024.json").write_text(
        (pkg / "limits" / "mip_blender.train.json").read_text())
    (pkg / "metrics" / "rays_per_item.train.py").write_text(
        "def read(run):\n    return None if run.kind != 'train' else 42.0\n")
    bench["configs"].append(dict(bench["configs"][1], name="mip_wide",
                                 file="portbench/configs/mip_wide.json"))
    bench["workloads"].append({"name": "mip_wide.train_1024", "config": "mip_wide",
                               "traffic": "train_1024", "chips": 1, "why": "added"})
    bench["end_to_end"][0]["workloads"].append("mip_wide.train_1024")
    for m in bench["per_layer"]:
        if m["name"] in ("step_mfu.train", "mlp_roofline.train"):
            m["workloads"].append("mip_wide.train_1024")
    bench["per_layer"].append({"name": "rays_per_item.train", "unit": "rays",
                               "better": "higher", "source": "program_counter",
                               "layer": "step", "moves": "train_rays_per_s",
                               "workloads": ["mip_wide.train_1024"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    reg = harness.Registry(tmp_path)
    cell = reg.cell("mip_wide.train_1024")
    assert reg.config(cell["config"])["config"]["nerf"]["type"] == "GeneralMipNerfModel"
    assert reg.traffic(cell["traffic"])["rays_per_step"] == 1024
    assert hasattr(reg.driver(reg.traffic(cell["traffic"])["driver"]), "run")
    assert reg.limits(cell["name"])
    e2e = [m["name"] for m in reg.metrics(cell["name"], "end_to_end")]
    assert e2e == ["train_rays_per_s", "setup_s"]
    run = harness.LayerRun("train", 10, 1.0, 1e9, 1.0)
    got = harness.read_layer_metrics(reg, cell["name"], run)
    assert got["rays_per_item.train"] == {"value": 42.0, "unit": "rays"}
    # no trace in the run: the trace readers find nothing and are left out
    assert "mlp_roofline.train" not in got and "step_mfu.train" in got
    assert "rays_per_item.train" not in harness.read_layer_metrics(
        reg, "mip_blender.train", run)


def test_each_cell_reports_what_the_contract_asks():
    reg = harness.Registry()
    bench = reg.bench
    for w in bench["workloads"]:
        e2e = [m["name"] for m in reg.metrics(w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert reg.metrics(w["name"], "per_layer"), w["name"]
        assert reg.limits(w["name"])
        traffic = reg.traffic(w["traffic"])
        assert (reg.package / "drivers" / f"{traffic['driver']}.py").is_file()
        assert w["chips"] == 1


def test_benchmark_json_keeps_to_the_contract():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (harness.ROOT / c["file"]).is_file()
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert json.loads((harness.ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert w["name"] not in names
        names.add(w["name"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    metric_names = set()
    for section, keys in (("end_to_end", {"name", "unit", "better", "bound", "source"}),
                          ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for m in bench[section]:
            assert set(m) - {"workloads"} == keys, m["name"]
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["name"] not in metric_names
            metric_names.add(m["name"])
            if section == "end_to_end":
                assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
            else:
                assert (harness.PACKAGE / "metrics" / f"{m['name']}.py").is_file()
                moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
                for cell in m.get("workloads", names):
                    assert cell in moved.get("workloads", names)
    # the whole check of 24 cells at this length fits its time
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("values,spread", [([1.0, 2.0, 3.0, 4.0], 2.5 / 2.5)])
def test_spread_is_the_quartile_distance_over_the_median(values, spread):
    q = statistics.quantiles(values, n=4)
    assert math.isclose((q[2] - q[0]) / statistics.median(values), spread)
