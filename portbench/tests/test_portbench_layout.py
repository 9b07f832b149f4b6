"""The harness finds a cell, a configuration, a traffic mix, limits and a
per-layer metric that exist only as new files and entries; the result line
holds exactly the contract's keys, the compared numbers last; no card, no
result."""

import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, tiny
from portbench import run, spec


def test_new_cell_config_traffic_and_metric_as_files_only(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    (pb / "configs" / "new_cfg.json").write_text(json.dumps({"points": 4096, "icp": {}}))
    (pb / "traffic" / "new_mix.json").write_text(json.dumps({"entry": "register"}))
    (pb / "limits" / "new_cfg.json").write_text(json.dumps({"t_gap_mm": 1.0}))
    (pb / "metrics" / "new_metric.py").write_text("def read(window):\n    return 7.0\n")
    bench["configs"].append({"name": "new_cfg", "source": "x", "reduced": [],
                             "file": "portbench/configs/new_cfg.json", "why": "x"})
    bench["workloads"].append({"name": "new.cell", "config": "new_cfg",
                               "traffic": "new_mix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new_metric", "unit": "%", "better": "lower",
                               "source": "device_trace", "layer": "Device",
                               "moves": "pairs_per_s", "workloads": ["new.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("new.cell", root=tmp_path)
    assert cell["config"]["points"] == 4096
    assert cell["traffic"]["entry"] == "register"
    assert cell["limits"] == {"t_gap_mm": 1.0}
    assert [m["name"] for m in cell["per_layer"]] == ["new_metric"]
    assert "latency_p95_ms" not in [m["name"] for m in cell["end_to_end"]]
    assert spec.metric_reader("new_metric", root=tmp_path)(None) == 7.0
    with pytest.raises(KeyError):
        spec.cell("no.such.cell", root=tmp_path)


def test_every_listed_metric_has_a_reader_and_every_cell_its_files():
    bench = spec.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell["per_layer"] and cell["end_to_end"]


def test_result_line_holds_exactly_the_contracts_keys():
    cell = tiny(spec.cell("kinect.stream"), 1024, 16, pool=2)
    out = run.run_cell(cell, 3, 0.0, False, "cpu")
    line = json.loads(run.result_line(out))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["metrics"]) == {"pairs_per_s", "latency_p95_ms", "ms_per_iteration",
                                    "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "kinect.stream",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                               "HOME": str(ROOT / "build")})
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert proc.returncode != 0
    assert proc.stdout == ""
