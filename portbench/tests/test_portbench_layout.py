"""The harness finds a cell, a configuration (with any of the port's
settings), a traffic mix, limits, an entry point, a plain reference and a
per-layer metric that exist only as new files and entries; an ``icp`` key
that sets none of the port's settings fails at ``spec.cell``; the result line
holds exactly the contract's keys, the compared numbers last; no card, no
result."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, tiny
from portbench import check, drive, run, spec


STUB_ENTRY = """
import torch

from icp_tpu_torch.runtime import timing
from portbench import drive


class Entry(drive.Entry):
    def call(self, n):
        timing.count("stub.calls")
        row = [0, 0, 0, 1, float(self.cfg.robust.value == "huber"), 0, 0, 1, 1]
        return torch.tensor([row] * self.traffic["batch"], dtype=torch.float64)
"""
STUB_REFERENCE = """
import torch


def run(frames, pair, icp, run_to, cache, tf32=False):
    cache[pair] = icp["gicp_epsilon"]
    q = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64)
    t = torch.tensor([0.25 if icp["plane_symmetric"] else 9.0, 0.0, 0.0],
                     dtype=torch.float64)
    return {"k": 1, "poses": [(q, t, 1.0)] * max(run_to, 1)}
"""
STUB_METRIC = "def read(window):\n    return float(window.counters['stub.calls'])\n"


def test_new_cell_config_traffic_and_metric_as_files_only(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    (pb / "configs" / "new_cfg.json").write_text(json.dumps({"points": 4096, "icp": {}}))
    (pb / "traffic" / "new_mix.json").write_text(json.dumps({"entry": "register"}))
    (pb / "limits" / "new_cfg.json").write_text(json.dumps({"t_gap_mm": 1.0}))
    (pb / "metrics" / "new_metric.py").write_text("def read(window):\n    return 7.0\n")
    # A GICP configuration with a robust kernel and symmetric normals, its
    # own reference, a mix through its own entry and a counter's metric.
    gicp = json.loads((pb / "configs" / "kinect_rgbd_16384x256.json").read_text())
    gicp.update(points=1024, reference="stub")
    gicp["icp"] = {"n_r": 16, "objective": "gicp", "robust": "huber", "plane_symmetric": True,
                   "gicp_epsilon": 0.002, "max_iterations": 8, "weighted": False}
    (pb / "configs" / "gicp_cfg.json").write_text(json.dumps(gicp))
    (pb / "traffic" / "stub_mix.json").write_text(json.dumps(
        {"entry": "stub", "pool_frames": 4, "batch": 2, "trace_pairs": 4, "check_sample": 1}))
    (pb / "limits" / "gicp_cfg.json").write_text(json.dumps({"t_gap_mm": 0.5}))
    (pb / "entries" / "stub.py").write_text(STUB_ENTRY)
    (pb / "reference" / "stub.py").write_text(STUB_REFERENCE)
    (pb / "metrics" / "stub_calls.py").write_text(STUB_METRIC)
    bench["configs"] += [{"name": "new_cfg", "source": "x", "reduced": [],
                          "file": "portbench/configs/new_cfg.json", "why": "x"},
                         {"name": "gicp_cfg", "source": "x", "reduced": [],
                          "file": "portbench/configs/gicp_cfg.json", "why": "x"}]
    bench["workloads"] += [{"name": "new.cell", "config": "new_cfg",
                            "traffic": "new_mix", "chips": 1, "why": "x"},
                           {"name": "gicp.cell", "config": "gicp_cfg",
                            "traffic": "stub_mix", "chips": 1, "why": "x"}]
    bench["per_layer"] += [{"name": "new_metric", "unit": "%", "better": "lower",
                            "source": "device_trace", "layer": "Device",
                            "moves": "pairs_per_s", "workloads": ["new.cell"]},
                           {"name": "stub_calls", "unit": "calls", "better": "lower",
                            "source": "program_counter", "layer": "Entry",
                            "moves": "pairs_per_s", "workloads": ["gicp.cell"]}]
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

    cell = spec.cell("gicp.cell", root=tmp_path)
    system = drive.System(cell["config"], cell["traffic"],
                          torch.zeros(4, 1024, 8), root=cell["root"])
    assert type(system).__module__ == "portbench.entries.stub"
    assert (system.cfg.objective.value, system.cfg.robust.value) == ("gicp", "huber")
    assert system.cfg.plane_symmetric and system.cfg.weighting.value == "regular"
    assert system.params.gicp_epsilon == 0.002 and system.params.alpha == 1e2  # a default
    window, _ = drive.run_window(system, 0.0)
    assert window.counters["stub.calls"] == len(window.calls) == 1
    assert window.rows[0][0] == (0, 1) and window.rows[0][1][4] == 1.0
    assert spec.metric_reader("stub_calls", root=tmp_path)(window) == 1.0
    assert check.compare(None, window, cell["config"], 5, 1, root=tmp_path) == {
        "t_gap_mm": 0.75, "angle_gap_deg": 0.0, "scale_gap": 0.0, "stop_t_gap_mm": 0.75}
    out = run.run_cell(cell, 5, 0.0, False, "cpu")
    assert out["checks"] == {"t_gap_mm": {"value": 0.75, "limit": 0.5}}
    assert not out["result"]["correct"]


@pytest.mark.parametrize("key", ["weigthed", "m", "translation_threshold"])
def test_an_icp_key_that_sets_no_field_fails_at_spec_cell(tmp_path, key):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "portbench/configs/kinect_rgbd_16384x256.json").read_text())
    config["icp"][key] = 1.0
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    shutil.copytree(ROOT / "portbench" / "traffic", tmp_path / "portbench" / "traffic")
    shutil.copytree(ROOT / "portbench" / "entries", tmp_path / "portbench" / "entries")
    shutil.copytree(ROOT / "portbench" / "reference", tmp_path / "portbench" / "reference",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "portbench/configs/kinect_rgbd_16384x256.json").write_text(json.dumps(config))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError, match=repr(key)):
        spec.cell("kinect.stream", root=tmp_path)


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
    assert set(line["metrics"]) == {"pairs_per_s", "ms_per_iteration", "setup_s"}
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
