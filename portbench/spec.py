"""Finding a cell's parts by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic mix (``traffic/<name>.json``), its
correctness limits (``limits/<config>.json``) and the reader of each metric
(``metrics/<name>.py``). A later cell, mix or metric is a new file and a new
entry; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    """Everything one run of cell ``name`` needs: its workload entry, config,
    traffic, limits and the metrics it reports (end-to-end and per-layer,
    each entry of ``BENCHMARK.json`` that lists this cell or lists none)."""
    bench = benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    work = found[0]
    conf_entry = [c for c in bench["configs"] if c["name"] == work["config"]][0]

    def reported(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    here = root / HERE.name
    return {
        "workload": work,
        "config": load_json(root / conf_entry["file"]),
        "traffic": load_json(here / "traffic" / f"{work['traffic']}.json"),
        "limits": load_json(here / "limits" / f"{work['config']}.json"),
        "end_to_end": reported(bench["end_to_end"]),
        "per_layer": reported(bench["per_layer"]),
        "run_seconds": bench["run_seconds"],
    }


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(window) -> float | None`` of ``metrics/<name>.py``."""
    path = root / HERE.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
