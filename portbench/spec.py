"""Finding a cell's parts by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic mix (``traffic/<name>.json``), its
correctness limits (``limits/<config>.json``), the entry point its mix
calls (``entries/<entry>.py``), the plain reference its configuration
names (``reference/<name>.py``, :data:`DEFAULT_REFERENCE` where it names
none) and the reader of each metric (``metrics/<name>.py``). A later cell,
mix, configuration, entry, reference or metric is a new file and a new
entry; nothing here changes.

The contracts of the modules found by name:

* ``entries/<entry>.py`` defines ``Entry(config, traffic, frames, start)``
  (a ``drive.Entry``): set up once, its ``call(n)`` runs the window's call
  n and returns its (batch, 9) float64 rows q (4), t (3), s, k on the host,
  ``pairs(n)`` gives that call's (fixed, moving) frame pairs, ``frames``
  the pool;
* ``reference/<name>.py`` defines ``run(frames, pair, icp, run_to, cache,
  tf32)``: the plain reference's registration of ``pair`` under the
  configuration's ``icp`` section, run until it stops by its own test and
  on to iteration ``run_to``, ``cache`` a dict kept over one run's sample,
  with TF32 matrix products where ``tf32`` (the control); it returns
  {"k": the iteration it stopped at, "poses": [(q (4,), t (3,), s) float64
  after each iteration]};
* ``metrics/<name>.py`` defines ``read(window) -> float | None``.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
DEFAULT_REFERENCE = "point_plane"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def part(kind: str, name: str, root: Path = ROOT):
    """The module ``<kind>/<name>.py`` of the harness in the checkout at
    ``root``, loaded from its file."""
    path = root / HERE.name / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r}: {path} does not exist")
    module_name = f"{HERE.name}.{kind}.{name}"
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module  # where dataclasses look their module up
    spec.loader.exec_module(module)
    return module


def entry(name: str, root: Path = ROOT):
    """The ``Entry`` class of ``entries/<name>.py``."""
    return part("entries", name, root).Entry


def reference(config: dict, root: Path = ROOT):
    """The ``run`` of the plain reference that the configuration names."""
    return part("reference", config.get("reference", DEFAULT_REFERENCE), root).run


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(window) -> float | None`` of ``metrics/<name>.py``."""
    return part("metrics", name, root).read


def cell(name: str, root: Path = ROOT) -> dict:
    """Everything one run of cell ``name`` needs: its workload entry, config,
    traffic, limits, the metrics it reports (end-to-end and per-layer,
    each entry of ``BENCHMARK.json`` that lists this cell or lists none)
    and the checkout's ``root``, where its entry and reference are found.
    Fails here on an ``icp`` key that names no setting of the port, and on
    an entry or reference that does not exist."""
    from portbench.drive import port_settings

    bench = benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    work = found[0]
    conf_entry = [c for c in bench["configs"] if c["name"] == work["config"]][0]

    def reported(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    here = root / HERE.name
    config = load_json(root / conf_entry["file"])
    traffic = load_json(here / "traffic" / f"{work['traffic']}.json")
    port_settings(config)
    entry(traffic["entry"], root)
    reference(config, root)
    return {
        "workload": work,
        "config": config,
        "traffic": traffic,
        "limits": load_json(here / "limits" / f"{work['config']}.json"),
        "end_to_end": reported(bench["end_to_end"]),
        "per_layer": reported(bench["per_layer"]),
        "run_seconds": bench["run_seconds"],
        "root": root,
    }
