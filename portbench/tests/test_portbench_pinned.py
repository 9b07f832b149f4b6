"""The harness's outputs for the two measured configurations, pinned
bitwise to those it gave before a configuration could name its settings,
its reference and its entry (``pinned_outputs.json``, taken on the CPU with
two threads, as a run sets them): the port's settings, the rows that the
``register`` and ``register_batch`` entries return on a tiny pool, and
``check.compare``'s and the TF32 control's numbers over those rows."""

import json

import pytest
import torch

from conftest import ROOT, tiny
from portbench import calibrate, check, drive, scene, spec

PINNED = json.loads((ROOT / "portbench" / "tests" / "pinned_outputs.json").read_text())
SEED = 2 ** 31 + 41
# (case, cell, traffic mix or None for the cell's own, pairs a call)
CASES = [("kinect.stream", "kinect.stream", None, 1),
         ("kinect.batch16", "kinect.stream", "batch16_pool64", 2),
         ("lidar.stream", "lidar.stream", None, 1)]


def _hex(d: dict) -> dict:
    return {k: float(v).hex() for k, v in sorted(d.items())}


@pytest.fixture(scope="module")
def outputs():
    torch.set_num_threads(2)
    out = {}
    for case, name, mix, batch in CASES:
        cell = spec.cell(name)
        if mix:
            cell["traffic"] = spec.load_json(spec.HERE / "traffic" / f"{mix}.json")
        cell = tiny(cell, 1024, 16, pool=2, batch=batch)
        config, traffic = cell["config"], cell["traffic"]
        with torch.no_grad():
            pool = scene.make_pool(SEED, config, 2, "cpu")
            system = drive.System(config, traffic, pool["frames"], 1)
            calls = [(float(n), float(n + 1), system.pairs(n), system.call(n))
                     for n in range(2 // batch)]
            window = drive.Window(calls=calls, seconds=4.0)
            out[case] = {
                "rows": [[[float(x).hex() for x in r] for r in c[3].tolist()] for c in calls],
                "pairs": [[list(p) for p in c[2]] for c in calls],
                "compare": _hex(check.compare(pool["frames"], window, config, SEED, 3)),
                "control": _hex(calibrate.control(pool["frames"], window, config, SEED, 3))}
    return out


@pytest.mark.parametrize("name", ["kinect.stream", "lidar.stream"])
def test_settings_are_the_pinned_ones(name):
    params, cfg = drive.port_settings(spec.cell(name)["config"])
    assert repr(params) + " " + repr(cfg) == PINNED[name + ".settings"]


@pytest.mark.parametrize("case", [c[0] for c in CASES])
@pytest.mark.parametrize("what", ["rows", "pairs", "compare", "control"])
def test_outputs_are_the_pinned_ones(outputs, case, what):
    assert outputs[case][what] == PINNED[f"{case}.{what}"]
