"""A run with the timed path broken underneath comes out not correct: the
rest of a run (pool, window, check against the plain reference) on the CPU
at a tiny size, the port's plain twins standing for its kernels. The
cells' faults: a step that returns its state unchanged; half of the points
(and, in a batch, half of the lanes) left out; an answer altered where it is
produced; a registration stopped early. There is no exchange between chips to leave out: every cell
runs on one."""

import dataclasses

import pytest
import torch

from conftest import tiny
from portbench import run, spec

import icp_tpu_torch
import icp_tpu_torch.icp.run as port_run

SEED = 2 ** 31 + 77


CELLS = ["kinect.stream", "kinect.batch16", "lidar.stream"]
# kinect.batch16 is the Kinect configuration under the batch16_pool64 mix,
# kept for a later cell of the Batch layer (not in BENCHMARK.json today).
# The early stop planted in each: after the first chunk where registrations
# run for several chunks, after the first iteration where they stop in a few.
STOP_AFTER = {"kinect.stream": 8, "kinect.batch16": 8, "lidar.stream": 1}


def _cell(name):
    if name == "kinect.batch16":
        cell = spec.cell("kinect.stream")
        cell["traffic"] = spec.load_json(spec.HERE / "traffic" / "batch16_pool64.json")
        return tiny(cell, 4096, 32, pool=4, batch=2)
    return tiny(spec.cell(name), 4096, 32, pool=4)


def _correct(cell) -> tuple[bool, dict]:
    out = run.run_cell(cell, SEED, 0.0, False, "cpu")
    return out["result"]["correct"], out["checks"]


def unchanged_step(state, *args, **kwargs):
    """A step that leaves the state as it was (it only counts)."""
    return dataclasses.replace(state, k=state.k + 1, qk=torch.tensor([0.0, 0, 0, 1]),
                               tk=torch.zeros(3))


def half_points_step(real):
    def step(state, moving8, *args, **kwargs):
        kwargs["moving_normals"] = None
        return real(state, moving8[: moving8.shape[0] // 2], *args, **kwargs)
    return step


def half_lanes(real):
    def register_batch(fixed8, moving8, params, config):
        b = fixed8.shape[0]
        st = real(fixed8[: b // 2], moving8[: b // 2], params, config)
        return type(st)(**{f.name: torch.cat([getattr(st, f.name)] * 2)
                           for f in dataclasses.fields(st)})
    return register_batch


def early_stop(real, iterations=8):
    def register(fixed8, moving8, params, config):
        return real(fixed8, moving8, params,
                    dataclasses.replace(config, max_iterations=iterations))
    return register


def altered_answer(real, limit_mm):
    def register(*args):
        st = real(*args)
        return dataclasses.replace(st, t=st.t + torch.tensor([2 * limit_mm, 0.0, 0.0]))
    return register


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    ok, checks = _correct(_cell(name))
    assert ok, checks


@pytest.mark.parametrize("name, fault", [
    (name, fault) for name in CELLS
    for fault in ("unchanged_step", "half_points", "altered_answer", "early_stop")] + [
    ("kinect.batch16", "half_lanes")])
def test_fault_comes_out_not_correct(monkeypatch, name, fault):
    cell = _cell(name)
    if fault == "unchanged_step":
        monkeypatch.setattr(port_run, "icp_step", unchanged_step)
    elif fault == "half_points":
        monkeypatch.setattr(port_run, "icp_step", half_points_step(port_run.icp_step))
    elif fault == "half_lanes":
        monkeypatch.setattr(icp_tpu_torch, "register_batch",
                            half_lanes(icp_tpu_torch.register_batch))
    else:
        target = "register_batch" if "batch" in name else "register"
        real = getattr(icp_tpu_torch, target)
        planted = (early_stop(real, STOP_AFTER[name]) if fault == "early_stop"
                   else altered_answer(real, cell["limits"]["t_gap_mm"]))
        monkeypatch.setattr(icp_tpu_torch, target, planted)
    ok, checks = _correct(cell)
    assert not ok, checks


def test_a_pose_that_is_not_a_number_is_not_correct(monkeypatch):
    cell = _cell("lidar.stream")
    real = icp_tpu_torch.register

    def nan_pose(*args):
        st = real(*args)
        return dataclasses.replace(st, t=st.t * float("nan"))

    monkeypatch.setattr(icp_tpu_torch, "register", nan_pose)
    out = run.run_cell(cell, SEED, 0.0, False, "cpu")
    assert not out["result"]["correct"] and out["result"]["failed"] > 0
    assert out["checks"]["t_gap_mm"]["value"] == float("inf")
