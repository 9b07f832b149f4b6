"""The span recorder of ``icp_tpu_torch.runtime.timing`` on the register
path, on the CPU at a tiny size (1024 landmarks, 16 representatives).

Off by default, a registration records no span; switched on, the spans nest
as the register path does (``icp.register`` > ``icp.build_target`` >
``icp.normals``; ``icp.register`` > ``icp.run`` > ``icp.chunk`` and
``icp.host_read``), one registration id a call, and each name's self time
is its duration less its children's. The counter counts every lane's step
of every chunk. The registration's q, t, s and k are bitwise the same with
spans on and off. A span is stamped on the clock of the profiler's host
records, and ``trace()`` writes the spans into its Chrome trace on the
trace's own clock.
"""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import json

import pytest
import torch

import icp_tpu_torch
from icp_tpu_torch.icp.run import CHUNK
from icp_tpu_torch.runtime import timing
from icp_tpu_torch.sensors.synthetic import synthetic_pair

M, B = 1024, 2
CONFIGS = {
    "point": dict(m=M, n_r=16),
    "plane": dict(m=M, n_r=16, objective=icp_tpu_torch.Objective.PLANE, normal_mode="knn",
                  estimate_scale=False),
}
FIELDS = ("q", "t", "s", "k")


@pytest.fixture
def spans():
    """Recording on for the test, and nothing left over from an earlier
    test."""
    timing.take_spans()
    timing.record_spans(True)
    try:
        yield
    finally:
        timing.record_spans(False)
        timing.take_spans()


def _call(entry: str, objective: str = "point"):
    """One call of ``entry`` on the tiny pair (a batch of B copies of it,
    the second moved by half as much)."""
    config = icp_tpu_torch.ICPConfig(**CONFIGS[objective])
    params = icp_tpu_torch.ICPParams(alpha=2e2)
    fixed, moving = (torch.from_numpy(x) for x in synthetic_pair(M, seed=3))
    if entry == "register":
        return icp_tpu_torch.register(fixed, moving, params, config), 1
    half = fixed + 0.5 * (moving - fixed)
    return icp_tpu_torch.register_batch(torch.stack([fixed, fixed]),
                                        torch.stack([moving, half]), params, config), B


def test_spans_off_record_nothing():
    timing.record_spans(False)
    timing.take_spans()
    before = timing.counters()
    _call("register")
    assert timing.take_spans() == []
    assert timing.counters()["icp.steps_enqueued"] > before.get("icp.steps_enqueued", 0)


@pytest.mark.parametrize("entry", ["register", "register_batch"])
@pytest.mark.parametrize("objective", list(CONFIGS))
def test_spans_nest_as_the_register_path(spans, entry, objective):
    _, lanes = _call(entry, objective)
    _, lanes = _call(entry, objective)
    recorded = timing.take_spans()
    by_id = {s.id: s for s in recorded}
    regs = [s for s in recorded if s.name == "icp.register"]
    assert len(regs) == 2 and len({s.registration for s in regs}) == 2
    parent_of = {"icp.build_target": "icp.register", "icp.run": "icp.register",
                 "icp.chunk": "icp.run", "icp.host_read": "icp.run"}
    for s in recorded:
        if s.name == "icp.register":
            assert s.parent is None
            continue
        parent = by_id[s.parent]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        assert s.registration == parent.registration is not None
        if s.name == "icp.normals":
            assert parent.name in ("icp.build_target", "icp.run")
        else:
            assert parent.name == parent_of[s.name], s
    for reg in regs:
        mine = [s.name for s in recorded if s.registration == reg.registration]
        assert mine.count("icp.build_target") == lanes and mine.count("icp.run") == 1
        assert mine.count("icp.host_read") == mine.count("icp.chunk") + 1
        if objective == "plane":
            assert mine.count("icp.normals") == lanes
    # Self time: each name's durations less its children's.
    info = timing.ProfilingInfo(spans=recorded)
    own = info.self_ms()
    for name in {s.name for s in recorded}:
        dur = sum(s.end_ns - s.start_ns for s in recorded if s.name == name)
        kids = sum(s.end_ns - s.start_ns for s in recorded
                   if s.parent is not None and by_id[s.parent].name == name)
        assert own[name] == pytest.approx((dur - kids) * 1e-6, abs=1e-9)
    assert "self time" in info.summary()


@pytest.mark.parametrize("entry", ["register", "register_batch"])
def test_steps_enqueued_are_chunk_steps_of_every_lane(spans, entry):
    before = timing.counters()
    _, lanes = _call(entry)
    after = timing.counters()
    delta = {k: after[k] - before.get(k, 0) for k in after}
    recorded = timing.take_spans()
    chunks = sum(1 for s in recorded if s.name == "icp.chunk")
    assert chunks >= 1
    assert delta["icp.steps_enqueued"] == CHUNK * chunks * lanes


@pytest.mark.parametrize("entry", ["register", "register_batch"])
def test_results_bitwise_equal_with_spans_on_and_off(spans, entry):
    on, _ = _call(entry)
    timing.record_spans(False)
    off, _ = _call(entry)
    assert timing.take_spans()
    for f in FIELDS:
        assert torch.equal(getattr(on, f), getattr(off, f)), f


def test_span_holds_the_profilers_record_function_on_one_clock(spans):
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with timing.span("outer"):
        with torch.profiler.record_function("inner_op"):
            torch.ones(4096).cumsum(0)
    prof.stop()
    outer, = timing.take_spans()
    inner, = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner_op"]
    assert outer.start_ns <= inner.start_ns() <= inner.end_ns() <= outer.end_ns


def test_trace_writes_the_spans_on_its_clock(spans, tmp_path):
    with timing.trace(str(tmp_path)):
        with timing.span("outer"):
            with torch.profiler.record_function("inner_op"):
                torch.ones(4096).cumsum(0)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    outer, = [e for e in events if e.get("cat") == "program_span"]
    inner, = [e for e in events if e.get("name") == "inner_op"]
    assert outer["name"] == "outer" and outer["ph"] == "X"
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert timing.take_spans()  # the export leaves the spans to their taker
