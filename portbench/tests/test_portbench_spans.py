"""The span readings of ``spantrace.py`` on a hand-made window whose
spans, counters and trace records have known answers (nanoseconds on one
clock); every counter of the program in the windows of ``spantrace.py``
and ``drive.py``; and on the card the marker's launch between the span
clock's reads."""

import pytest

from conftest import tiny
from icp_tpu_torch.runtime.timing import Span
from portbench import devtrace, scene, spantrace, spec
from portbench.drive import System, Window, first_call
from portbench.drive import run_window as drive_run_window
from portbench.spantrace import Event, SpanRecord

# Registration 1 ran before the profiler, 0 under it (0-1000 ns), 2 after it.
SPANS = [
    ("icp.register", 0, 900, 0, None, 0), ("icp.build_target", 10, 100, 1, 0, 0),
    ("icp.normals", 20, 60, 2, 1, 0), ("icp.run", 100, 880, 3, 0, 0),
    ("icp.host_read", 100, 110, 4, 3, 0), ("icp.chunk", 110, 300, 5, 3, 0),
    ("icp.host_read", 300, 850, 6, 3, 0),
    ("icp.register", -1000, -400, 7, None, 1), ("icp.build_target", -990, -900, 8, 7, 1),
    ("icp.run", -900, -410, 9, 7, 1), ("icp.host_read", -900, -890, 10, 9, 1),
    ("icp.chunk", -890, -690, 11, 9, 1), ("icp.host_read", -690, -500, 12, 9, 1),
    ("icp.register", 2000, 2600, 13, None, 2), ("icp.run", 2100, 2590, 14, 13, 2),
    ("icp.chunk", 2110, 2510, 15, 14, 2), ("icp.host_read", 2510, 2520, 16, 14, 2),
]
# (name, start, end, correlation) of the CUDA API calls and the device
# operations they launched; the markers are correlations 1 and 99.
API = [
    ("cudaLaunchKernel", 2, 6, 1),
    ("cudaLaunchKernel", 10, 12, 2),       # on build_target's first edge
    ("cudaMemcpyAsync", 50, 55, 3),        # inside the normals
    ("cudaLaunchKernel", 110, 112, 4),     # on the chunk's first edge
    ("cudaFuncGetAttributes", 200, 205, 6),  # no launch
    ("cudaLaunchKernelExC", 250, 252, 7),
    ("cudaLaunchKernel", 300, 301, 5),     # on the chunk's last edge
    ("cudaMemcpyAsync", 305, 840, 8),      # the host read: outside the chunk
    ("cudaLaunchKernel", 940, 945, 99),
]
DEVICE = [("fill", 7, 9, 1), ("k2", 15, 40, 2), ("copy", 60, 130, 3), ("k4", 120, 200, 4),
          ("k7", 260, 280, 7), ("k5", 310, 320, 5), ("d2h", 845, 848, 8), ("fill", 950, 960, 99)]
COUNTS = {"icp.steps_enqueued": 8}


def _window(spans=SPANS, anchor=(0, 8), with_spans=True):
    events = ([Event(n, False, s, e, c) for n, s, e, c in API]
              + [Event(n, True, s, e, c) for n, s, e, c in DEVICE])
    total = {k: 3 * v for k, v in COUNTS.items()}
    rec = SpanRecord(spans=[Span(*s) for s in spans], before=dict(COUNTS),
                     profiled=dict(COUNTS), total=total, profiled_ns=(0, 1000),
                     profiled_calls=range(1, 2), events=events,
                     anchor_ns=anchor) if with_spans else None
    row = lambda k: [[0, 0, 0, 1, 0, 0, 0, 1, k]]
    w = Window(calls=[(0.0, 1.0, [(0, 1)], row(5)), (1.0, 2.0, [(1, 2)], row(3)),
                      (2.0, 3.0, [(2, 3)], row(8))], seconds=3.0)
    w.spans = rec
    return w


def test_readings_of_the_hand_made_window():
    w = _window()
    assert spantrace.clock_skew_ns(w.spans) == 0
    # 200 ns in the chunk of the call before the profiler over its 8 steps.
    assert spantrace.step_host_ms(w) == pytest.approx(200e-6 / 8)
    # Launches at 110 and 300 (both edges) and 250; not the attribute query,
    # nor the host read's copy at 305.
    assert spantrace.launches_per_step(w) == pytest.approx(3 / 8)
    # k 5 + 3 + 8 of 24 steps enqueued.
    assert spantrace.chunk_tail_share(w) == pytest.approx(100.0 / 3)
    assert spantrace.host_read_wait_ms(w) == pytest.approx(200e-6)
    # From build_target's start (10) to the end of the copy launched in its
    # normals (130), joined by correlation id.
    assert spantrace.index_ms(w) == pytest.approx(120e-6)


def test_idle_by_span_puts_every_gap_down_to_a_span():
    w = _window()
    got = dict(map(tuple, spantrace.idle_by_span(w)))
    assert got == {"icp.build_target/cudaLaunchKernel": pytest.approx(8e-9),
                   "icp.normals/cudaMemcpyAsync": pytest.approx(20e-9),
                   "icp.chunk/" + devtrace.HOST: pytest.approx(90e-9),
                   "icp.host_read/cudaMemcpyAsync": pytest.approx(525e-9),
                   "outside/" + devtrace.HOST: pytest.approx(112e-9)}
    trace = devtrace.from_events([(n, on, s * 1e-9, e * 1e-9)
                                  for n, on, s, e in ([(n, False, s, e) for n, s, e, _ in API]
                                                      + [(n, True, s, e)
                                                         for n, s, e, _ in DEVICE])])
    idle = trace.window_s - trace.busy_s
    assert sum(got.values()) == pytest.approx(idle, rel=0.01)


@pytest.mark.parametrize("case", ["skewed_clock", "no_chunk_traced", "no_spans"])
def test_none_where_nothing_can_be_read(case, capsys):
    if case == "no_chunk_traced":
        w = _window(spans=[s for s in SPANS if not (s[0] == "icp.chunk" and s[5] == 0)])
        assert spantrace.launches_per_step(w) is None
        assert spantrace.index_ms(w) is not None
        return
    if case == "skewed_clock":
        w = _window(anchor=(100_000, 100_008))
        assert spantrace.clock_skew_ns(w.spans) == 100_000 - 2
        assert spantrace.step_host_ms(w) is not None  # host-only: no join
    else:
        w = _window(with_spans=False)
        assert spantrace.step_host_ms(w) is None and spantrace.chunk_tail_share(w) is None
        assert spantrace.host_read_wait_ms(w) is None
    assert spantrace.launches_per_step(w) is None
    assert spantrace.index_ms(w) is None
    assert spantrace.idle_by_span(w) is None
    assert ("skew" in capsys.readouterr().err) == (case == "skewed_clock")


@pytest.mark.cuda
def test_marker_launch_lies_between_the_span_clock_reads(cuda_device):
    import torch

    full = spec.cell("kinect.stream")
    cell = tiny(full, 4096, 64, pool=4)
    config, traffic = cell["config"], cell["traffic"]
    with torch.no_grad():
        pool = scene.make_pool(2 ** 31 + 9, config, 4, cuda_device)
        system = System(config, traffic, pool["frames"], first_call(traffic, 9))
        system.call(0)
        w, _ = spantrace.run_window(system, 2.0, trace_calls=2)
    rec = w.spans
    assert len(rec.profiled_calls) == 2 and rec.profiled_calls.start > 0
    skew = spantrace.clock_skew_ns(rec)
    assert skew is not None and skew <= spantrace.SKEW_LIMIT_NS, rec.anchor_ns
    for read in (spantrace.step_host_ms, spantrace.launches_per_step,
                 spantrace.chunk_tail_share, spantrace.host_read_wait_ms, spantrace.index_ms):
        assert read(w) is not None, read.__name__
    assert spantrace.idle_by_span(w)


class _Counting:
    """Stands for the port: each call counts what a registration of two
    chunks replayed from the CUDA graph counts."""

    frames = None

    def call(self, n):
        from icp_tpu_torch.runtime import timing

        timing.count("icp.steps_enqueued", 16)
        timing.count("icp.chunk_graph.replays", 2)
        return [[0, 0, 0, 1, 0, 0, 0, 1, 12]]

    def pairs(self, n):
        return [(n, n + 1)]


def test_every_counter_reaches_the_window():
    w, _ = spantrace.run_window(_Counting(), 0.0)
    calls = len(w.calls)
    # spanprobe.py prints ``w.spans.total`` as its counters_total.
    assert w.spans.total["icp.chunk_graph.replays"] == 2 * calls
    assert w.spans.total["icp.steps_enqueued"] == 16 * calls
    assert spantrace.chunk_tail_share(w) == pytest.approx(25.0)
    w, _ = drive_run_window(_Counting(), 0.0)
    assert w.counters["icp.chunk_graph.replays"] == 2 * len(w.calls)
    assert w.traced_counters == {} and w.traced_spans == []
