"""The yardstick's arithmetic on hand-made samples and traces."""

import numpy as np
import pytest

from portbench import stats
from portbench import devtrace
from portbench.devtrace import Trace
from portbench.drive import Window
from portbench.spec import metric_reader


def test_p95_is_over_all_values():
    xs = list(np.random.default_rng(0).exponential(size=401))
    assert stats.percentile(xs, 95) == pytest.approx(np.percentile(xs, 95))
    assert stats.percentile([3.0], 95) == 3.0


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert stats.covered(iv) == pytest.approx(3.0)
    assert stats.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]


def _window(calls, seconds, batch=1, trace=None, traced_calls=0):
    rows = lambda ks: np.array([[0, 0, 0, 1, 0, 0, 0, 1, k] for k in ks], dtype=float)
    return Window(calls=[(s, e, [(0, 1)] * len(ks), rows(ks)) for s, e, ks in calls],
                  seconds=seconds, traffic={"batch": batch}, trace=trace,
                  traced_calls=traced_calls,
                  config={"points": 1000, "icp": {"n_r": 10}})


def test_window_rates():
    w = _window([(0.0, 0.1, [8]), (0.1, 0.4, [16]), (0.4, 0.5, [8]), (0.5, 1.0, [24])], 1.0)
    assert metric_reader("pairs_per_s")(w) == pytest.approx(4.0)
    assert metric_reader("ms_per_iteration")(w) == pytest.approx(1000.0 / 56)
    assert metric_reader("iterations_per_pair")(w) == pytest.approx(14.0)
    lat = [0.1, 0.3, 0.1, 0.5]
    assert metric_reader("latency_p95_ms")(w) == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert metric_reader("call_p95_ms")(w) == metric_reader("latency_p95_ms")(w)
    batch = _window([(0.0, 1.0, [8, 9])], 1.0, batch=2)
    assert metric_reader("pairs_per_s")(batch) == pytest.approx(2.0)


def test_idle_share_is_one_minus_the_union_over_the_window():
    trace = Trace(device=[("k1", 0.0, 1.0), ("k2", 0.5, 2.0), ("k1", 6.0, 7.0)],
                  host=[("aten::item", 2.0, 6.0), ("aten::sort", 2.5, 2.6)],
                  start=0.0, end=10.0)
    w = _window([(0.0, 10.0, [4, 6])], 10.0, batch=2, trace=trace, traced_calls=1)
    assert trace.busy_s == pytest.approx(3.0)
    assert metric_reader("device_idle_share")(w) == pytest.approx(70.0)
    assert metric_reader("device_events_per_iteration")(w) == pytest.approx(0.3)
    gaps = dict(map(tuple, trace.idle_gaps()))
    assert gaps == {"aten::item": pytest.approx(4.0), devtrace.HOST: pytest.approx(3.0)}
    assert trace.top_device_ops()[0] == ["k1", pytest.approx(2.0)]
    assert metric_reader("device_idle_share")(_window([(0.0, 1.0, [4])], 1.0)) is None


def test_the_window_lies_between_the_two_device_markers():
    events = [("cudaLaunchKernel", False, 0.5, 0.6), ("fill", True, 1.0, 1.1),
              ("k1", True, 2.0, 3.0), ("cudaStreamSynchronize", False, 2.5, 3.2),
              ("k2", True, 3.5, 4.0), ("fill", True, 5.0, 5.2),
              ("cudaDeviceSynchronize", False, 6.0, 6.1)]
    trace = devtrace.from_events(events)
    assert (trace.start, trace.end) == (1.0, 5.2)
    assert [d[0] for d in trace.device] == ["k1", "k2"]
    assert [h[0] for h in trace.host] == ["cudaStreamSynchronize"]
    assert trace.busy_s == pytest.approx(1.5)
    with pytest.raises(RuntimeError):
        devtrace.from_events([("fill", True, 1.0, 1.1), ("x", False, 0.0, 2.0)])


def test_trace_overhead_compares_the_same_calls_one_cycle_later():
    from portbench.drive import trace_overhead

    w = _window([(0.0, 1.0, [4]), (1.0, 2.5, [4]), (2.5, 3.0, [4]), (3.0, 3.5, [4]),
                 (3.5, 4.0, [4])], 4.0, traced_calls=2)
    out = trace_overhead(w, per_cycle=3)
    assert out["traced_calls_wall_s"] == pytest.approx(2.5)
    assert out["same_calls_untraced_wall_s"] == pytest.approx(1.0)
    assert out["trace_overhead"] == pytest.approx(1.5)
    assert trace_overhead(w, per_cycle=4)["trace_overhead"] is None


def test_chunk_graph_hit_share_over_the_traced_calls():
    w = _window([(0.0, 1.0, [8])], 1.0, traced_calls=1)
    assert metric_reader("chunk_graph_hit_share")(w) is None
    w.traced_counters = {"icp.chunk_graph.replays": 9, "icp.chunk_eager": 3,
                         "icp.chunk_graph.captures": 1, "icp.steps_enqueued": 96}
    assert metric_reader("chunk_graph_hit_share")(w) == pytest.approx(75.0)
    w.counters = {"icp.chunk_eager": 5}  # the whole window's: not read
    assert metric_reader("chunk_graph_hit_share")(w) == pytest.approx(75.0)
