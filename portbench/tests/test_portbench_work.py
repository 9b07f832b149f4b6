"""The K1 work count and its roofline share on a hand-made trace."""

import pytest

from portbench import peaks, work
from portbench.devtrace import Trace
from portbench.drive import Window
from portbench.spec import metric_reader


def test_k1_work_count():
    ops, nbytes = work.nearest_rep_assignment(16384, 256)
    assert ops == 50 * 16384 * 256
    assert nbytes == 4 * (8 * 16384 + 8 * 256 + 256 + 16384 + 256)
    # At the flagship shape the operations bound it.
    assert peaks.least_seconds(ops, nbytes) == pytest.approx(ops / 67e12)


def test_k1_roofline_share_from_the_trace():
    ops, nbytes = work.nearest_rep_assignment(262144, 2048)
    least = peaks.least_seconds(ops, nbytes)
    kernel = "void rep_assign_counts_kernel<true>(float const*)"
    trace = Trace(device=[(kernel, 0.0, 2 * least), (kernel, 1.0, 1.0 + 2 * least),
                          ("other", 2.0, 3.0)], host=[], start=0.0, end=4.0)
    w = Window(calls=[], seconds=4.0, trace=trace,
               config={"points": 262144, "icp": {"n_r": 2048}})
    assert metric_reader("roofline_share.K1")(w) == pytest.approx(50.0)
    # Nothing to read: no share, not 0.
    w.trace = Trace(device=[("other", 0.0, 1.0)], host=[], start=0.0, end=2.0)
    assert metric_reader("roofline_share.K1")(w) is None
    assert metric_reader("knn_kernels_ms")(w) is None
