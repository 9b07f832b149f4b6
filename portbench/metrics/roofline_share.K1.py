"""Share of its roofline of the nearest-representative assignment (K1), %:
the least time of the calls in the traced window (``work.py``'s count from
the cell's shapes against ``peaks.py``) over their device time."""

from portbench.peaks import least_seconds
from portbench.work import nearest_rep_assignment

KERNELS = ("rep_assign_counts_kernel",)


def read(window):
    if window.trace is None:
        return None
    calls = window.trace.device_count(KERNELS)
    if not calls:
        return None
    ops, nbytes = nearest_rep_assignment(window.config["points"],
                                         window.config["icp"]["n_r"])
    return 100.0 * calls * least_seconds(ops, nbytes) / window.trace.device_seconds(KERNELS)
