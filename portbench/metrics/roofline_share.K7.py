"""Share of its roofline of the per-bin Gauss-Newton moments (K7), %: the
least time of the calls in the traced window (``work_gn.py``'s count from
the cell's shapes and K7's mode, against ``peaks.py``) over their device
time."""

from portbench.peaks import least_seconds
from portbench.work_gn import gn_mode, gn_moments

KERNELS = ("bin_gn_moments_kernel",)


def read(window):
    if window.trace is None:
        return None
    calls = window.trace.device_count(KERNELS)
    if not calls:
        return None
    m = window.config["points"]
    icp = window.config["icp"]
    ops, nbytes = gn_moments(m, m, icp["n_r"], gn_mode(icp))
    return 100.0 * calls * least_seconds(ops, nbytes) / window.trace.device_seconds(KERNELS)
