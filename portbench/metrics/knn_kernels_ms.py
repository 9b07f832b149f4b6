"""Device ms per registration of the kNN normal estimator's kernels (the
top-2 representative assignment and the per-ball kNN moments) in the traced
window."""

KERNELS = ("rep_top2_counts_kernel", "bin_knn_moments_kernel")


def read(window):
    if window.trace is None or not window.trace.device_count(KERNELS):
        return None
    return window.trace.device_seconds(KERNELS) * 1e3 / window.traced_pairs
