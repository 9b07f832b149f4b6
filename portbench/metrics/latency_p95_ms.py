"""95th percentile over every call of the window of the time from handing
the pair to the port to reading its pose on the host, ms."""

from portbench.stats import percentile


def read(window):
    return percentile(window.latencies_s, 95) * 1e3
