"""95th percentile over every call of the window of the time from handing
the pair to the port to reading its pose on the host, ms: the tail that
``latency_p95_ms`` reads end to end, kept per layer where the host's speed
spreads it too widely for a bound."""

from portbench.stats import percentile


def read(window):
    return percentile(window.latencies_s, 95) * 1e3
