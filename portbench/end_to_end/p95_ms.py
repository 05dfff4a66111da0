"""ms: the 95th percentile of the latency of every request in the window."""

from portbench.yardstick import percentile


def read(w):
    return percentile(w.latencies, 95) * 1e3
