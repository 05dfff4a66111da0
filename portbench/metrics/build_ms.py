"""Host ms a request spends building its expressions through the public
API (the benchmark's own span around the builds); the median over the
traced window's requests."""

from portbench.metrics._common import median_ms


def read(r):
    return median_ms(r, "build")
