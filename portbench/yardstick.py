"""The benchmark's arithmetic, kept here so that no later change to the
program moves it: the card's peaks, a kernel's least time, percentiles and
the spread of a set of runs.

The peaks are NVIDIA's published rates for one H100 SXM at its full power
limit of 700 W (the same figures the port's ``chip_smoke.py`` uses): HBM3
at 3.35 TB/s and float32 outside the tensor cores at 67 TFLOP/s.
"""

from __future__ import annotations

import statistics

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def least_seconds(nbytes: float, flops: float = 0.0) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the float32 operations over the float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def roofline_pct(nbytes: float, seconds: float, flops: float = 0.0):
    """The share of the roofline, in %, of work that took ``seconds`` on
    the device, or None where nothing ran (a share is never 0 for want of
    a reading)."""
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * least_seconds(nbytes, flops) / seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of
    the median, with Python's ``statistics.quantiles(values, n=4)``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
