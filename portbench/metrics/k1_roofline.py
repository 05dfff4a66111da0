"""K1's (``csrc/band_stencil.cu``) share of its roofline, in %: the least
time for the field read once and the answer written once, for every
map_overlap op of every traced request, over K1's device time."""

from portbench.metrics._common import field_bytes, stencil_ops

from portbench.yardstick import roofline_pct


def read(r):
    if r.trace is None:
        return None
    return roofline_pct(r.requests * stencil_ops(r) * 2 * field_bytes(r), r.trace.seconds("k1"))
