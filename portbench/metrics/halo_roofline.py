"""The halo kernel's (``csrc/halo.cu``) share of its roofline, in %: the
least time for the field read once and the field with its boundary of
``depth`` cells on every side written once, for every map_overlap op of
every traced request, over the halo kernel's device time."""

import numpy as np
from portbench.metrics._common import field_bytes, itemsize, stencil_ops

from portbench.yardstick import roofline_pct


def read(r):
    if r.trace is None:
        return None
    d = r.cfg["depth"]
    padded = int(np.prod([s + 2 * d for s in r.cfg["shape"]])) * itemsize(r)
    return roofline_pct(r.requests * stencil_ops(r) * (field_bytes(r) + padded), r.trace.seconds("halo"))
