"""P4's (``csrc/mstat.cu``, both launches) share of its roofline, in %:
the least time for what its launches in the window must move, over P4's
device time.

P4 runs once for each compute whose reductions of the field need two or
more of its statistics (the multi-statistic route: ``sum(0)``, ``mean(1)``
and ``std()`` together, or a lone ``std()`` or ``var()``, which needs the
field's sum and its sum of squares).  Each run is one launch of
``mstat_main`` over the whole field, then one of ``mstat_finish``; it
reads the field once and writes its packed answers once: the column sums,
the row means and three scalars (``n + m + 3`` values).  So the bytes are
counted from the number of ``mstat_main`` launches the trace holds."""

from portbench.metrics._common import field_bytes, itemsize

from portbench.yardstick import roofline_pct


def read(r):
    if r.trace is None:
        return None
    m, n = r.cfg["shape"]
    per_launch = field_bytes(r) + (n + m + 3) * itemsize(r)
    return roofline_pct(r.trace.launches("mstat_main") * per_launch, r.trace.seconds("p4"))
