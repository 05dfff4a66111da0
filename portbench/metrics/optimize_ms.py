"""Host ms a request spends in the optimizer: ``_materialize.optimize_expr``
as ``_materialize`` calls it, wrapped in the traced run with a span of the
benchmark's own; the median over the traced window's requests."""

from portbench.metrics._common import median_ms


def read(r):
    return median_ms(r, "optimize")
