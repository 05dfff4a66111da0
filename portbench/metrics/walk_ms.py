"""Host ms a request spends in the executor's walk:
``_executor.execute_views``/``execute_many`` as ``_materialize`` calls
them, from entry to return (the enqueue of the device work), wrapped in the
traced run; the median over the traced window's requests."""

from portbench.metrics._common import median_ms


def read(r):
    return median_ms(r, "walk")
