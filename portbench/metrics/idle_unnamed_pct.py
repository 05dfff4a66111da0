"""The share of the card's idle time in the traced window that no span of
the port names, in %: the window less the device's operations
(``Trace.busy_intervals``), less what any ``dask_array_tpu_torch.*`` span
but a request's root, ``compute:<id>``, covers (on any thread), over the
window less the device's operations.  None where the window holds no span
of the port."""

from portbench.metrics.stream_check_ms import PREFIX, length, merged, overlap

ROOT = PREFIX + "compute:"


def read(r):
    if r.trace is None:
        return None
    named = merged((t0, t1) for n, t0, t1 in r.trace.host if n.startswith(PREFIX) and not n.startswith(ROOT))
    if not named:
        return None
    idle, prev = [], r.trace.w0
    for t0, t1 in r.trace.busy_intervals():
        if t0 > prev:
            idle.append([prev, t0])
        prev = max(prev, t1)
    if r.trace.w1 > prev:
        idle.append([prev, r.trace.w1])
    idle_us = length(idle)
    if idle_us <= 0:
        return None
    return 100.0 * (idle_us - overlap(idle, named)) / idle_us
