"""Host ms a request spends in the port's out-of-core check
(``_streaming.maybe_stream``, the span ``dask_array_tpu_torch.stream_check``
with its ``mem_get_info`` stalls; a streamed run, ``stream_run``, left
out), summed over the traced window and divided by its requests.

The readers of the port's own spans share what is defined here: a span's
intervals, merged, from the host events of the trace (any thread)."""

PREFIX = "dask_array_tpu_torch."


def merged(intervals) -> list:
    """The union of (t0, t1) intervals, as sorted disjoint [t0, t1]."""
    out = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def length(intervals) -> float:
    return sum(t1 - t0 for t0, t1 in intervals)


def overlap(a, b) -> float:
    """The length two lists of sorted disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def port_spans(r, name: str) -> list:
    """The merged intervals of the port's span ``name`` in the window."""
    full = PREFIX + name
    return merged((t0, t1) for n, t0, t1 in r.trace.host if n == full)


def ms_a_request(r, name: str, less: str | None = None):
    """The time in the span ``name``, less what its child span ``less``
    covers of it, in ms a request; None where the window holds no ``name``."""
    if r.trace is None or not r.requests:
        return None
    spans = port_spans(r, name)
    if not spans:
        return None
    us = length(spans) - (overlap(spans, port_spans(r, less)) if less else 0.0)
    return us * 1e-3 / r.requests


def read(r):
    return ms_a_request(r, "stream_check", less="stream_run")
