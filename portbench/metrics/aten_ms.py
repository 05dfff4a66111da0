"""Device ms a request spends in operations that are none of the port's
hand kernels (ATen, cuBLAS, copies and sets), from the profiler's trace."""


def read(r):
    if r.trace is None or not r.requests:
        return None
    seconds = r.trace.seconds(other=True)
    return seconds / r.requests * 1e3 if seconds > 0 else None
