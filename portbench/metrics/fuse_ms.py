"""Host ms a request spends routing statistics to the multi-statistic
kernel (``ops/_multistat.fuse_multi_stat``, the span
``dask_array_tpu_torch.fuse_multistat``, inside or outside the
optimizer), summed over the traced window and divided by its requests."""

from portbench.metrics.stream_check_ms import ms_a_request


def read(r):
    return ms_a_request(r, "fuse_multistat")
