"""Host ms a request spends capturing a ``map_overlap`` func with
``torch.fx`` (``kernels/stencil.stencil_spec``, the span
``dask_array_tpu_torch.capture``), summed over the traced window and
divided by its requests."""

from portbench.metrics.stream_check_ms import ms_a_request


def read(r):
    return ms_a_request(r, "capture")
