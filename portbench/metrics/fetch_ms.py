"""Host ms a request spends bringing its answers to numpy
(``_hostcopy.fetch_into``, the span ``dask_array_tpu_torch.fetch``), less
its waits on the card (the child ``fetch.wait``: the card is busy then),
summed over the traced window and divided by its requests."""

from portbench.metrics.stream_check_ms import ms_a_request


def read(r):
    return ms_a_request(r, "fetch", less="fetch.wait")
