"""Public alias for the per-block functions (dask's ``dask.array.chunk``)."""

from dask_array_tpu_torch._chunk import (  # noqa: F401
    arange,
    argtopk,
    argtopk_aggregate,
    astype,
    coarsen,
    concat,
    flatten,
    getitem,
    keepdims_wrapper,
    linspace,
    topk,
    topk_aggregate,
    trim,
    view,
)
