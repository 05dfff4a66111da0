"""Public alias for the per-block functions (dask's ``dask.array.chunk``)."""

from dask_array_tpu_torch._chunk import (  # noqa: F401
    argtopk,
    astype,
    coarsen,
    concat,
    flatten,
    getitem,
    keepdims_wrapper,
    topk,
    trim,
)
