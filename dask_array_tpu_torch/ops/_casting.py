"""dtype casting as an elementwise expression (``Array.astype``)."""

from __future__ import annotations

import numpy as np

from dask_array_tpu_torch._blockwise import Elemwise
from dask_array_tpu_torch._chunks import cast


def _astype(x, dtype=None):
    """numpy's ``astype`` of a block (``_chunks.cast``: floats to unsigned
    truncate toward zero then wrap, uint64 converts from and to its bits)."""
    dt = np.dtype(dtype)
    if isinstance(x, np.ndarray):
        return x.astype(dt)
    return cast(x, dt)


def astype_expr(expr, dtype):
    dtype = np.dtype(dtype)
    if expr.dtype == dtype:
        return expr
    return Elemwise(_astype, (("dtype", dtype),), expr)
