"""dtype casting as an elementwise expression (``Array.astype``)."""

from __future__ import annotations

import numpy as np
import torch

from dask_array_tpu_torch._blockwise import Elemwise
from dask_array_tpu_torch._chunks import torch_dtype


def _astype(x, dtype=None):
    dt = np.dtype(dtype)
    if isinstance(x, np.ndarray):
        return x.astype(dt)
    if dt.kind == "u" and x.is_floating_point():
        # numpy float->unsigned casts truncate toward zero then wrap;
        # route through int64 (truncates) then to unsigned (wraps)
        return x.to(torch.int64).to(torch_dtype(dt))
    return x.to(torch_dtype(dt))


def astype_expr(expr, dtype):
    dtype = np.dtype(dtype)
    if expr.dtype == dtype:
        return expr
    return Elemwise(_astype, (("dtype", dtype),), expr)
