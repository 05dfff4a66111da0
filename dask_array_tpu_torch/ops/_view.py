"""Dtype-reinterpreting views (``Array.view``, ``chunk.view``).

Port of ``dask_array_tpu/ops/_view.py``.  On the device a view is
``Tensor.view(dtype)`` of the held tensor: no data moves, and where the
itemsizes differ the last axis scales by their ratio.  Every held dtype
takes part, numpy's unsigned integers (held as torch's uint16/32/64),
bfloat16 and float8 and datetime ticks among them; a host block is
viewed by numpy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dask_array_tpu_torch._chunks import torch_dtype
from dask_array_tpu_torch._executor import BlockView
from dask_array_tpu_torch._expr import ArrayExpr


class View(ArrayExpr):
    takes_narrow = True

    _parameters = ("array", "_dtype", "order")

    @functools.cached_property
    def chunks(self):
        old = self.array.dtype.itemsize
        new = np.dtype(self._dtype).itemsize
        chunks = list(self.array.chunks)
        if old == new:
            return tuple(chunks)
        last = chunks[-1]
        if old > new:
            chunks[-1] = tuple(c * (old // new) for c in last)
        else:
            factor = new // old
            if any(c % factor for c in last):
                raise ValueError(
                    "When changing to a larger dtype, every chunk along the last axis must be divisible by "
                    f"the itemsize ratio (ratio {factor}, chunks {last})"
                )
            chunks[-1] = tuple(c // factor for c in last)
        return tuple(chunks)

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * self.array.ndim, dtype=np.dtype(self._dtype))

    def _build(self, ctx):
        dense = ctx.build(self.array).dense()
        new = np.dtype(self._dtype)
        if not isinstance(dense, torch.Tensor):
            return BlockView(self.chunks, dense=dense.view(new))
        want = torch_dtype(new)
        if dense.dtype == want:
            return BlockView(self.chunks, dense=dense)
        # a torch view of another itemsize needs a unit-stride last axis
        src = dense if dense.ndim == 0 or dense.stride(-1) == 1 else dense.contiguous()
        if dense.ndim and src.element_size() != want.itemsize and not src.is_contiguous():
            src = src.contiguous()
        return BlockView(self.chunks, dense=src.view(want))


def view(x, dtype=None, order="C"):
    """``x`` with its bytes read as ``dtype`` (numpy's ``ndarray.view``)."""
    from dask_array_tpu_torch._collection import Array, new_collection

    if order != "C":
        raise NotImplementedError("view(order='F') is not supported")
    expr = x.expr if isinstance(x, Array) else x
    dtype = np.dtype(expr.dtype if dtype is None else dtype)
    if expr.ndim == 0 and dtype.itemsize != expr.dtype.itemsize:
        raise ValueError("cannot change itemsize of a 0-d array view")
    return new_collection(View(expr, dtype, order))
