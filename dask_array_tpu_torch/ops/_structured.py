"""Structured (record) dtypes: field access.

Port of ``dask_array_tpu/ops/_structured.py``.  Records have no torch
dtype, so their blocks stay host numpy on the host lane (``_host.py``):
slicing, concatenation, rechunks and the like move them there.  A field
(``x["a"]``) is numeric: its values go to the device, where everything
after it computes as usual ("field, then arithmetic").  A field list
(``x[["a", "b"]]``) is a record again and stays on the host.
"""

from __future__ import annotations

import functools

import numpy as np

from dask_array_tpu_torch._executor import BlockView, to_device
from dask_array_tpu_torch._expr import ArrayExpr


def _field_dtype(base: np.dtype, names):
    if isinstance(names, str):
        fields = base.fields
        if fields is None or names not in fields:
            raise KeyError(f"field {names!r} not found in dtype {base}; available: {list(fields) if fields else []}")
        return fields[names][0]
    # several fields: numpy's view of the sub-record (a KeyError names a
    # missing one)
    return np.empty(0, dtype=base)[list(names)].dtype


class Field(ArrayExpr):
    """``x['a']`` / ``x[['a', 'b']]`` of a structured array.  A sub-array
    field (``("col1", ("f4", (3, 2)))``) adds its shape as trailing axes,
    as numpy does."""

    _parameters = ("array", "names")

    @functools.cached_property
    def _field_dt(self):
        return _field_dtype(self.array._meta.dtype, self.names)

    @functools.cached_property
    def chunks(self):
        return self.array.chunks + tuple((s,) for s in self._field_dt.shape)

    @functools.cached_property
    def _meta(self):
        dt = self._field_dt
        return np.empty((0,) * (self.array.ndim + len(dt.shape)), dtype=dt.base)

    def _name_prefix(self):
        return "field"

    def _build(self, ctx):
        key = self.names if isinstance(self.names, str) else list(self.names)
        # the field of the assembled records: numpy's concatenation repacks
        # a field list's view dtype (its offsets), so selection comes last
        out = np.asarray(ctx.build(self.array).dense())[key]
        return BlockView(self.chunks, dense=to_device(np.ascontiguousarray(out), ctx.device))


def field_access(x, names):
    """``Field`` of ``x``, its names checked now: a missing field raises
    ``KeyError``, field access on a numeric array ``IndexError``."""
    from dask_array_tpu_torch._collection import new_collection

    expr = x.expr if hasattr(x, "expr") else x
    if np.dtype(expr.dtype).fields is None:
        raise IndexError(f"only structured dtypes support field access; got {expr.dtype}")
    if not isinstance(names, str):
        names = tuple(names)
    _field_dtype(np.dtype(expr.dtype), names)
    return new_collection(Field(expr, names))
