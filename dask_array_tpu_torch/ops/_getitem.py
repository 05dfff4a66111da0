"""__getitem__ routing: basic slicing, newaxis and fancy indexing.

Port of ``dask_array_tpu/ops/_getitem.py``.  ``None`` entries are split
out and become ``expand_dims`` of the rest; an index of only ints and
slices is a ``Slice``; anything else (integer or boolean arrays, lists,
lazy Arrays) goes to ``ops/_fancy_indexing.py``.  Structured field access
waits for the host lane of odd dtypes (ROADMAP S9).
"""

from __future__ import annotations

from numbers import Integral

import numpy as np

from dask_array_tpu_torch._slicing import Slice, is_basic_index, normalize_index


def _mask_ndim(i):
    """The number of axes a boolean index consumes (0 for anything else)."""
    dt = getattr(i, "dtype", None)
    if dt is None and isinstance(i, list):
        arr = np.asarray(i)
        dt, nd = arr.dtype, arr.ndim
    else:
        nd = getattr(i, "ndim", 0)
    return nd if dt is not None and np.dtype(dt) == bool else 0


def getitem_router(x, index):
    from dask_array_tpu_torch._collection import new_collection

    if isinstance(index, str) or (
        isinstance(index, list) and index and all(isinstance(i, str) for i in index)
    ):
        from dask_array_tpu_torch.ops._structured import field_access

        return field_access(x, index)

    if not isinstance(index, tuple):
        index = (index,)
    if any(_mask_ndim(i) > 1 for i in index):
        from dask_array_tpu_torch.ops._fancy_indexing import leading_mask_getitem

        return leading_mask_getitem(x, index)

    index = normalize_index(index, x.shape)

    # split out newaxes (None)
    if any(i is None for i in index):
        from dask_array_tpu_torch.ops.manipulation import expand_dims

        base_index = tuple(i for i in index if i is not None)
        out = getitem_router(x, base_index) if base_index else x
        # positions of the new axes in the output of the base index
        out_pos = []
        kept = 0
        for i in index:
            if i is None:
                out_pos.append(kept + len(out_pos))
            elif not isinstance(i, Integral):
                kept += 1
        return expand_dims(out, tuple(out_pos))

    if is_basic_index(index):
        if all(i == slice(None) for i in index):
            return new_collection(x.expr)
        return new_collection(Slice(x.expr, index))

    # fancy indexing: int arrays / bool arrays / lists / lazy Arrays
    from dask_array_tpu_torch.ops._fancy_indexing import fancy_getitem

    return fancy_getitem(x, index)
