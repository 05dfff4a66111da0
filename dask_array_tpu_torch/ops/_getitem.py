"""__getitem__ routing: basic slicing.

Port of the basic-index route of ``dask_array_tpu/ops/_getitem.py``.
newaxis, field access and fancy indexing wait for a later slice of the
port and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

from dask_array_tpu_torch._slicing import Slice, is_basic_index, normalize_index


def getitem_router(x, index):
    from dask_array_tpu_torch._collection import new_collection

    index = normalize_index(index, x.shape)
    if not is_basic_index(index):
        raise NotImplementedError(
            f"only basic indexing (ints and slices) is ported so far; got {index!r}"
        )
    if all(i == slice(None) for i in index):
        return new_collection(x.expr)
    return new_collection(Slice(x.expr, index))
