"""__setitem__: out-of-place assignment expressions.

Port of ``dask_array_tpu/ops/_setitem.py``.  ``Array.__setitem__`` swaps
the collection's expression for a ``SetItem`` node: the source is never
mutated.  The executor clones the dense tensor and assigns into the clone
(one ``index_put_``, or a ``torch.where`` for a scalar under a boolean
mask).  numpy values and indices are copied when the assignment is made,
as numpy's assignment reads them then; their bounds and shapes are checked
on the host, a lazy index with one min/max reduction and one host sync
before anything is written (an out-of-range scatter on CUDA is a
device-side assert).
"""

from __future__ import annotations

import math
from numbers import Integral

import numpy as np
import torch

from dask_array_tpu_torch._chunks import _SIGNED_TWIN, cast, torch_dtype
from dask_array_tpu_torch._executor import BlockView
from dask_array_tpu_torch._expr import ArrayExpr
from dask_array_tpu_torch._slicing import normalize_index


def _bits(t):
    """uint16/32/64 through the signed type of the width (torch has no
    scatter for them); the same bytes either way."""
    twin = _SIGNED_TWIN.get(t.dtype)
    return t.view(twin) if twin is not None else t


def _is_lazy(i):
    return isinstance(i, tuple) and len(i) == 2 and i[0] == "lazy"


class SetItem(ArrayExpr):
    """``array`` with ``value`` written at ``index``.

    ``index`` is a tuple of ints, slices, numpy integer or boolean arrays
    and ``("lazy", slot)`` markers for lazy index arrays, which are the
    operands after ``value`` (a boolean array stands for as many axes as it
    has).  ``value`` is an expression or a numpy array of the array's dtype.
    """

    _parameters = ("array", "index", "value")

    @property
    def chunks(self):
        return self.array.chunks

    @property
    def _meta(self):
        return self.array._meta

    def _index_tensor(self, ctx, i, axis, dim, device):
        if _is_lazy(i):
            t = ctx.build(self.operands[3 + i[1]]).dense()
            if t.dtype == torch.bool:
                return t
            from dask_array_tpu_torch.ops._fancy_indexing import checked_indices

            return checked_indices(t, dim, axis)
        if isinstance(i, np.ndarray):
            return torch.from_numpy(i).to(device)
        return i

    def _build(self, ctx):
        dense = ctx.build(self.array).dense()
        device = dense.device
        if isinstance(self.value, ArrayExpr):
            val = cast(ctx.build(self.value).dense(), self.dtype)
        else:
            val = torch.from_numpy(self.value).to(device)
        index, axis = [], 0
        for i in self.index:
            t = self._index_tensor(ctx, i, axis, dense.shape[axis], device)
            index.append(t)
            axis += t.ndim if isinstance(t, torch.Tensor) and t.dtype == torch.bool else 1
        masks = [p for p, t in enumerate(index) if isinstance(t, torch.Tensor) and t.dtype == torch.bool]
        if len(masks) == 1 and val.ndim == 0 and all(
            p in masks or (isinstance(t, slice) and t == slice(None)) for p, t in enumerate(index)
        ):
            # a scalar under a boolean mask: one select, no clone
            m = index[masks[0]]
            mask = m.reshape((1,) * masks[0] + m.shape + (1,) * (dense.ndim - masks[0] - m.ndim))
            out = torch.where(mask, _bits(val), _bits(dense))
            return BlockView(self.chunks, dense=out.view(dense.dtype))
        if masks:
            from dask_array_tpu_torch.ops._fancy_indexing import count_sync

            count = int(index[masks[0]].sum())  # the selection's size, one host sync
            count_sync()
            if val.ndim and val.shape[0] not in (1, count):
                raise ValueError(
                    f"NumPy boolean array indexing assignment cannot assign {val.shape[0]} input values to "
                    f"the {count} output values where the mask is true"
                )
        out = _bits(dense).clone()
        index, flip = _ascending(index, dense.shape)
        region = out[tuple(index)]
        v = _bits(val).expand(region.shape) if val.ndim <= region.ndim else _bits(val)
        if flip:
            v = v.flip(flip)
        out[tuple(index)] = v
        return BlockView(self.chunks, dense=out.view(dense.dtype))


def _ascending(index, shape):
    """Descending slices as the same elements ascending, with the output
    axes the value must be flipped along (torch slices take no negative
    step)."""
    out, flip, out_dim = [], [], 0
    for ax, ind in enumerate(index):
        if isinstance(ind, slice) and (ind.step or 1) < 0:
            start, stop, step = ind.indices(shape[ax])
            n = len(range(start, stop, step))
            if n:
                last = start + (n - 1) * step
                out.append(slice(last, start + 1, -step))
                flip.append(out_dim)
            else:
                out.append(slice(0, 0, 1))
        else:
            out.append(ind)
        if not isinstance(ind, Integral):
            out_dim += 1
    return out, flip


def _value_of(value, dtype):
    """A value as numpy assigns it: an Array's expression, or a copy in the
    array's dtype (a Python number out of an integer type's range raises,
    as numpy's assignment does)."""
    from dask_array_tpu_torch._collection import Array

    if isinstance(value, Array):
        return value.expr
    if isinstance(value, (bool, int, float, complex)):
        return np.array(value, dtype=dtype)
    with np.errstate(all="ignore"):
        return np.array(value).astype(dtype)


def setitem(x, index, value):
    from dask_array_tpu_torch._collection import Array, new_collection

    if not isinstance(index, tuple):
        index = (index,)
    index = normalize_index(index, x.shape)
    if any(i is None for i in index):
        raise IndexError("newaxis is not allowed in assignment indices")
    torch_dtype(x.dtype)
    value = _value_of(value, x.dtype)
    lazy = []
    norm = []
    ax = 0
    entries = list(index)
    while entries:
        i = entries.pop(0)
        dim = x.shape[ax]
        nd = 1
        if isinstance(i, Array):
            if i.dtype.kind not in "biu":
                raise IndexError(f"arrays used as indices must be of integer or boolean type, not {i.dtype}")
            norm.append(("lazy", len(lazy)))
            lazy.append(i.expr)
            if i.dtype == bool:
                nd = i.ndim
        elif isinstance(i, (list, np.ndarray)):
            arr = np.array(i)
            if arr.dtype == bool:
                nd = arr.ndim
                if arr.shape != tuple(x.shape[ax:ax + nd]):
                    raise IndexError(
                        f"boolean index shape {arr.shape} did not match indexed array shape {x.shape}"
                    )
            else:
                if arr.size == 0:
                    arr = arr.astype(np.int64)
                if arr.dtype.kind not in "iu":
                    raise IndexError(f"arrays used as indices must be of integer or boolean type, not {arr.dtype}")
                arr = arr.astype(np.int64)
                bad = (arr < -dim) | (arr >= dim)
                if bad.any():
                    raise IndexError(f"index {int(arr[bad][0])} is out of bounds for axis {ax} with size {dim}")
                arr = np.where(arr < 0, arr + dim, arr)
            norm.append(arr)
        else:
            norm.append(i)
        # a k-d mask stands for k axes: drop the k - 1 padding slices
        # normalize_index put at the end for them
        for _ in range(nd - 1):
            if entries and isinstance(entries[-1], slice) and entries[-1] == slice(None):
                entries.pop()
        ax += nd
    index = tuple(norm)

    # a basic index over known dims selects a static region: the value must
    # broadcast into it now, not at compute
    region = []
    basic = True
    for i, dim in zip(index, x.shape):
        if isinstance(dim, float) and math.isnan(dim):
            basic = False
            break
        if isinstance(i, slice):
            region.append(len(range(*i.indices(int(dim)))))
        elif not isinstance(i, Integral):
            basic = False
            break
    vshape = tuple(value.shape)
    if basic and not any(isinstance(s, float) and math.isnan(s) for s in vshape):
        rshape = tuple(region)
        for ax in range(1, len(vshape) + 1):
            v = vshape[-ax]
            if v != 1 and (ax > len(rshape) or v != rshape[-ax]):
                raise ValueError(
                    f"shape mismatch: value array of shape {vshape} could not be broadcast to indexing "
                    f"result of shape {rshape}"
                )
    return new_collection(SetItem(x.expr, index, value, *lazy))
