"""General numpy routines: the first half of the JAX package's
``ops/routines.py``.

Port of the elementwise routines (``where``, ``round``, ``isclose``,
``select``, ``piecewise``, ``choose``, ``tril``/``triu``, ...), the
reductions and shifts (``count_nonzero``, ``ptp``, ``average``, ``diff``,
``ediff1d``), the data-dependent ones (``nonzero``/``flatnonzero``/
``argwhere``, ``compress``, ``extract``), the index builders
(``tril_indices``...) and the grid edits (``broadcast_arrays``,
``unify_chunks``, ``insert``/``delete``/``append``).  Each composes the
port's expressions; the elementwise ones are torch functions with numpy's
dtypes and values (``ops/ufuncs.py::numpy_operands``).  ``nonzero`` has a
data-dependent size: one block of unknown size per block along the first
axis, one host sync each.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dask_array_tpu_torch._blockwise import elemwise
from dask_array_tpu_torch._chunks import common_blockdim, computable, moved, numpy_dtype, to_compute, validate_axis
from dask_array_tpu_torch._executor import BlockView
from dask_array_tpu_torch._expr import ArrayExpr
from dask_array_tpu_torch.ops._fancy_indexing import NAN, count_sync
from dask_array_tpu_torch.ops.ufuncs import (
    _device_of,
    _numpy_function,
    as_operand,
    numpy_operands,
    numpy_result,
    rint_,
)


def _asarray(x):
    from dask_array_tpu_torch.ops._from_array import asarray

    return asarray(x)


def _spec(a):
    """An operand as numpy's promotion reads it: a held block by its numpy
    dtype, anything else as it is."""
    return numpy_dtype(a.dtype) if isinstance(a, torch.Tensor) else a


# ---------------------------------------------------------------------------
# elementwise routines
# ---------------------------------------------------------------------------


@_numpy_function(np.where, name="where_")
def where_(cond, x, y):
    """numpy's where: x and y in their promoted dtype (a Python int out of
    an integer type's range wraps, as numpy's where wraps it)."""
    device = _device_of((cond, x, y))
    _, (x, y) = numpy_operands(x, y, device=device)
    if not isinstance(cond, torch.Tensor):
        cond = torch.tensor(bool(cond), device=device)
    elif cond.is_complex():
        cond = cond != 0
    else:
        cond = to_compute(cond, np.bool_)
    return torch.where(cond, x, y)


def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition)
    if x is None or y is None:
        raise ValueError("either both or neither of x and y should be given")
    from dask_array_tpu_torch._collection import Array

    shapes = [np.shape(condition), np.shape(x), np.shape(y)]
    if not isinstance(condition, Array) and np.ndim(condition) == 0 and not any(
        s != s for sh in shapes for s in sh
    ):
        # a scalar truth: the chosen branch itself, promoted and broadcast
        # as numpy would
        out_dtype = np.result_type(getattr(x, "dtype", x), getattr(y, "dtype", y))
        c = _asarray(x if condition else y)
        if c.dtype != out_dtype:
            c = c.astype(out_dtype)
        shape = np.broadcast_shapes(*shapes)
        if c.shape != shape:
            from dask_array_tpu_torch.ops.manipulation import broadcast_to

            c = broadcast_to(c, shape)
        return c
    return elemwise(where_, condition, x, y)


@_numpy_function(np.round, name="round_")
def round_(x, decimals=0):
    """numpy's round: for floats x * 10**d, rint, / 10**d in x's dtype
    (÷ then × for d < 0); an integer with d < 0 through float64; complex
    parts apart."""
    if x.is_complex():
        return torch.complex(round_(x.real, decimals), round_(x.imag, decimals))
    dt = numpy_result(np.round, x, decimals=decimals)
    kind = numpy_dtype(x.dtype).kind
    if decimals == 0:
        return rint_(to_compute(x, dt)) if dt.kind == "f" else x
    if kind in "iu":
        if decimals > 0:
            return x
        t = to_compute(x, np.float64)
    else:
        t = x
    f = torch.tensor(10.0 ** abs(decimals), dtype=t.dtype, device=t.device)
    return torch.round(t * f) / f if decimals > 0 else torch.round(t / f) * f


def round(a, decimals=0):
    return elemwise(round_, a, decimals=decimals)


around = round


@_numpy_function(np.isclose, name="isclose_")
def isclose_(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    """numpy's isclose step for step: b taken in its float type,
    |a - b| <= atol + rtol * |b| where b is finite, or a == b."""
    device = _device_of((a, b))
    yd = np.result_type(_spec(b), 1.0)
    d = np.result_type(_spec(a), yd)
    y = as_operand(b, yd, device)
    x = as_operand(a, d, device)
    yy = y.to(x.dtype)
    out = ((x - yy).abs() <= atol + rtol * y.abs()) & torch.isfinite(y) | (x == yy)
    if equal_nan:
        out = out | (torch.isnan(x) & torch.isnan(yy))
    return out


def isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return elemwise(isclose_, a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan).all()


def iscomplexobj(x):
    return np.issubdtype(getattr(x, "dtype", np.asarray(x).dtype), np.complexfloating)


def isnull(values):
    """NaN test with pandas' meaning (non-float dtypes are never null)."""
    v = _asarray(values)
    if v.dtype.kind in "fc":
        from dask_array_tpu_torch.ops.ufuncs import isnan

        return isnan(v)
    from dask_array_tpu_torch.ops.creation import zeros

    return zeros(v.shape, dtype=bool, chunks=v.chunks)


def notnull(values):
    return ~isnull(values)


def result_type(*arrays_and_dtypes):
    return np.result_type(*[
        a.dtype if isinstance(getattr(a, "dtype", None), np.dtype) else a for a in arrays_and_dtypes
    ])


def ndim(a):
    return a.ndim if hasattr(a, "ndim") else np.asarray(a).ndim


def shape(a):
    return a.shape if hasattr(a, "shape") else np.asarray(a).shape


def select(condlist, choicelist, default=0):
    """numpy's select: the first true condition's choice, ``default``
    where none is; nested ``where`` from the last condition back."""
    if len(condlist) != len(choicelist):
        raise ValueError("list of cases must be same length as list of conditions")
    if len(condlist) == 0:
        raise ValueError("select with an empty condition list is not possible")
    conds = [_asarray(c) for c in condlist]
    choices = [_asarray(c) for c in choicelist]
    for i, c in enumerate(conds):
        if c.dtype != bool:
            raise TypeError(f"invalid entry {i} in condlist: should be boolean ndarray")
    dtype = np.select([np.ones(1, bool)] * len(conds), [np.ones(1, c.dtype) for c in choices], default).dtype
    out = np.asarray(default).astype(dtype)[()]
    for c, ch in reversed(list(zip(conds, choices))):
        out = where(c, ch.astype(dtype), out)
    return out.astype(dtype)


def _piecewise_block(block, *conds, funclist=(), args=(), kw=()):
    kw = dict(kw)
    conds = list(conds)
    if len(funclist) == len(conds) + 1:
        # numpy's "otherwise": where no condition holds
        none = ~functools.reduce(torch.logical_or, conds) if conds else torch.ones_like(block, dtype=torch.bool)
        conds.append(none)
    y = torch.zeros_like(computable(block))
    for cond, fn in zip(conds, funclist):
        val = fn(block, *args, **kw) if callable(fn) else fn
        y = torch.where(cond, val, y)
    return y


def piecewise(x, condlist, funclist, *args, **kw):
    """numpy's piecewise: each function (of torch blocks) where its
    condition holds, a later condition over an earlier one; 0 elsewhere."""
    from dask_array_tpu_torch.ops._map_blocks import map_blocks

    x = _asarray(x)
    if not isinstance(condlist, (list, tuple)):
        condlist = [condlist]
    conds = [_asarray(c) for c in condlist]
    return map_blocks(_piecewise_block, x, *conds, dtype=x.dtype, funclist=tuple(funclist), args=tuple(args),
                      kw=tuple(sorted(kw.items())))


def _choose_meta(a, *choices):
    return np.choose(np.zeros(np.shape(a), np.int64), choices)


@_numpy_function(_choose_meta, name="choose_")
def choose_(a, *choices):
    """numpy's choose (mode "raise"): the index checked with one min/max
    reduction and one host sync, then one gather from the stacked choices."""
    device = _device_of((a,) + choices)
    _, cs = numpy_operands(*choices, device=device)
    idx = computable(a).to(torch.int64)
    shape = torch.broadcast_shapes(idx.shape, *(c.shape for c in cs))
    if idx.numel():
        lo, hi = torch.stack(torch.aminmax(idx)).tolist()
        count_sync()
        if lo < 0 or hi >= len(cs):
            raise ValueError("invalid entry in choice array")
    stacked = torch.stack([c.expand(shape) for c in cs])
    return torch.gather(stacked, 0, idx.expand(shape).unsqueeze(0)).squeeze(0)


def choose(a, choices):
    return elemwise(choose_, a, *choices)


def compress(condition, a, axis=None):
    from dask_array_tpu_torch._collection import Array
    from dask_array_tpu_torch.ops._fancy_indexing import take

    a = _asarray(a)
    if axis is None:
        a = a.ravel()
        axis = 0
    axis = validate_axis(axis, a.ndim)
    if isinstance(condition, Array):
        if condition.ndim != 1:
            raise ValueError("condition must be one dimensional")
        n = condition.shape[0]
        if n > a.shape[axis]:
            raise IndexError("condition is longer than the input size")
        if n < a.shape[axis]:
            a = a[tuple(slice(0, n) if ax == axis else slice(None) for ax in range(a.ndim))]
        return a[tuple(condition.astype(bool) if ax == axis else slice(None) for ax in range(a.ndim))]
    condition = np.asarray(condition)
    if condition.ndim != 1:
        raise ValueError("condition must be one dimensional")
    if len(condition) > a.shape[axis]:
        raise IndexError("condition is longer than the input size")
    return take(a, np.nonzero(condition)[0], axis=axis)


def extract(condition, arr):
    from dask_array_tpu_torch._collection import Array
    from dask_array_tpu_torch.ops._fancy_indexing import take

    arr = _asarray(arr).ravel()
    if isinstance(condition, Array):
        return arr[condition.ravel().astype(bool)]
    return take(arr, np.nonzero(np.ravel(condition))[0])


@_numpy_function(np.tril, name="tril_")
def tril_(x, k=0):
    return moved(torch.tril, x, k)


@_numpy_function(np.triu, name="triu_")
def triu_(x, k=0):
    return moved(torch.triu, x, k)


def tril(m, k=0):
    """The lower triangle of the last two axes.  The element's global
    position decides, so this stays an ``Elemwise`` built on the dense
    tensor (a per-block build would need the block's offset)."""
    m = _asarray(m)
    if m.ndim < 2:
        raise ValueError("tril needs an array of at least 2 dimensions")
    return elemwise(tril_, m, k=k)


def triu(m, k=0):
    m = _asarray(m)
    if m.ndim < 2:
        raise ValueError("triu needs an array of at least 2 dimensions")
    return elemwise(triu_, m, k=k)


def tril_indices(n, k=0, m=None, chunks="auto"):
    from dask_array_tpu_torch.ops._from_array import from_array

    rows, cols = np.tril_indices(n, k=k, m=m)
    return from_array(rows, chunks=chunks), from_array(cols, chunks=chunks)


def tril_indices_from(arr, k=0):
    if arr.ndim != 2:
        raise ValueError("input array must be 2-d")
    return tril_indices(arr.shape[0], k=k, m=arr.shape[1])


def triu_indices(n, k=0, m=None, chunks="auto"):
    from dask_array_tpu_torch.ops._from_array import from_array

    rows, cols = np.triu_indices(n, k=k, m=m)
    return from_array(rows, chunks=chunks), from_array(cols, chunks=chunks)


def triu_indices_from(arr, k=0):
    if arr.ndim != 2:
        raise ValueError("input array must be 2-d")
    return triu_indices(arr.shape[0], k=k, m=arr.shape[1])


# ---------------------------------------------------------------------------
# reductions and shifts
# ---------------------------------------------------------------------------


def count_nonzero(a, axis=None):
    return _asarray(a).astype(bool).sum(axis=axis, dtype=np.intp)


def ptp(a, axis=None):
    a = _asarray(a)
    return a.max(axis=axis) - a.min(axis=axis)


def average(a, axis=None, weights=None, returned=False, keepdims=False):
    a = _asarray(a)
    if weights is None:
        from dask_array_tpu_torch.ops.reductions import _count

        avg = a.mean(axis=axis, keepdims=keepdims)
        scl = _count(a, axis, keepdims=keepdims, split_every=None, dtype=avg.dtype)
    else:
        w = _asarray(weights)
        if w.shape != a.shape:
            # numpy's validation, its messages verbatim
            if axis is None:
                raise TypeError("Axis must be specified when shapes of a and weights differ.")
            if w.ndim != 1:
                raise TypeError("1D weights expected when shapes of a and weights differ.")
            if w.shape[0] != a.shape[validate_axis(axis, a.ndim)]:
                raise ValueError("Length of weights not compatible with specified axis.")
        if w.ndim != a.ndim and axis is not None and w.ndim == 1:
            shape_w = [1] * a.ndim
            shape_w[validate_axis(axis, a.ndim)] = w.shape[0]
            w = w.reshape(tuple(shape_w))
        scl = w.sum(axis=axis, keepdims=keepdims)
        avg = (a * w).sum(axis=axis, keepdims=keepdims) / scl
    if returned:
        if scl.shape != avg.shape:
            from dask_array_tpu_torch.ops.manipulation import broadcast_to

            scl = broadcast_to(scl, avg.shape)
        return avg, scl
    return avg


def diff(a, n=1, axis=-1, prepend=None, append=None):
    """numpy's diff: differences of neighbours (``not_equal`` for bool),
    ``n`` times, after ``prepend``/``append`` (broadcast like numpy's)."""
    from dask_array_tpu_torch.ops.ufuncs import not_equal

    a = _asarray(a)
    n = int(n)
    if n < 0:
        raise ValueError(f"order must be non-negative but got {n}")
    if n == 0:
        return a  # numpy returns the input at order 0, before prepend/append
    axis = validate_axis(axis, a.ndim)
    parts = [_asarray(p) for p in (prepend, a, append) if p is not None]
    if len(parts) > 1:
        from dask_array_tpu_torch.ops.manipulation import broadcast_to
        from dask_array_tpu_torch.ops.stacking import concatenate

        def fit(p):
            if p.ndim == a.ndim:
                return p
            target = tuple(1 if i == axis else s for i, s in enumerate(a.shape))
            return broadcast_to(p.reshape((1,) * (a.ndim - p.ndim) + p.shape) if p.ndim else p, target)

        a = concatenate([fit(p) for p in parts], axis=axis)
    for _ in range(n):
        hi = tuple(slice(1, None) if i == axis else slice(None) for i in range(a.ndim))
        lo = tuple(slice(None, -1) if i == axis else slice(None) for i in range(a.ndim))
        a = not_equal(a[hi], a[lo]) if a.dtype == bool else a[hi] - a[lo]
    return a


def ediff1d(ary, to_end=None, to_begin=None):
    from dask_array_tpu_torch.ops.stacking import concatenate

    ary = _asarray(ary).ravel()
    out = diff(ary)
    # numpy casts to_begin and to_end to the result's dtype
    parts = [_asarray(p).ravel().astype(out.dtype) for p in (to_begin,) if p is not None]
    parts.append(out)
    parts.extend(_asarray(p).ravel().astype(out.dtype) for p in (to_end,) if p is not None)
    return concatenate(parts) if len(parts) > 1 else parts[0]


# ---------------------------------------------------------------------------
# data-dependent sizes: nonzero
# ---------------------------------------------------------------------------


def _nonzero_bands(array, view):
    """The coordinates of the nonzero elements of each block along the first
    axis, in C order ((count, ndim) int64 tensors), one host sync each.  A
    root that assembled densely over unknown sizes is one band."""
    bounds = array.chunks[0]
    if view._blocks is not None and array.ndim == 1:
        parts, off = [], 0
        for k in range(len(bounds)):
            b = view.block((k,))
            nz = moved(torch.nonzero, b)
            parts.append(nz + off)
            off += b.shape[0]
            count_sync()
        return parts
    dense = view.dense()
    if any(isinstance(c, float) for c in bounds):
        nz = moved(torch.nonzero, dense)
        count_sync()
        return [nz] + [nz[:0]] * (len(bounds) - 1)
    parts, off = [], 0
    for size in bounds:
        nz = moved(torch.nonzero, dense[off:off + size])
        nz[:, 0] += off
        parts.append(nz)
        off += size
        count_sync()
    return parts


class NonzeroAxis(ArrayExpr):
    """Axis ``axis_out``'s indices of the nonzero elements: one block of
    unknown size per block along the first axis; every axis of one array
    shares one walk through ``BuildContext.shared``."""

    _parameters = ("array", "axis_out")

    @functools.cached_property
    def chunks(self):
        return ((NAN,) * len(self.array.chunks[0]),)

    @property
    def _meta(self):
        return np.empty((0,), dtype=np.intp)

    def _build(self, ctx):
        bands = ctx.shared(f"nonzero-{self.array._name}",
                           lambda: _nonzero_bands(self.array, ctx.build(self.array)))
        return BlockView(self.chunks, blocks={(k,): b[:, self.axis_out] for k, b in enumerate(bands)})


def nonzero(a):
    from dask_array_tpu_torch._collection import new_collection

    a = _asarray(a)
    if a.ndim == 0:
        raise ValueError("Calling nonzero on 0d arrays is not allowed. Use np.atleast_1d(scalar).nonzero() instead.")
    return tuple(new_collection(NonzeroAxis(a.expr, i)) for i in range(a.ndim))


def flatnonzero(a):
    return nonzero(_asarray(a).ravel())[0]


def argwhere(a):
    from dask_array_tpu_torch.ops.stacking import stack

    return stack(nonzero(a), axis=1, allow_unknown_chunksizes=True)


# ---------------------------------------------------------------------------
# grids and edits
# ---------------------------------------------------------------------------


def broadcast_arrays(*args, subok=False):
    from dask_array_tpu_torch.ops.manipulation import broadcast_to

    arrays = [_asarray(a) for a in args]
    shape = np.broadcast_shapes(*[a.shape for a in arrays])
    return [broadcast_to(a, shape) for a in arrays]


def unify_chunks(*args, **kwargs):
    """``unify_chunks(a, 'ij', b, 'jk')`` -> (chunks by label, [arrays rechunked])."""
    if not args:
        return {}, []
    arrays = [_asarray(a) for a in args[::2]]
    inds = [tuple(i) for i in args[1::2]]
    label_chunks: dict = {}
    for a, ind in zip(arrays, inds):
        for pos, lbl in enumerate(ind):
            c = a.chunks[pos]
            prev = label_chunks.get(lbl)
            label_chunks[lbl] = c if prev is None or prev == c else common_blockdim([prev, c])
    out = []
    for a, ind in zip(arrays, inds):
        want = tuple(label_chunks[lbl] for lbl in ind)
        out.append(a.rechunk(want) if want != a.chunks else a)
    return label_chunks, out


def insert(arr, obj, values, axis=None):
    """numpy's insert (a single index inserts the whole ``values`` block;
    several are interleaved at their stable-sorted positions)."""
    from dask_array_tpu_torch.ops.manipulation import broadcast_to, moveaxis
    from dask_array_tpu_torch.ops.stacking import concatenate

    arr = _asarray(arr)
    if axis is None:
        arr = arr.ravel()
        axis = 0
    axis = validate_axis(axis, arr.ndim)
    n = arr.shape[axis]
    if isinstance(obj, slice):
        obj = np.arange(*obj.indices(n))
    obj_arr = np.asarray(obj)
    scalar_obj = obj_arr.ndim == 0
    obj_arr = np.atleast_1d(obj_arr)
    if obj_arr.size and (obj_arr.min() < -n or obj_arr.max() > n):
        bad = obj_arr[(obj_arr < -n) | (obj_arr > n)][0]
        raise IndexError(f"index {int(bad)} is out of bounds for axis {axis} with size {n}")
    obj_arr = np.where(obj_arr < 0, obj_arr + n, obj_arr).astype(np.intp)
    values = _asarray(values).astype(arr.dtype)

    def _axis_slice(lo, hi):
        return tuple(slice(lo, hi) if i == axis else slice(None) for i in range(arr.ndim))

    if obj_arr.size == 1:
        if values.ndim < arr.ndim:
            values = values.reshape((1,) * (arr.ndim - values.ndim) + values.shape)
        if scalar_obj and arr.ndim > 1:
            values = moveaxis(values, 0, axis)
        numnew = values.shape[axis]
        slot = tuple(numnew if i == axis else s for i, s in enumerate(arr.shape))
        if values.shape != slot:
            values = broadcast_to(values, slot)
        pos = int(obj_arr[0])
        parts = ([arr[_axis_slice(0, pos)]] if pos > 0 else []) + [values]
        if pos < n:
            parts.append(arr[_axis_slice(pos, None)])
        return concatenate(parts, axis=axis)

    shape_v = tuple(len(obj_arr) if i == axis else s for i, s in enumerate(arr.shape))
    if values.ndim < arr.ndim and values.ndim:
        values = values.reshape((1,) * (arr.ndim - values.ndim) + values.shape)
    if values.shape != shape_v:
        values = broadcast_to(values, shape_v)
    order = np.argsort(obj_arr, kind="stable")
    parts = []
    pos = 0
    for rank, ins_at in enumerate(np.sort(obj_arr)):
        ins_at = int(ins_at)
        if ins_at > pos:
            parts.append(arr[_axis_slice(pos, ins_at)])
        src = int(order[rank])
        parts.append(values[_axis_slice(src, src + 1)])
        pos = ins_at
    if pos < n:
        parts.append(arr[_axis_slice(pos, None)])
    return concatenate(parts, axis=axis)


def delete(arr, obj, axis=None):
    from dask_array_tpu_torch.ops._fancy_indexing import take

    arr = _asarray(arr)
    if axis is None:
        arr = arr.ravel()
        axis = 0
    axis = validate_axis(axis, arr.ndim)
    n = arr.shape[axis]
    keep = np.ones(n, dtype=bool)
    if isinstance(obj, slice):
        keep[obj] = False
    else:
        obj = np.atleast_1d(np.asarray(obj))
        keep[np.where(obj < 0, obj + n, obj).astype(np.intp)] = False
    return take(arr, np.nonzero(keep)[0], axis=axis)


def append(arr, values, axis=None):
    from dask_array_tpu_torch.ops.stacking import concatenate

    arr = _asarray(arr)
    values = _asarray(values)
    if axis is None:
        return concatenate([arr.ravel(), values.ravel()], axis=0)
    return concatenate([arr, values], axis=validate_axis(axis, arr.ndim))


__all__ = [
    "allclose", "append", "argwhere", "around", "average", "broadcast_arrays", "choose", "compress",
    "count_nonzero", "delete", "diff", "ediff1d", "extract", "flatnonzero", "insert", "isclose",
    "iscomplexobj", "isnull", "ndim", "nonzero", "notnull", "piecewise", "ptp", "result_type", "round",
    "select", "shape", "tril", "tril_indices", "tril_indices_from", "triu", "triu_indices",
    "triu_indices_from", "unify_chunks", "where",
]
