"""General numpy routines: the port of the JAX package's
``ops/routines.py``.

The elementwise routines (``where``, ``round``, ``isclose``, ``select``,
``piecewise``, ``choose``, ``tril``/``triu``, ...), the reductions and
shifts (``count_nonzero``, ``ptp``, ``average``, ``diff``, ``ediff1d``),
the data-dependent ones (``nonzero``/``flatnonzero``/``argwhere``,
``compress``, ``extract``), the index builders (``tril_indices``...) and
the grid edits (``broadcast_arrays``, ``unify_chunks``, ``insert``/
``delete``/``append``); then the statistics (``cov``, ``corrcoef``,
``gradient``), sorting, searching and counting (``unique``, ``union1d``,
``bincount``, ``searchsorted``, ``digitize``, ``isin``, ``topk``/
``argtopk``), ``coarsen``, ``apply_along_axis``/``apply_over_axes`` and
the index math (``ravel_multi_index``, ``unravel_index``).  Each composes
the port's expressions or builds on dense torch tensors with numpy's
dtypes and values: held dtypes compare in numpy's sort order
(``_chunks.order_key``: NaN last, uint64 unsigned, complex lexicographic).
Data-dependent sizes sync with the host once and count it in
``_fancy_indexing.SYNCS`` (``nonzero`` once per block); every index that
reaches a gather is checked first, on the host or with one ``aminmax``.
"""

from __future__ import annotations

import functools
import math
import warnings

import numpy as np
import torch

from dask_array_tpu_torch._blockwise import elemwise
from dask_array_tpu_torch._chunks import (
    INT64_MIN,
    argsort_numpy,
    as_stored,
    cast,
    common_blockdim,
    computable,
    compute_dtype,
    moved,
    numpy_dtype,
    order_key,
    search_numpy,
    signed_bits,
    to_compute,
    torch_dtype,
    validate_axis,
)
from dask_array_tpu_torch._executor import BlockView, iter_block_indices
from dask_array_tpu_torch._expr import ArrayExpr
from dask_array_tpu_torch.kernels.histogram import bincount_counts
from dask_array_tpu_torch.ops._fancy_indexing import NAN, count_sync
from dask_array_tpu_torch.ops.ufuncs import (
    _device_of,
    _numpy_function,
    _numpy_named,
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


where_.narrow_select = True  # a selection: narrow patterns move as they are


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


@_numpy_named(np.isnat)
def _isnat(t):
    """numpy's isnat of datetime ticks: NaT is the int64 minimum."""
    return t == INT64_MIN


_isnat.ticks_aware = True


def isnull(values):
    """NaN test with pandas' meaning (non-float dtypes are never null)."""
    v = _asarray(values)
    if v.dtype.kind in "fc":
        from dask_array_tpu_torch.ops.ufuncs import isnan

        return isnan(v)
    if v.dtype.kind in "Mm":
        return elemwise(_isnat, v)
    from dask_array_tpu_torch.ops.creation import zeros

    return zeros(v.shape, dtype=bool, chunks=v.chunks)


def notnull(values):
    """Element-wise inverse of :func:`isnull`."""
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


# they move elements and write zero bytes (numpy's zeros): a narrow type's
# patterns go through as they are
tril_.narrow_patterns = triu_.narrow_patterns = True


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
    if ary.dtype == bool:  # numpy subtracts neighbours, which bool refuses
        raise TypeError("numpy boolean subtract, the `-` operator, is not supported, use the bitwise_xor, the `^` "
                        "operator, or the logical_xor function instead.")
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
            nz = torch.nonzero(signed_bits(b))
            parts.append(nz + off)
            off += b.shape[0]
            count_sync()
        return parts
    dense = view.dense()
    if any(isinstance(c, float) for c in bounds):
        nz = torch.nonzero(signed_bits(dense))
        count_sync()
        return [nz] + [nz[:0]] * (len(bounds) - 1)
    parts, off = [], 0
    for size in bounds:
        nz = torch.nonzero(signed_bits(dense[off:off + size]))
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


# ---------------------------------------------------------------------------
# statistics: cov, corrcoef, gradient
# ---------------------------------------------------------------------------


def _host_weights(weights, name, n, frequency):
    """numpy's checks of fweights/aweights given as numpy data; a float64
    array.  Lazy weights are checked by dtype and shape only."""
    w = np.asarray(weights, dtype=float)
    if frequency and not np.all(w == np.around(w)):
        raise TypeError("fweights must be integer")
    if w.ndim > 1:
        raise RuntimeError(f"cannot handle multidimensional {name}")
    if w.shape[0] != n:
        raise RuntimeError(f"incompatible numbers of samples and {name}")
    if np.any(w < 0):
        raise ValueError(f"{name} cannot be negative")
    return w


def _lazy_weights(weights, name, n, frequency):
    w = _asarray(weights)
    if w.ndim > 1:
        raise RuntimeError(f"cannot handle multidimensional {name}")
    if w.shape[0] != n:
        raise RuntimeError(f"incompatible numbers of samples and {name}")
    if frequency and w.dtype.kind not in "iub":
        raise TypeError("fweights must be integer")
    return w.astype(np.float64)


def cov(m, y=None, rowvar=True, bias=False, ddof=None, fweights=None, aweights=None, *, dtype=None):
    """numpy's covariance, step for step: the variables in numpy's dtype
    (float64 for real input), centred by their (weighted) means, one
    ``dot(Xc, conj(Xc * w).T)`` (its transpose is the transpose kernel's,
    a row of weights the scale kernel's), times ``1 / fact``.  Weights
    given as numpy data are checked and normalised on the host as numpy
    does; lazy weights by dtype and shape only."""
    from dask_array_tpu_torch._collection import Array
    from dask_array_tpu_torch.ops._from_array import from_array
    from dask_array_tpu_torch.ops.linalg import dot
    from dask_array_tpu_torch.ops.stacking import concatenate
    from dask_array_tpu_torch.ops.ufuncs import conj

    if ddof is not None and ddof != int(ddof):
        raise ValueError("ddof must be integer")
    m = _asarray(m)
    if m.ndim > 2:
        raise ValueError("m has more than 2 dimensions")
    if y is not None:
        y = _asarray(y)
        if y.ndim > 2:
            raise ValueError("y has more than 2 dimensions")
    if dtype is None:
        dtype = np.result_type(m.dtype, np.float64) if y is None else np.result_type(m.dtype, y.dtype, np.float64)

    def rows(a):
        a = a.astype(dtype)
        a = a if a.ndim == 2 else a.reshape((1, -1))
        return a.T if not rowvar and a.shape[0] != 1 else a

    X = rows(m)
    if X.shape[0] == 0:
        return from_array(np.array([]).reshape(0, 0))
    if y is not None:
        X = concatenate([X, rows(y)], axis=0)
    n = X.shape[1]
    if ddof is None:
        ddof = 1 if not bias else 0
    ddof = int(ddof)

    lazy = isinstance(fweights, Array) or isinstance(aweights, Array)
    take_weights = _lazy_weights if lazy else _host_weights
    fw = None if fweights is None else take_weights(fweights, "fweights", n, True)
    aw = None if aweights is None else take_weights(aweights, "aweights", n, False)
    w = fw if aw is None else (aw if fw is None else fw * aw)

    if w is None:
        fact = n - ddof
        mean_ = X.mean(axis=1, keepdims=True)
    else:
        # the same arithmetic on numpy weights (on the host) or lazy ones
        w_sum = w.sum()
        if ddof == 0:
            fact = w_sum
        elif aw is None:
            fact = w_sum - ddof
        else:
            fact = w_sum - ddof * (w * aw).sum() / w_sum
        w = w.reshape((1, n)) if lazy else from_array(w.reshape((1, n)), chunks=(1, X.chunks[1]))
        mean_ = (X * w).sum(axis=1, keepdims=True) / w_sum
    if not isinstance(fact, Array) and fact <= 0:
        warnings.warn("Degrees of freedom <= 0 for slice", RuntimeWarning, stacklevel=2)
        fact = 0.0
    Xc = X - mean_
    c = dot(Xc, conj(Xc if w is None else Xc * w).T)
    if isinstance(fact, Array):
        c = c * (1.0 / fact)
    else:
        with np.errstate(divide="ignore"):
            c = c * np.true_divide(1, fact)
    return c.reshape(()) if c.shape == (1, 1) else c


def corrcoef(x, y=None, rowvar=True, *, dtype=None):
    """numpy's corrcoef: the covariance divided by each row's and each
    column's standard deviation in turn, clipped to [-1, 1]."""
    from dask_array_tpu_torch.ops.creation import diagonal
    from dask_array_tpu_torch.ops.ufuncs import clip, imag, real, sqrt

    c = cov(x, y, rowvar, dtype=dtype)
    if c.ndim == 0:
        return c / c
    stddev = sqrt(real(diagonal(c)))
    c = c / stddev[:, None]
    c = c / stddev[None, :]
    if c.dtype.kind == "c":
        return elemwise(torch.complex, clip(real(c), -1, 1), clip(imag(c), -1, 1))
    return clip(c, -1, 1)


def gradient_axis_(t, axis=0, dx=1.0, edge_order=1):
    """numpy's gradient of a held block along one axis, step for step: the
    differences in the block's own float dtype, each product or quotient
    by the spacing in numpy's dtype for that operand (a Python number is
    weak, a numpy scalar or array strong), the result stored in the
    block's float dtype."""
    otype = _gradient_dtype(numpy_dtype(t.dtype))
    f = torch.movedim(to_compute(t, otype), axis, 0)
    device = f.device
    out = torch.empty_like(f)
    uniform = np.ndim(dx) == 0

    def lin(coefs, parts):
        # sum of coefficient * slice, each product in numpy's dtype
        dt = np.result_type(otype, *coefs)
        total = None
        for c, p in zip(coefs, parts):
            if np.ndim(c):
                c = np.asarray(c).reshape((-1,) + (1,) * (f.ndim - 1))
            term = as_operand(c, dt, device) * p.to(compute_dtype(dt))
            total = term if total is None else total + term
        return total

    def quot(num, den):
        dt = np.result_type(otype, den)
        num = num.to(compute_dtype(dt))
        if dt.kind != "c":
            return num / as_operand(den, dt, device)
        # numpy's complex division by a real divisor (Smith's form, the
        # divisor's imaginary part 0): a NaN part spoils both parts
        d = as_operand(den, dt, device).real
        rat = 0.0 / d
        scl = 1.0 / d
        return torch.complex((num.real + num.imag * rat) * scl, (num.imag - num.real * rat) * scl)

    if uniform:
        out[1:-1] = quot(f[2:] - f[:-2], 2.0 * dx)
    else:
        dx1, dx2 = dx[:-1], dx[1:]
        a = -dx2 / (dx1 * (dx1 + dx2))
        b = (dx2 - dx1) / (dx1 * dx2)
        c = dx1 / (dx2 * (dx1 + dx2))
        out[1:-1] = lin([a, b, c], [f[:-2], f[1:-1], f[2:]])
    if edge_order == 1:
        out[0] = quot(f[1] - f[0], dx if uniform else dx[0])
        out[-1] = quot(f[-1] - f[-2], dx if uniform else dx[-1])
    else:
        if uniform:
            a, b, c = -1.5 / dx, 2.0 / dx, -0.5 / dx
        else:
            dx1, dx2 = dx[0], dx[1]
            a = -(2.0 * dx1 + dx2) / (dx1 * (dx1 + dx2))
            b = (dx1 + dx2) / (dx1 * dx2)
            c = -dx1 / (dx2 * (dx1 + dx2))
        out[0] = lin([a, b, c], [f[0], f[1], f[2]])
        if uniform:
            a, b, c = 0.5 / dx, -2.0 / dx, 1.5 / dx
        else:
            dx1, dx2 = dx[-2], dx[-1]
            a = dx2 / (dx1 * (dx1 + dx2))
            b = -(dx2 + dx1) / (dx1 * dx2)
            c = (2.0 * dx2 + dx1) / (dx2 * (dx1 + dx2))
        out[-1] = lin([a, b, c], [f[-3], f[-2], f[-1]])
    return torch.movedim(out, 0, axis)


def _gradient_dtype(dt):
    if dt.kind == "b":
        raise TypeError("numpy boolean subtract, the `-` operator, is not supported, use the bitwise_xor, the `^` "
                        "operator, or the logical_xor function instead.")
    return np.dtype(np.float64) if dt.kind in "iu" else dt


class GradientAxis(ArrayExpr):
    """numpy's gradient along one axis, built on the dense tensor."""

    _parameters = ("array", "axis", "dx", "edge_order")

    @property
    def chunks(self):
        return self.array.chunks

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * self.array.ndim, dtype=_gradient_dtype(self.array.dtype))

    def _build(self, ctx):
        dense = ctx.build(self.array).dense()
        out = gradient_axis_(dense, self.axis, self.dx, self.edge_order)
        return BlockView(self.chunks, dense=as_stored(out, self.dtype))


def gradient(f, *varargs, axis=None, edge_order=1):
    """numpy's gradient: one array per axis (a tuple for several), the
    spacing a number or the coordinates along each axis (differences of
    constant coordinates become one number, as in numpy)."""
    from dask_array_tpu_torch._collection import new_collection

    f = _asarray(f)
    _gradient_dtype(f.dtype)
    if axis is None:
        axes = tuple(range(f.ndim))
    else:
        axes = np.lib.array_utils.normalize_axis_tuple(axis, f.ndim)
    n = len(varargs)
    if n == 0:
        spacing = [1.0] * len(axes)
    elif n == 1 and np.ndim(varargs[0]) == 0:
        spacing = list(varargs) * len(axes)
    elif n == len(axes):
        spacing = []
        for ax, d in zip(axes, varargs):
            d = np.asanyarray(d)
            if d.ndim == 0:
                spacing.append(varargs[len(spacing)])
                continue
            if d.ndim != 1:
                raise ValueError("distances must be either scalars or 1d")
            if len(d) != f.shape[ax]:
                raise ValueError("when 1d, distances must match the length of the corresponding dimension")
            if d.dtype.kind in "iu":
                d = d.astype(np.float64)
            diffx = np.diff(d)
            spacing.append(diffx[0] if (diffx == diffx[0]).all() else diffx)
    else:
        raise TypeError("invalid number of arguments")
    if edge_order > 2:
        raise ValueError("'edge_order' greater than 2 not supported")
    for ax in axes:
        if f.shape[ax] < edge_order + 1:
            raise ValueError("Shape of array too small to calculate a numerical gradient, at least (edge_order + 1) "
                             "elements are required.")
    out = tuple(new_collection(GradientAxis(f.expr, ax, dx, int(edge_order))) for ax, dx in zip(axes, spacing))
    return out[0] if len(out) == 1 else out


# ---------------------------------------------------------------------------
# sorting, searching and counting
# ---------------------------------------------------------------------------


def _unique_groups(x):
    """numpy 2's unique of a flat held block as groups: (the stable
    permutation into numpy's order, the mask of each group's first element,
    the starts of the groups), NaNs folded into one group; the number of
    groups comes to the host in one sync.  A real block's groups are runs
    of equal order keys (one NaN key, -0.0 the key of 0.0); a complex
    block's, runs of equal values or of values with a NaN part."""
    n = x.numel()
    if x.is_complex():
        perm = argsort_numpy(x)
        s = x[perm]
        same = (s[1:] == s[:-1]) | (torch.isnan(s[1:]) & torch.isnan(s[:-1]))
    else:
        key, perm = torch.sort(order_key(x), stable=True)
        same = key[1:] == key[:-1]
    first = torch.cat([torch.ones(min(n, 1), dtype=torch.bool, device=x.device), ~same])
    starts = torch.nonzero(first).reshape(-1)
    count_sync()
    return perm, first, starts


class Unique(ArrayExpr):
    """One output of ``unique`` (values, indices, inverse or counts); the
    outputs of one array share one sort and one sync per walk, and each
    forms only itself.  The sizes are data-dependent (unknown chunks) but
    the inverse's."""

    _parameters = ("array", "which")

    @functools.cached_property
    def chunks(self):
        size = self.array.size
        if self.which == "inverse" and not (isinstance(size, float) and np.isnan(size)):
            return ((int(size),),)
        return ((NAN,),)

    @functools.cached_property
    def _meta(self):
        return np.empty((0,), dtype=self.array.dtype if self.which == "values" else np.intp)

    def _build(self, ctx):
        x = ctx.build(self.array).dense().reshape(-1)
        perm, first, starts = ctx.shared(f"unique-{self.array._name}", lambda: _unique_groups(x))
        if self.which == "inverse":
            inverse = torch.empty(x.numel(), dtype=torch.int64, device=x.device)
            inverse[perm] = torch.cumsum(first, 0) - 1
            return BlockView(self.chunks, dense=inverse)
        if self.which == "values":
            out = moved(lambda v: v[perm[starts]], x)
        elif self.which == "indices":
            out = perm[starts]
        else:
            out = torch.diff(starts, append=torch.tensor([x.numel()], device=x.device))
        return BlockView(self.chunks, blocks={(0,): out})


def unique(ar, return_index=False, return_inverse=False, return_counts=False):
    from dask_array_tpu_torch._collection import new_collection

    ar = _asarray(ar)
    out = [new_collection(Unique(ar.expr, "values"))]
    for flag, which in ((return_index, "indices"), (return_inverse, "inverse"), (return_counts, "counts")):
        if flag:
            out.append(new_collection(Unique(ar.expr, which)))
    return out[0] if len(out) == 1 else tuple(out)


def union1d(ar1, ar2):
    from dask_array_tpu_torch.ops.stacking import concatenate

    return unique(concatenate([_asarray(ar1).ravel(), _asarray(ar2).ravel()], axis=0))


class Bincount(ArrayExpr):
    """numpy's bincount: its length ``max(x.max() + 1, minlength)`` comes
    to the host with the minimum in one sync (a negative value raises
    numpy's ValueError, before any count); the counts are K2's direct mode
    (``kernels/histogram.py::bincount_counts``), weights added in float64."""

    _parameters = ("array", "weights", "minlength")

    @property
    def chunks(self):
        return ((NAN,),)

    @functools.cached_property
    def _meta(self):
        if self.weights is None:
            return np.empty((0,), dtype=np.intp)
        return np.empty((0,), dtype=np.bincount(np.zeros(1, np.intp), weights=np.ones(1, self.weights.dtype)).dtype)

    def _build(self, ctx):
        x = computable(ctx.build(self.array).dense()).to(torch.int64)
        length = self.minlength
        if x.numel():
            lo, hi = torch.stack(torch.aminmax(x)).tolist()
            count_sync()
            if lo < 0:
                raise ValueError("'list' argument must have no negative elements")
            length = max(hi + 1, length)
        w = None if self.weights is None else to_compute(ctx.build(self.weights).dense(), np.float64)
        out = bincount_counts(x, length, w)
        return BlockView(self.chunks, blocks={(0,): out.to(compute_dtype(self.dtype))})


def bincount(x, weights=None, minlength=0, split_every=None):
    from dask_array_tpu_torch._collection import new_collection

    x = _asarray(x)
    if x.ndim != 1:
        raise ValueError("object too deep for desired array" if x.ndim > 1 else "object of too small depth for "
                         "desired array")
    if not np.can_cast(x.dtype, np.intp, "safe"):
        raise TypeError(f"Cannot cast array data from {x.dtype!r} to dtype('int64') according to the rule 'safe'")
    if minlength < 0:
        raise ValueError("'minlength' must not be negative")
    w = None
    if weights is not None:
        w = _asarray(weights)
        if w.shape != x.shape:
            raise ValueError("The weights and list don't have the same length.")
        w = w.expr
    return new_collection(Bincount(x.expr, w, int(minlength)))


class Searchsorted(ArrayExpr):
    """numpy's searchsorted of a 1-D array (permuted by ``sorter`` first,
    which is checked like an index, one sync, before any gather)."""

    _parameters = ("array", "values", "side", "sorter")

    @property
    def chunks(self):
        return self.values.chunks

    @property
    def _meta(self):
        return np.empty((0,) * self.values.ndim, dtype=np.intp)

    def _build(self, ctx):
        a = ctx.build(self.array).dense()
        v = ctx.build(self.values).dense()
        if self.sorter is not None:
            idx = computable(ctx.build(self.sorter).dense()).to(torch.int64)
            if idx.numel():
                lo, hi = torch.stack(torch.aminmax(idx)).tolist()
                count_sync()
                if lo < 0 or hi >= a.shape[0]:
                    raise ValueError("Sorter index out of range.")
            a = moved(torch.index_select, a, 0, idx)
        return BlockView(self.chunks, dense=search_numpy(a, v, self.side == "right"))


def searchsorted(a, v, side="left", sorter=None):
    from dask_array_tpu_torch._collection import new_collection

    a, v = _asarray(a), _asarray(v)
    if a.ndim != 1:
        raise ValueError("Input to searchsorted must be 1-D")
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right' (got {side!r})")
    sorter_expr = None
    if sorter is not None:
        sorter = _asarray(sorter)
        if sorter.shape != a.shape:
            raise ValueError("sorter.size must equal a.size")
        if sorter.dtype.kind not in "iu":
            raise TypeError("sorter must only contain integers")
        sorter_expr = sorter.expr
    return new_collection(Searchsorted(a.expr, v.expr, side, sorter_expr))


def digitize(x, bins, right=False):
    """numpy's digitize: numpy checks ``bins`` (monotonic, 1-D), then a
    ``searchsorted`` of x into them (reversed when they decrease); the
    bins reach the device as one leaf."""
    from dask_array_tpu_torch.ops._from_array import from_array

    x = _asarray(x)
    bins = np.asarray(bins)
    np.digitize(np.zeros(0, x.dtype), bins, right=right)  # numpy's refusals
    side = "left" if right else "right"
    if len(bins) > 1 and bins[0] > bins[-1]:
        return (len(bins) - searchsorted(from_array(bins[::-1].copy(), chunks=-1), x, side=side)).astype(np.intp)
    return searchsorted(from_array(bins, chunks=-1), x, side=side)


def isin_(element, test, invert=False):
    """numpy's isin of held blocks: equality in their common dtype (NaN is
    in nothing, -0.0 is 0.0).  Real values: each element's order key looked
    up in the sorted keys of the test elements (one ``searchsorted``);
    complex values as pairs of parts."""
    dt = np.result_type(numpy_dtype(element.dtype), numpy_dtype(test.dtype))
    e, t = cast(element, dt), cast(test, dt).reshape(-1)
    if dt.kind != "c":
        if not t.numel():
            out = torch.zeros(e.shape, dtype=torch.bool, device=e.device)
        else:
            keys = torch.sort(order_key(t)).values
            ke = order_key(e)
            out = keys[torch.searchsorted(keys, ke).clamp(max=keys.numel() - 1)] == ke
            if dt.kind == "f":
                out &= ~torch.isnan(e)
    else:
        e, t = to_compute(e, dt), to_compute(t, dt)
        # each value as the pair of its parts' order keys (integers: NaN
        # and -0.0 canonical), numbered by one unique of the pairs
        flat = e.reshape(-1)
        both = torch.cat([flat, t])
        pairs = torch.stack([order_key(both.real), order_key(both.imag)], dim=1)
        _, ids = torch.unique(pairs, dim=0, return_inverse=True)
        out = (torch.isin(ids[:flat.numel()], ids[flat.numel():]) & ~torch.isnan(flat)).reshape(e.shape)
    return ~out if invert else out


class Isin(ArrayExpr):
    """``isin`` of an array in the elements of another (numpy's test
    elements are a leaf), built on the dense tensors."""

    _parameters = ("array", "test", "invert")

    @property
    def chunks(self):
        return self.array.chunks

    @property
    def _meta(self):
        return np.empty((0,) * self.array.ndim, dtype=bool)

    def _build(self, ctx):
        out = isin_(ctx.build(self.array).dense(), ctx.build(self.test).dense(), self.invert)
        return BlockView(self.chunks, dense=out)


def isin(element, test_elements, assume_unique=False, invert=False, *, kind=None):
    from dask_array_tpu_torch._collection import Array, new_collection
    from dask_array_tpu_torch.ops._from_array import from_array

    element = _asarray(element)
    if isinstance(test_elements, Array):
        test = test_elements
    else:
        test = from_array(np.asarray(test_elements).ravel(), chunks=-1)
    return new_collection(Isin(element.expr, test.expr, bool(invert)))


class TopK(ArrayExpr):
    """The ``k`` largest elements along ``axis`` (descending), or the
    ``-k`` smallest (ascending) for k < 0, in numpy's sort order (NaN
    largest), as values or indices: one ``torch.topk`` of the order key."""

    _parameters = ("array", "k", "axis", "kind")

    @functools.cached_property
    def chunks(self):
        chunks = list(self.array.chunks)
        chunks[self.axis] = (abs(self.k),)
        return tuple(chunks)

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * self.array.ndim, dtype=self.array.dtype if self.kind == "values" else np.intp)

    def _build(self, ctx):
        from dask_array_tpu_torch._chunk import argtopk, topk

        dense = ctx.build(self.array).dense()
        fn = topk if self.kind == "values" else argtopk
        return BlockView(self.chunks, dense=fn(dense, self.k, self.axis))


def _topk(a, k, axis, kind):
    from dask_array_tpu_torch._collection import new_collection

    a = _asarray(a)
    axis = validate_axis(axis, a.ndim)
    if a.dtype.kind == "c":
        raise TypeError("topk of complex data is not supported")
    k = int(k)
    if abs(k) > a.shape[axis]:
        raise ValueError(f"k={k} is larger than the axis' length {a.shape[axis]}")
    return new_collection(TopK(a.expr, k, axis, kind))


def topk(a, k, axis=-1, split_every=None):
    """The ``k`` largest (``k < 0``: smallest) elements along ``axis``,
    sorted (largest first; smallest first for k < 0)."""
    return _topk(a, k, axis, "values")


def argtopk(a, k, axis=-1, split_every=None):
    """The indices of the ``k`` largest (``k < 0``: smallest) elements
    along ``axis``, in ``topk``'s order."""
    return _topk(a, k, axis, "indices")


# ---------------------------------------------------------------------------
# coarsen
# ---------------------------------------------------------------------------


def aligned_coarsen_chunks(chunks, multiple):
    """Rechunk targets aligned to a coarsening factor: the element count is
    kept, chunks already divisible by ``multiple`` are untouched, at most
    one chunk is added and at most one, the last, stays indivisible."""
    floors = [(c // multiple) * multiple for c in chunks]
    excess = sum(c - f for c, f in zip(chunks, floors))
    # whole multiples of the excess go to the smallest chunks that lost
    # something (never to aligned chunks, which stay as they are)
    donees = sorted((i for i, (c, f) in enumerate(zip(chunks, floors)) if f != c), key=lambda i: floors[i])
    units, remainder = divmod(excess, multiple)
    for k in range(units):
        floors[donees[k]] += multiple
    if remainder:
        floors.append(remainder)
    return tuple(f for f in floors if f > 0)


# a reduction's name -> the port's reduction kind (numpy's dtype rules)
_COARSEN_KINDS = {name: name for name in (
    "sum", "prod", "mean", "min", "max", "any", "all", "nansum", "nanprod", "nanmean", "nanmin", "nanmax")}
_COARSEN_KINDS.update({"amin": "min", "amax": "max"})


class Coarsen(ArrayExpr):
    """``coarsen``: each block reshaped to (n // f, f) per axis and reduced
    over the window axes by the port's typed reduction of that name."""

    _parameters = ("array", "reduction_name", "axes", "trim_excess", "kwargs")
    _defaults = {"kwargs": ()}

    @functools.cached_property
    def chunks(self):
        axes = dict(self.axes)
        out = []
        for ax, c in enumerate(self.array.chunks):
            f = axes.get(ax, 1)
            if f == 1:
                out.append(tuple(c))
            elif self.trim_excess:
                out.append(tuple(x // f for x in c if x // f) or (0,))
            else:
                out.append(tuple(x // f for x in c))
        return tuple(out)

    @functools.cached_property
    def _meta(self):
        np_fn = getattr(np, _COARSEN_KINDS[self.reduction_name])
        with np.errstate(all="ignore"):
            probe = np_fn(np.ones((1, 1), dtype=self.array.dtype), axis=0, **dict(self.kwargs))
        return np.empty((0,) * self.array.ndim, dtype=probe.dtype)

    def _build(self, ctx):
        from dask_array_tpu_torch.ops.reductions import reduce_dense

        view = ctx.build(self.array)
        axes = dict(self.axes)
        kind = _COARSEN_KINDS[self.reduction_name]
        blocks = {}
        for idx in iter_block_indices(view.numblocks):
            b = view.block(idx)
            if self.trim_excess:
                b = b[tuple(slice(0, (s // axes.get(ax, 1)) * axes.get(ax, 1)) for ax, s in enumerate(b.shape))]
            shape = [d for ax, s in enumerate(b.shape) for d in (s // axes.get(ax, 1), axes.get(ax, 1))]
            red = tuple(2 * ax + 1 for ax in range(b.ndim))
            blocks[idx] = reduce_dense(kind, moved(torch.reshape, b, shape), red, False, self.dtype)
        return BlockView(self.chunks, blocks=blocks)


def coarsen(reduction, x, axes, trim_excess=False, **kwargs):
    """Downsample ``x`` by ``reduction`` over non-overlapping windows
    (``axes`` maps an axis to its window).  The reduction is read by name
    (``np.sum``, ``np.mean``, ``np.max``, the port's own ...); chunks are
    first aligned to the windows (``aligned_coarsen_chunks``).  Without
    ``trim_excess`` a window that does not divide its axis raises."""
    from dask_array_tpu_torch._collection import new_collection
    from dask_array_tpu_torch._rechunk import Rechunk

    x = _asarray(x)
    name = getattr(reduction, "__name__", None)
    if name not in _COARSEN_KINDS:
        raise NotImplementedError(f"coarsen reduction {reduction!r} has no torch equivalent")
    axes = {validate_axis(k, x.ndim): int(v) for k, v in axes.items()}
    for ax, f in axes.items():
        if not trim_excess and x.shape[ax] % f != 0:
            raise ValueError(f"Coarsening factor {f} does not divide axis {ax} of size {x.shape[ax]}")
    expr = x.expr
    target = tuple(
        aligned_coarsen_chunks(expr.chunks[ax], axes[ax]) if axes.get(ax, 1) > 1 else expr.chunks[ax]
        for ax in range(x.ndim)
    )
    if target != expr.chunks:
        expr = Rechunk(expr, target)
    return new_collection(Coarsen(expr, name, tuple(sorted(axes.items())), bool(trim_excess),
                                  tuple(sorted(kwargs.items()))))


# ---------------------------------------------------------------------------
# apply along/over axes
# ---------------------------------------------------------------------------


class ApplyAlongAxis(ArrayExpr):
    """``func1d`` over every 1-D slice along ``axis``: ``torch.vmap`` over
    the other axes, or a loop over the slices on the same device where
    vmap refuses the function."""

    _parameters = ("array", "func", "axis", "out_shape", "_dtype", "args", "kwargs")

    @functools.cached_property
    def chunks(self):
        pre = tuple(self.array.chunks[: self.axis])
        post = tuple(self.array.chunks[self.axis + 1:])
        return pre + tuple((s,) for s in self.out_shape) + post

    @property
    def _meta(self):
        return np.empty((0,) * len(self.chunks), dtype=self._dtype)

    def _build(self, ctx):
        dense = computable(ctx.build(self.array).dense())
        kw = dict(self.kwargs)

        def f1d(v):
            return self.func(v, *self.args, **kw)

        moved_ = torch.movedim(dense, self.axis, -1)
        lead = moved_.shape[:-1]
        flat = moved_.reshape(-1, moved_.shape[-1])
        try:
            out = torch.vmap(f1d)(flat)
        except (RuntimeError, ValueError, TypeError, NotImplementedError):
            out = torch.stack([torch.as_tensor(f1d(row), device=flat.device) for row in flat])
        out = out.reshape(lead + tuple(self.out_shape))
        nd = len(lead) + len(self.out_shape)
        perm = list(range(self.axis)) + list(range(len(lead), nd)) + list(range(self.axis, len(lead)))
        return BlockView(self.chunks, dense=cast(out.permute(perm), self._dtype))


def _probe_1d(func1d, dt, n, args, kwargs):
    """``func1d`` of a CPU tensor of ones and numpy's dtype of its result.
    The probe holds numpy's dtype ``dt``, so that uint16/32/64 stay
    unsigned (torch reduces them to int64, where numpy gives uint64); where
    torch has no kernel of that unsigned dtype, it runs in the compute dtype
    (int32 or int64), whose result then is ``dt`` again."""
    unsigned = np.dtype(dt).kind == "u" and compute_dtype(dt) != torch_dtype(dt)
    if unsigned:
        try:
            test = torch.as_tensor(func1d(torch.ones(n, dtype=torch_dtype(dt)), *args, **kwargs))
        except (NotImplementedError, RuntimeError, TypeError):
            test = torch.as_tensor(func1d(torch.ones(n, dtype=compute_dtype(dt)), *args, **kwargs))
            return test, np.dtype(dt) if test.dtype == compute_dtype(dt) else numpy_dtype(test.dtype)
        return test, np.dtype(np.uint64) if test.dtype == torch.int64 else numpy_dtype(test.dtype)
    test = torch.as_tensor(func1d(torch.ones(n, dtype=compute_dtype(dt)), *args, **kwargs))
    return test, numpy_dtype(test.dtype)


def apply_along_axis(func1d, axis, arr, *args, dtype=None, shape=None, **kwargs):
    """numpy's apply_along_axis with a function of torch 1-D tensors; its
    output shape and dtype come from one call on a small CPU tensor
    unless given."""
    from dask_array_tpu_torch._collection import new_collection

    arr = _asarray(arr)
    axis = validate_axis(axis, arr.ndim)
    if shape is None or dtype is None:
        test, dt = _probe_1d(func1d, arr.dtype, max(1, arr.shape[axis]), args, kwargs)
        shape = tuple(test.shape) if shape is None else shape
        dtype = dt if dtype is None else dtype
    return new_collection(ApplyAlongAxis(arr.expr, func1d, axis, tuple(shape), np.dtype(dtype), tuple(args),
                                         tuple(sorted(kwargs.items()))))


def apply_over_axes(func, a, axes):
    """numpy's apply_over_axes: ``func(a, axis)`` for each axis in turn, a
    result one dimension short given its axis back."""
    from dask_array_tpu_torch.ops.manipulation import expand_dims

    a = _asarray(a)
    if np.ndim(axes) == 0:
        axes = (axes,)
    out = a
    for ax in axes:
        ax = validate_axis(ax, a.ndim)
        res = func(out, ax)
        if res.ndim == out.ndim:
            out = res
        elif res.ndim == out.ndim - 1:
            out = expand_dims(res, ax)
        else:
            raise ValueError("function is not returning an array of the correct shape")
    return out


# ---------------------------------------------------------------------------
# index math
# ---------------------------------------------------------------------------


def _strides(dims, order):
    """Element strides of a C- or F-ordered array of shape ``dims``."""
    seq = list(dims) if order == "F" else list(dims)[::-1]
    out, acc = [], 1
    for d in seq:
        out.append(acc)
        acc *= d
    return out if order == "F" else out[::-1]


def ravel_block_(block, dims=(), modes=(), order="C"):
    """numpy's ravel_multi_index of one block of stacked coordinates
    (modes wrap and clip; mode raise is checked before, on the device)."""
    c = computable(block).to(torch.int64)
    total = None
    for i, (d, mode, s) in enumerate(zip(dims, modes, _strides(dims, order))):
        ci = c[i]
        if mode == "wrap":
            ci = torch.remainder(ci, d)
        elif mode == "clip":
            ci = ci.clamp(0, d - 1)
        total = ci * s if total is None else total + ci * s
    return total


class RavelMultiRaise(ArrayExpr):
    """``ravel_multi_index`` with a coordinate in mode "raise": every
    coordinate range checked on the device, one ``aminmax`` per dimension
    and one sync in all, numpy's ValueError before the result is formed."""

    _parameters = ("stacked", "dims", "modes", "order")

    @functools.cached_property
    def chunks(self):
        return tuple(self.stacked.chunks[1:])

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.chunks), dtype=np.intp)

    def _build(self, ctx):
        c = computable(ctx.build(self.stacked).dense()).to(torch.int64)
        checked = [i for i, m in enumerate(self.modes) if m == "raise"]
        if c[0].numel() and checked:
            flat = c[checked].reshape(len(checked), -1)
            lo, hi = torch.aminmax(flat, dim=1)
            bounds = torch.stack([lo, hi]).tolist()
            count_sync()
            for j, i in enumerate(checked):
                if bounds[0][j] < 0 or bounds[1][j] >= self.dims[i]:
                    raise ValueError("invalid entry in coordinates array")
        return BlockView(self.chunks, dense=ravel_block_(c, self.dims, self.modes, self.order))


def ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    """numpy's ravel_multi_index: the coordinates stacked along a new first
    axis (one chunk there); modes wrap/clip are one ``map_blocks``, mode
    raise one node that checks the ranges on the device first."""
    from dask_array_tpu_torch._collection import Array, new_collection
    from dask_array_tpu_torch.ops._map_blocks import map_blocks
    from dask_array_tpu_torch.ops.stacking import stack

    if np.isscalar(dims):
        dims = (dims,)
    if isinstance(dims, Array) or any(isinstance(d, Array) for d in dims):
        raise NotImplementedError(f"Dask types are not supported in the `dims` argument: {dims!r}")
    dims = tuple(int(d) for d in dims)
    if order not in ("C", "F"):
        raise ValueError("only 'C' or 'F' order is permitted")
    modes = (mode,) * len(dims) if isinstance(mode, str) else tuple(mode)
    if len(modes) != len(dims) or any(m not in ("raise", "wrap", "clip") for m in modes):
        raise ValueError(f"clipmode must be one of 'clip', 'raise', or 'wrap' (got {mode!r})")
    if isinstance(multi_index, Array) and multi_index.ndim > 0:
        index_stack = multi_index
    else:
        coords = [_asarray(c) for c in multi_index]
        if any(isinstance(s, float) and np.isnan(s) for c in coords for s in c.shape):
            raise ValueError("ravel_multi_index needs known chunk sizes to broadcast the coordinate arrays; call "
                             "compute_chunk_sizes() first")
        index_stack = stack(broadcast_arrays(*coords))
    if index_stack.shape[0] != len(dims):
        raise ValueError(f"parameter multi_index must be a sequence of length {len(dims)}")
    if not np.can_cast(index_stack.dtype, np.intp, "same_kind"):
        raise TypeError("only int indices permitted")
    if len(index_stack.chunks[0]) != 1:
        index_stack = index_stack.rechunk({0: -1})
    if "raise" in modes:
        return new_collection(RavelMultiRaise(index_stack.expr, dims, modes, order))
    return map_blocks(ravel_block_, index_stack, dtype=np.intp, chunks=index_stack.chunks[1:], drop_axis=0,
                      dims=dims, modes=modes, order=order)


def _unravel_all(idx, shape, order):
    """Every coordinate of flat indices (numpy's ValueError for one out of
    range, checked with one ``aminmax`` and one sync)."""
    idx = computable(idx).to(torch.int64)
    size = math.prod(shape)
    if idx.numel():
        lo, hi = torch.stack(torch.aminmax(idx)).tolist()
        count_sync()
        if lo < 0 or hi >= size:
            raise ValueError(f"index {lo if lo < 0 else hi} is out of bounds for array with size {size}")
    return [torch.div(idx, s, rounding_mode="floor") % d for d, s in zip(shape, _strides(shape, order))]


class UnravelIndex(ArrayExpr):
    """Coordinate ``i`` of ``unravel_index``; the coordinates of one index
    array share one check and one walk."""

    _parameters = ("indices", "shape_", "order", "i")

    @property
    def chunks(self):
        return self.indices.chunks

    @property
    def _meta(self):
        return np.empty((0,) * self.indices.ndim, dtype=np.intp)

    def _build(self, ctx):
        coords = ctx.shared(f"unravel-{self.indices._name}-{self.shape_}-{self.order}",
                            lambda: _unravel_all(ctx.build(self.indices).dense(), self.shape_, self.order))
        return BlockView(self.chunks, dense=coords[self.i])


def unravel_index(indices, shape, order="C"):
    from dask_array_tpu_torch._collection import new_collection
    from dask_array_tpu_torch.ops.creation import empty

    indices = _asarray(indices)
    if np.isscalar(shape):
        shape = (shape,)
    shape = tuple(int(s) for s in shape)
    if order not in ("C", "F"):
        raise ValueError("only 'C' or 'F' order is permitted")
    if not np.can_cast(indices.dtype, np.intp, "same_kind"):
        raise TypeError("only int indices permitted")
    size = indices.size
    if not shape or (not (isinstance(size, float) and np.isnan(size)) and int(size) == 0):
        return tuple(empty((0,), dtype=np.intp, chunks=1) for _ in shape)
    return tuple(new_collection(UnravelIndex(indices.expr, shape, order, i)) for i in range(len(shape)))

__all__ = [
    "aligned_coarsen_chunks", "allclose", "append", "apply_along_axis", "apply_over_axes", "argtopk", "argwhere",
    "around", "average", "bincount", "broadcast_arrays", "choose", "coarsen", "compress", "corrcoef",
    "count_nonzero", "cov", "delete", "diff", "digitize", "ediff1d", "extract", "flatnonzero", "gradient",
    "insert", "isclose", "iscomplexobj", "isin", "isnull", "ndim", "nonzero", "notnull", "piecewise", "ptp",
    "ravel_multi_index", "result_type", "round", "searchsorted", "select", "shape", "topk", "tril", "tril_indices",
    "tril_indices_from", "triu", "triu_indices", "triu_indices_from", "unify_chunks", "union1d", "unique",
    "unravel_index", "where",
]
