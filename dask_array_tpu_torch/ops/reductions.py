"""Reductions: typed dense reductions + the generic tree-reduce framework.

Port of ``dask_array_tpu/ops/reductions.py``.  A *typed* reduction
(sum/mean/max/...) is ONE dense torch reduce over the block-assembled
tensor, as the reference leaves it to one XLA reduce; ``split_every`` is
accepted and canonicalised into the node's name, and changes nothing else.
The generic ``reduction()`` API with user chunk/combine/aggregate functions
keeps the explicit per-block tree (``PartialReduce``), because user
functions must see real blocks: torch tensors, or numpy arrays on the host
for ``arg_reduction``'s structured-array protocol.

Result dtypes follow numpy (``Reduction._meta`` asks numpy), and every
reduce runs in that dtype: operands are cast before the reduce, not after.
The quantiles (``median``, ``quantile`` and their nan forms,
``percentile``) sort along the reduced axes and gather by numpy's host
tables.  The masked/duck host lane waits for a later slice (ROADMAP).
"""

from __future__ import annotations

import builtins
import functools
import inspect
import math
import warnings
from numbers import Integral

import numpy as np
import torch

from dask_array_tpu_torch._blockwise import elemwise
from dask_array_tpu_torch._chunks import (
    INT64_MIN,
    as_stored,
    cached_cumsum,
    cast,
    cat,
    computable,
    compute_dtype,
    moved,
    numpy_dtype,
    sort_numpy,
    to_compute,
    torch_dtype,
    validate_axis,
)
from dask_array_tpu_torch._executor import BlockView, iter_block_indices
from dask_array_tpu_torch._expr import ArrayExpr
from dask_array_tpu_torch._slicing import is_basic_index


def handle_out(out, result):
    """numpy-style ``out=`` (lazy): defer to the collection-layer helper."""
    from dask_array_tpu_torch._collection import handle_out as _handle_out

    return _handle_out(out, result)


# ---------------------------------------------------------------------------
# typed dense reductions
# ---------------------------------------------------------------------------

# name -> (numpy function for meta, takes dtype kw)
_DENSE_KINDS = {
    "sum": (np.sum, True),
    "prod": (np.prod, True),
    "min": (np.min, False),
    "max": (np.max, False),
    "any": (np.any, False),
    "all": (np.all, False),
    "mean": (np.mean, True),
    "nansum": (np.nansum, True),
    "nanprod": (np.nanprod, True),
    "nanmin": (np.nanmin, False),
    "nanmax": (np.nanmax, False),
    "nanmean": (np.nanmean, True),
}


def _prod_dims(x, dims, keepdim, dtype):
    """torch.prod over several dims (it takes one): the reduced dims move
    last and merge into one."""
    if len(dims) == 1:
        return torch.prod(x, dim=dims[0], keepdim=keepdim, dtype=dtype)
    kept = [d for d in range(x.ndim) if d not in dims]
    n = math.prod(x.shape[d] for d in dims)
    flat = x.permute(*kept, *dims).reshape(*[x.shape[d] for d in kept], n)
    out = torch.prod(flat, dim=-1, dtype=dtype)
    if keepdim:
        out = out.reshape([1 if d in dims else x.shape[d] for d in range(x.ndim)])
    return out


def complex_arg(x, dim, largest, nan_first):
    """The index along ``dim`` of numpy's extremum of a complex tensor in
    its lexicographic order (real part, then imaginary part).

    With ``nan_first`` (max, min, argmax, argmin: numpy's maximum.reduce and
    argmax) the first element with a NaN part wins where there is one;
    without it (nanmax, nanmin: fmax.reduce) elements with a NaN part lose,
    and an all-NaN slice gives its first element.  Among equal extrema the
    first wins."""
    re, im = x.real, x.imag
    nan = torch.isnan(re) | torch.isnan(im)
    fill = -math.inf if largest else math.inf
    red = torch.amax if largest else torch.amin
    re_key = torch.where(nan, fill, re)
    cand = (re_key == red(re_key, dim=dim, keepdim=True)) & ~nan
    im_key = torch.where(cand, im, fill)
    win = cand & (im_key == red(im_key, dim=dim, keepdim=True))
    idx = torch.argmax(win.to(torch.uint8), dim=dim)  # the first True
    if nan_first:
        idx = torch.where(nan.any(dim=dim), torch.argmax(nan.to(torch.uint8), dim=dim), idx)
    return idx


def _complex_extremum(kind, x, dims, keepdim):
    """min/max/nanmin/nanmax of a complex tensor over ``dims`` (flattened
    in C order): the element ``complex_arg`` picks."""
    kept = [d for d in range(x.ndim) if d not in dims]
    flat = x.permute(*kept, *dims).reshape(*[x.shape[d] for d in kept], -1)
    idx = complex_arg(flat, -1, largest=kind.endswith("max"), nan_first=not kind.startswith("nan"))
    out = torch.gather(flat, -1, idx.unsqueeze(-1)).squeeze(-1)
    if keepdim:
        out = out.reshape([1 if d in dims else x.shape[d] for d in range(x.ndim)])
    return out


def _dense_reduce(kind, x, dims, keepdim, acc):
    """One torch reduce of ``x`` over ``dims`` in dtype ``acc``."""
    inexact = x.is_floating_point() or x.is_complex()
    if kind.startswith("nan") and not inexact:
        kind = kind[3:]  # integers and bools carry no NaNs
    if kind in ("min", "max", "nanmin", "nanmax") and builtins.any(x.shape[d] == 0 for d in dims):
        raise ValueError(
            f"zero-size array to reduction operation {kind} which has no identity"
        )
    if kind in ("min", "max", "nanmin", "nanmax") and x.is_complex():
        return _complex_extremum(kind, x, dims, keepdim)
    if kind == "sum":
        return torch.sum(x, dim=dims, keepdim=keepdim, dtype=acc)
    if kind == "prod":
        return _prod_dims(x, dims, keepdim, acc)
    if kind == "mean":
        if acc.is_floating_point or acc.is_complex:
            return torch.mean(x.to(acc), dim=dims, keepdim=keepdim)
        # numpy's integer-dtype mean: integer sum, true division, unsafe cast
        n = math.prod(x.shape[d] for d in dims)
        return (torch.sum(x, dim=dims, keepdim=keepdim, dtype=acc).double() / n).to(acc)
    if kind == "min":
        return torch.amin(x, dim=dims, keepdim=keepdim)
    if kind == "max":
        return torch.amax(x, dim=dims, keepdim=keepdim)
    if kind == "any":
        return torch.any(x, dim=dims, keepdim=keepdim)
    if kind == "all":
        return torch.all(x, dim=dims, keepdim=keepdim)
    nan = torch.isnan(x)
    if kind == "nansum":
        return torch.sum(torch.where(nan, 0, x), dim=dims, keepdim=keepdim, dtype=acc)
    if kind == "nanprod":
        return _prod_dims(torch.where(nan, 1, x), dims, keepdim, acc)
    if kind == "nanmean":
        total = torch.sum(torch.where(nan, 0, x), dim=dims, keepdim=keepdim, dtype=acc)
        return total / torch.sum(~nan, dim=dims, keepdim=keepdim)
    if kind in ("nanmin", "nanmax"):
        fill = math.inf if kind == "nanmin" else -math.inf
        red = torch.amin if kind == "nanmin" else torch.amax
        out = red(torch.where(nan, fill, x), dim=dims, keepdim=keepdim)
        # an all-NaN slice gives NaN, as numpy's (with its warning)
        return torch.where(torch.all(nan, dim=dims, keepdim=keepdim), math.nan, out)
    raise ValueError(f"unknown reduction {kind!r}")


def reduce_dense(kind, x, axes, keepdims, dtype):
    """A typed reduction of the held block ``x`` over ``axes``, its result
    in numpy's ``dtype`` as the block of that dtype."""
    _, takes_dtype = _DENSE_KINDS[kind]
    out_dt = compute_dtype(dtype)  # numpy's uint64 sums run in int64
    acc = out_dt
    if takes_dtype:
        if out_dt.is_floating_point and out_dt.itemsize < 4:
            # sub-f32 float accumulators stall once the partial's ulp
            # exceeds the addend; accumulate in f32, cast the result
            acc = torch.float32
        # cast before the reduce
        x = to_compute(x, dtype if acc == out_dt else numpy_dtype(acc))
    dims, keepdim = tuple(axes), bool(keepdims)
    if not dims:
        # numpy's axis=(): each element reduces alone
        x, dims, keepdim = x.unsqueeze(-1), (x.ndim,), False
    flip = kind in ("min", "max", "nanmin", "nanmax") and x.dtype == torch.uint64
    if not takes_dtype:
        # min/max/any/all of uint16/32/64 in their compute dtype, a uint64
        # as its bits with the sign bit flipped: the signed order is then
        # the unsigned one
        x = computable(x) ^ INT64_MIN if flip else computable(x)
    dense = _dense_reduce(kind, x, dims, keepdim, acc)
    if flip:
        dense = dense ^ INT64_MIN
    if dense.dtype != out_dt:
        dense = dense.to(out_dt)
    return as_stored(dense, dtype)


class Reduction(ArrayExpr):
    """A typed whole-axis reduction, executed as one dense torch reduce."""

    _parameters = ("array", "kind", "axes", "keepdims", "_dtype", "split_every")
    _defaults = {"split_every": None}

    def _name_prefix(self):
        return self.kind

    @functools.cached_property
    def chunks(self):
        out = []
        for ax, c in enumerate(self.array.chunks):
            if ax in self.axes:
                if self.keepdims:
                    out.append((1,))
            else:
                out.append(c)
        return tuple(out)

    @functools.cached_property
    def _meta(self):
        dtype = self.operand("_dtype")
        nd = len(self.chunks)
        if dtype is not None:
            return np.empty((0,) * nd, dtype=np.dtype(dtype))
        np_fn, _ = _DENSE_KINDS[self.kind]
        probe = np.ones((1,) * self.array.ndim, dtype=self.array.dtype)
        with np.errstate(all="ignore"):
            out = np_fn(probe, axis=self.axes, keepdims=self.keepdims)
        return np.empty((0,) * nd, dtype=out.dtype)

    def _build(self, ctx):
        x = ctx.build(self.array).dense()
        return BlockView(self.chunks, dense=reduce_dense(self.kind, x, self.axes, self.keepdims, self.dtype))

    def _accept_slice(self, index):
        if not is_basic_index(index):
            return None
        from dask_array_tpu_torch._slicing import Slice, normalize_slice

        # ints on kept axes become size-1 slices pushed inside, with an
        # outer [0] extraction
        inner = []
        outer = []  # index applied AFTER the (pushed) reduction
        out_pos = 0
        any_push = False
        for ax in range(self.array.ndim):
            if ax in self.axes:
                if self.keepdims:
                    ind = index[out_pos]
                    if ind not in (slice(None), slice(0, 1, 1)):
                        return None
                    outer.append(slice(None))
                    out_pos += 1
                inner.append(slice(None))
            else:
                ind = index[out_pos]
                out_pos += 1
                dim = self.array.shape[ax]
                if isinstance(ind, Integral):
                    if not (isinstance(dim, float) and math.isnan(dim)) and dim <= 1:
                        # nothing left to shrink: keep the int outside
                        # (re-pushing would wrap a new layer every pass)
                        inner.append(slice(None))
                        outer.append(int(ind))
                    else:
                        inner.append(slice(int(ind), int(ind) + 1, 1))
                        outer.append(0)
                        any_push = True
                else:
                    norm = normalize_slice(ind, dim) if not (isinstance(dim, float) and math.isnan(dim)) else ind
                    inner.append(norm)
                    outer.append(slice(None))
                    if norm != slice(None):
                        any_push = True
        if not any_push:
            return None
        pushed = type(self)(Slice(self.array, tuple(inner)), *self.operands[1:])
        if builtins.any(isinstance(o, Integral) for o in outer):
            return Slice(pushed, tuple(outer))
        return pushed


def _coerce(a):
    """Accept raw numpy/array-likes everywhere reductions do
    (``da.sum(np_array)`` works)."""
    from dask_array_tpu_torch._collection import Array

    if isinstance(a, (Array, ArrayExpr)):
        return a
    from dask_array_tpu_torch.ops._from_array import asarray

    return asarray(a)


def _reduce(x, kind, axis=None, dtype=None, keepdims=False, split_every=None):
    from dask_array_tpu_torch._collection import Array, new_collection

    x = _coerce(x)
    expr = x.expr if isinstance(x, Array) else x
    if axis is None:
        axes = tuple(range(expr.ndim))
    elif isinstance(axis, (tuple, list)):
        axes = tuple(sorted(validate_axis(a, expr.ndim) for a in axis))
    else:
        axes = (validate_axis(axis, expr.ndim),)
    if dtype is not None:
        dtype = np.dtype(dtype)
    if split_every is not None:
        # canonical {axis: n} form so equivalent specs share one name
        split_every = tuple(sorted(_normalize_split_every(split_every, axes).items()))
    return new_collection(
        Reduction(expr, kind, axes, bool(keepdims), dtype, split_every)
    )


def sum(a, axis=None, dtype=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "sum", axis, dtype, keepdims, split_every))


def prod(a, axis=None, dtype=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "prod", axis, dtype, keepdims, split_every))


def min(a, axis=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "min", axis, None, keepdims, split_every))


def max(a, axis=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "max", axis, None, keepdims, split_every))


def any(a, axis=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "any", axis, None, keepdims, split_every))


def all(a, axis=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "all", axis, None, keepdims, split_every))


def mean(a, axis=None, dtype=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "mean", axis, dtype, keepdims, split_every))


def nansum(a, axis=None, dtype=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "nansum", axis, dtype, keepdims, split_every))


def nanprod(a, axis=None, dtype=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "nanprod", axis, dtype, keepdims, split_every))


def nanmin(a, axis=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "nanmin", axis, None, keepdims, split_every))


def nanmax(a, axis=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "nanmax", axis, None, keepdims, split_every))


def nanmean(a, axis=None, dtype=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "nanmean", axis, dtype, keepdims, split_every))


# -- variance family ----------------------------------------------------------


def _var_dtype(a, dtype):
    if dtype is not None:
        return np.dtype(dtype)
    dt = a.dtype
    if np.issubdtype(dt, np.integer) or dt == bool:
        return np.dtype(float)
    return dt


def _axes_of(a, axis):
    if axis is None:
        return tuple(range(a.ndim))
    if isinstance(axis, (tuple, list)):
        return tuple(validate_axis(x, a.ndim) for x in axis)
    return (validate_axis(axis, a.ndim),)


def moment(a, order, axis=None, dtype=None, keepdims=False, ddof=0, split_every=None, out=None):
    """Central moment of the given order (power-sums formulation)."""
    if order < 0:
        raise ValueError("Order must be non-negative")
    a = _coerce(a)
    dt = _var_dtype(a, dtype)
    if order == 0:
        from dask_array_tpu_torch.ops.creation import ones

        axes = _axes_of(a, axis)
        if keepdims:
            shape = tuple(1 if i in axes else s for i, s in enumerate(a.shape))
        else:
            shape = tuple(s for i, s in enumerate(a.shape) if i not in axes)
        return ones(shape, dtype=dt)
    n = _count(a, axis, keepdims=True, split_every=split_every)
    mu = sum(a.astype(dt), axis=axis, keepdims=True, split_every=split_every) / n
    centered = (a.astype(dt) - mu) ** order
    m = sum(centered, axis=axis, dtype=dt, keepdims=keepdims, split_every=split_every)
    denom = _count(a, axis, keepdims=keepdims, split_every=split_every) - ddof
    return handle_out(out, m / denom)


def _count(a, axis, keepdims, split_every, dtype="f8"):
    from dask_array_tpu_torch.ops.creation import ones

    axes = _axes_of(a, axis)
    sizes = [a.shape[ax] for ax in axes]
    if builtins.all(isinstance(s, (int, np.integer)) for s in sizes):
        # static shape: the count is a constant, a numpy scalar operand of
        # the elementwise ops that use it, with numpy's dtype rules
        n = 1
        for s in sizes:
            n *= int(s)
        return np.dtype(dtype).type(n)
    o = ones(a.shape, dtype=dtype, chunks=a.chunks)
    return sum(o, axis=axis, dtype=dtype, keepdims=keepdims, split_every=split_every)


def _nancount(a, axis, keepdims, split_every, dtype="f8"):
    notnan = elemwise(torch.logical_not, elemwise(torch.isnan, a))
    return sum(notnan, axis=axis, dtype=dtype, keepdims=keepdims, split_every=split_every)


def _var_shift(a):
    """A cheap data-derived shift for the one-pass variance formulation.

    The array's first element (one block read after slice pushdown).  Any
    value within the data's range makes the shifted power-sum cancellation
    benign (|E[x-s]| ~ std); the first element also makes var of a constant
    array exactly zero.  None for empty/unknown-size arrays.
    """
    shape = a.shape
    if builtins.any((not isinstance(s, (int, np.integer))) or s <= 0 for s in shape):
        return None
    return a[(0,) * a.ndim]


def _mask_nan_to(v, c):
    return torch.where(torch.isnan(v), c, v)


def _nan_shift(a):
    """0-d in-range shift robust to NaNs anywhere: ``nan_to_num(nanmean)``.

    ``_var_shift``'s first element may itself be NaN, so this pays one
    extra reduction pass for a global nanmean.  nanmean is NaN only when
    every element is, and then the variance is all-NaN regardless.  For a
    sliding window view the nanmean runs over the view's source: the same
    values, n instead of n*w elements, and a 0-d operand that keeps the
    window-reduction fusion intact.
    """
    from dask_array_tpu_torch._collection import new_collection
    from dask_array_tpu_torch.ops._overlap import SlidingWindowView

    if isinstance(a.expr, SlidingWindowView):
        a = new_collection(a.expr.array)
    shape = a.shape
    if builtins.any((not isinstance(s, (int, np.integer))) or s <= 0 for s in shape):
        return None
    return elemwise(torch.nan_to_num, nanmean(a))


def _real(x):
    return elemwise(torch.real, x)


def _conj(x):
    return elemwise(torch.conj, x)


def _power_sums_var(x, d, dt, rdt, complex_data, n, axis, keepdims, split_every, ddof, dtype):
    """``var = (Q - |T|^2/n) / (n - ddof)`` from ``d = x - s``: T and Q are
    independent reductions over one producer (the one-pass form)."""
    cdt = np.dtype(dt)
    if complex_data:
        sq = _real(d * _conj(d))
        if cdt.kind == "c":
            t = sum(d, axis=axis, dtype=dt, keepdims=keepdims, split_every=split_every)
            tsq = _real(t * _conj(t))
        else:
            t = sum(_real(d), axis=axis, dtype=rdt, keepdims=keepdims, split_every=split_every)
            tsq = t * t
    else:
        t = sum(d, axis=axis, dtype=dt, keepdims=keepdims, split_every=split_every)
        sq = d * d
        tsq = t * t
    q = sum(sq, axis=axis, dtype=rdt, keepdims=keepdims, split_every=split_every)
    # rounding can push m2 epsilon-negative; clamp (clamp_min keeps NaN)
    m2 = elemwise(torch.clamp_min, q - tsq / n, 0)
    res = m2 / (n - ddof)
    # numpy returns the explicitly requested dtype, even integer (truncating)
    # or complex (imag 0); the internal real accumulator dtype differs then
    if dtype is not None and res.dtype != np.dtype(dtype):
        if np.dtype(dtype).kind in "iu":
            # the float value can sit 1 ulp below numpy's exact integer
            # result, which truncation would drop a whole unit: round first
            res = elemwise(torch.round, res)
        res = res.astype(np.dtype(dtype))
    return res


def var(a, axis=None, dtype=None, keepdims=False, ddof=0, split_every=None, out=None):
    """Variance via one-pass shifted power sums.

    ``var = (Q - |T|^2/n) / (n - ddof)`` with ``d = x - s``, ``T = sum(d)``,
    ``Q = sum(|d|^2)``; the shift ``s`` (the first element) keeps the
    cancellation benign.  The values follow the reference's rounding, not a
    two-pass formula's.
    """
    a = _coerce(a)
    dt = _var_dtype(a, dtype)
    cdt = np.dtype(dt)
    complex_data = np.dtype(a.dtype).kind == "c"
    if complex_data and cdt.kind != "c":
        # numpy oddity: an explicit REAL dtype on complex input keeps the
        # DATA complex but accumulates the mean in the real dtype (dropping
        # imag), so m2 = sum|x - real_mean|^2 = Q - real(T)^2/n
        x = a
        rdt = cdt
    else:
        x = a.astype(dt)
        rdt = np.dtype(cdt.char.lower().replace("c", "f")) if cdt.kind == "c" else cdt
    s = _var_shift(x)
    if s is not None:
        if complex_data and cdt.kind != "c":
            s = _real(s).astype(rdt)
        elif s.dtype != cdt:
            s = s.astype(cdt)
    d = x if s is None else x - s
    n = _count(a, axis, keepdims=keepdims, split_every=split_every, dtype=rdt)
    res = _power_sums_var(x, d, dt, rdt, complex_data, n, axis, keepdims, split_every, ddof, dtype)
    return handle_out(out, res)


def std(a, axis=None, dtype=None, keepdims=False, ddof=0, split_every=None, out=None):
    res = elemwise(torch.sqrt, var(a, axis=axis, dtype=dtype, keepdims=keepdims, ddof=ddof, split_every=split_every))
    if dtype is not None and res.dtype != np.dtype(dtype):
        res = res.astype(np.dtype(dtype))
    return handle_out(out, res)


def nanvar(a, axis=None, dtype=None, keepdims=False, ddof=0, split_every=None, out=None):
    """NaN-skipping variance via the same shifted power sums as :func:`var`
    (NaN terms contribute 0 to both sums; counts exclude them).  The shift
    is a global nanmean (one extra pass, :func:`_nan_shift`), because the
    first element may be NaN."""
    a = _coerce(a)
    dt = _var_dtype(a, dtype)
    cdt = np.dtype(dt)
    complex_data = np.dtype(a.dtype).kind == "c"
    if complex_data and cdt.kind != "c":
        x = a
        xdt = np.dtype(a.dtype)
        rdt = cdt
    else:
        x = a.astype(dt)
        xdt = cdt
        rdt = np.dtype(cdt.char.lower().replace("c", "f")) if cdt.kind == "c" else cdt
    inexact = xdt.kind in "fc"
    s = _nan_shift(a) if inexact else None
    if s is not None:
        if complex_data and cdt.kind != "c":
            s = _real(s).astype(rdt)
        elif s.dtype != xdt:
            s = s.astype(xdt)
    # NaN data terms must not poison the shifted sums: mask each to the
    # shift (contributing exactly 0 to T and Q) before differencing
    if s is not None:
        d = elemwise(_mask_nan_to, x, s) - s
    elif inexact:
        d = elemwise(_mask_nan_to, x, 0)
    else:
        d = x  # integers carry no NaNs
    n = _nancount(a, axis, keepdims=keepdims, split_every=split_every, dtype=rdt)
    res = _power_sums_var(x, d, dt, rdt, complex_data, n, axis, keepdims, split_every, ddof, dtype)
    return handle_out(out, res)


def nanstd(a, axis=None, dtype=None, keepdims=False, ddof=0, split_every=None, out=None):
    res = elemwise(torch.sqrt, nanvar(a, axis=axis, dtype=dtype, keepdims=keepdims, ddof=ddof, split_every=split_every))
    if dtype is not None and res.dtype != np.dtype(dtype):
        res = res.astype(np.dtype(dtype))
    return handle_out(out, res)


# -- arg reductions --------------------------------------------------------------


def _arg_dense(kind, x, axis):
    """numpy's arg-reduction of a tensor along ``axis`` (None: flattened).

    argmin/argmax give the first NaN's index where a NaN is present;
    nanargmin/nanargmax replace NaN by +-inf first, as numpy does, and
    raise on an all-NaN slice.  Complex numbers are ordered as numpy
    orders them (``complex_arg``)."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    if x.shape[axis] == 0:
        raise ValueError(f"attempt to get {kind} of an empty sequence")
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    elif x.dtype == torch.uint64:
        x = x.view(torch.int64) ^ INT64_MIN  # the unsigned order, as signed
    else:
        x = computable(x)
    largest = kind in ("argmax", "nanargmax")
    if x.is_complex():
        if not kind.startswith("nan"):
            return complex_arg(x, axis, largest, nan_first=True)
        nan = torch.isnan(x.real) | torch.isnan(x.imag)
        if bool(torch.all(nan, dim=axis).any()):
            raise ValueError(f"All-NaN slice encountered in {kind}")
        # numpy replaces a NaN by -inf (+inf) + 0j, then takes argmax (argmin)
        x = torch.where(nan, torch.tensor(complex(-math.inf if largest else math.inf, 0.0), dtype=x.dtype, device=x.device), x)
        return complex_arg(x, axis, largest, nan_first=False)
    find = torch.argmax if largest else torch.argmin
    if not x.is_floating_point():
        return find(x, dim=axis)
    nan = torch.isnan(x)
    if kind.startswith("nan"):
        if bool(torch.all(nan, dim=axis).any()):
            raise ValueError(f"All-NaN slice encountered in {kind}")
        fill = math.inf if kind == "nanargmin" else -math.inf
        return find(torch.where(nan, fill, x), dim=axis)
    # argmax of a bool/uint8 mask gives the first True
    first_nan = torch.argmax(nan.to(torch.uint8), dim=axis)
    return torch.where(torch.any(nan, dim=axis), first_nan, find(x, dim=axis))


class ArgReduction(ArrayExpr):
    _parameters = ("array", "kind", "axis", "keepdims")

    def _name_prefix(self):
        return self.kind

    @functools.cached_property
    def chunks(self):
        if self.axis is None:
            # numpy keepdims over a full reduction keeps every axis at size 1
            return ((1,),) * self.array.ndim if self.keepdims else ()
        out = []
        for ax, c in enumerate(self.array.chunks):
            if ax == self.axis:
                if self.keepdims:
                    out.append((1,))
            else:
                out.append(c)
        return tuple(out)

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.chunks), dtype=np.intp)

    def _build(self, ctx):
        x = ctx.build(self.array).dense()
        dense = _arg_dense(self.kind, x, self.axis)
        if self.keepdims:
            if self.axis is None:
                dense = dense.reshape((1,) * self.array.ndim)
            else:
                dense = dense.unsqueeze(self.axis)
        return BlockView(self.chunks, dense=dense.to(torch_dtype(np.intp)))


def _argreduce(a, kind, axis=None, keepdims=False, split_every=None, out=None):
    from dask_array_tpu_torch._collection import Array, new_collection

    a = _coerce(a)
    expr = a.expr if isinstance(a, Array) else a
    if axis is not None:
        if not isinstance(axis, Integral):
            raise TypeError(f"axis must be an integer or None, got {axis!r}")
        axis = validate_axis(axis, expr.ndim)
    return new_collection(ArgReduction(expr, kind, axis, bool(keepdims)))


def argmin(a, axis=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _argreduce(a, "argmin", axis, keepdims, split_every))


def argmax(a, axis=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _argreduce(a, "argmax", axis, keepdims, split_every))


def nanargmin(a, axis=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _argreduce(a, "nanargmin", axis, keepdims, split_every))


def nanargmax(a, axis=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _argreduce(a, "nanargmax", axis, keepdims, split_every))


class ArgChunk(ArrayExpr):
    """Per-block chunk step of a generic arg-reduction.

    Maps the user chunk function over blocks with each block's global offset
    info so per-block indices become global.  The protocol is host-side
    (structured arrays carrying ``vals``/``arg`` fields), so the chunk,
    combine and aggregate functions see numpy arrays; the final numeric
    result returns to the device.
    """

    _parameters = ("array", "chunk_func", "axis", "ravel")

    def _name_prefix(self):
        return "arg-chunk"

    @functools.cached_property
    def chunks(self):
        return tuple(
            (1,) * len(c) if i in self.axis else c
            for i, c in enumerate(self.array.chunks)
        )

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.chunks), dtype=np.intp)

    def _build(self, ctx):
        view = ctx.build(self.array)
        x = self.array
        starts = [cached_cumsum(bd, initial_zero=True) for bd in x.chunks]
        blocks = {}
        for idx in iter_block_indices(view.numblocks):
            off = tuple(int(starts[d][i]) for d, i in enumerate(idx))
            if self.ravel:
                offset_info = (off, x.shape)
            else:
                offset_info = off[self.axis[0]]
            b = view.block(idx).cpu().numpy()
            blocks[tuple(idx)] = self.chunk_func(b, self.axis, offset_info)
        return BlockView(self.chunks, blocks=blocks)


def arg_reduction(x, chunk, combine, agg, axis=None, keepdims=False, split_every=None, out=None):
    """Generic arg-reduction: offset-carrying per-block chunk step + tree.

    The chunk function receives ``(block, axis, offset_info)`` as numpy and
    typically returns a structured array with ``vals``/``arg`` fields;
    combine/agg receive the concatenated partials.
    """
    from dask_array_tpu_torch._collection import Array, new_collection

    arr = x if isinstance(x, Array) else new_collection(x)
    if axis is None:
        axis_t = tuple(range(arr.ndim))
        ravel = True
    elif isinstance(axis, Integral):
        axis_t = (validate_axis(axis, arr.ndim),)
        ravel = arr.ndim == 1
    else:
        raise TypeError(f"axis must be either `None` or int, got '{axis}'")

    for ax in axis_t:
        c = arr.chunks[ax]
        if len(c) > 1 and builtins.any(isinstance(v, float) and math.isnan(v) for v in c):
            raise ValueError(
                "Arg-reductions do not work with arrays that have "
                "unknown chunksizes.  A possible solution is "
                "x.compute_chunk_sizes()"
            )

    tmp = ArgChunk(arr.expr, chunk, axis_t, ravel)
    expr = _build_tree_reduce_expr(
        tmp, agg, axis_t, bool(keepdims), np.dtype(np.intp), split_every, combine,
        "arg", True,
    )
    return handle_out(out, new_collection(expr))


# -- cumulative -----------------------------------------------------------------

_CUM_IDENTITY = {"nancumsum": 0, "nancumprod": 1}


class CumReduction(ArrayExpr):
    """Cumulative scan along one axis (dense: one torch scan).

    The reference's blocked forms (a sequential carry chain, Blelloch's
    work-efficient scan) give the same values as one dense scan, so
    ``method`` only survives as an API knob.
    """

    _parameters = ("array", "kind", "axis", "_dtype", "method")
    _defaults = {"method": "sequential"}

    def _name_prefix(self):
        return self.kind

    @property
    def chunks(self):
        return self.array.chunks

    @functools.cached_property
    def _meta(self):
        dtype = self.operand("_dtype")
        if dtype is not None:
            return np.empty((0,) * self.array.ndim, dtype=np.dtype(dtype))
        probe = np.ones((1,) * self.array.ndim, dtype=self.array.dtype)
        out = getattr(np, self.kind)(probe, axis=self.axis)
        return np.empty((0,) * self.array.ndim, dtype=out.dtype)

    def _build(self, ctx):
        x = ctx.build(self.array).dense()
        if self.kind in _CUM_IDENTITY and (x.is_floating_point() or x.is_complex()):
            x = torch.where(torch.isnan(x), _CUM_IDENTITY[self.kind], x)
        x = to_compute(x, self.dtype)  # numpy scans in the result dtype
        if x.dtype == torch.float16:
            # numpy rounds a float16 scan to float16 after every step, which
            # no torch scan does (they carry float32): numpy's own scan, on
            # the host for a CUDA tensor
            scan = np.cumsum if self.kind.endswith("cumsum") else np.cumprod
            out = torch.from_numpy(scan(x.cpu().numpy(), axis=self.axis)).to(x.device)
            return BlockView(self.chunks, dense=out)
        scan = torch.cumsum if self.kind.endswith("cumsum") else torch.cumprod
        return BlockView(self.chunks, dense=as_stored(scan(x, dim=self.axis), self.dtype))


def _cum(a, kind, axis=None, dtype=None, method="sequential", out=None):
    from dask_array_tpu_torch._collection import Array, new_collection

    a = _coerce(a)
    expr = a.expr if isinstance(a, Array) else a
    if axis is None:
        if expr.ndim > 1:
            from dask_array_tpu_torch.ops._reshape import ravel

            expr = ravel(new_collection(expr)).expr
        axis = 0
    axis = validate_axis(axis, expr.ndim)
    if dtype is not None:
        dtype = np.dtype(dtype)
    return new_collection(CumReduction(expr, kind, axis, dtype, method))


def cumsum(a, axis=None, dtype=None, method="sequential", out=None):
    return handle_out(out, _cum(a, "cumsum", axis, dtype, method))


def cumprod(a, axis=None, dtype=None, method="sequential", out=None):
    return handle_out(out, _cum(a, "cumprod", axis, dtype, method))


def nancumsum(a, axis=None, dtype=None, method="sequential", out=None):
    return handle_out(out, _cum(a, "nancumsum", axis, dtype, method))


def nancumprod(a, axis=None, dtype=None, method="sequential", out=None):
    return handle_out(out, _cum(a, "nancumprod", axis, dtype, method))


def cumreduction(func, binop, ident, x, axis=None, dtype=None, out=None, method="sequential", preop=None):
    """Generic cumulative reduction over blocks.

    ``func(block, axis=axis)`` scans one block (a torch function);
    ``method="sequential"`` chains a carry over blocks (the last hyperplane
    of the previous scanned block), ``method="blelloch"`` takes per-block
    totals via ``preop(block, axis=axis, keepdims=True)``, scans them with
    ``binop`` and combines each into its block's local scan.
    """
    name = getattr(func, "__name__", "")
    if func in (np.cumsum, torch.cumsum) or name == "cumsum":
        return cumsum(x, axis=axis, dtype=dtype, method=method, out=out)
    if func in (np.cumprod, torch.cumprod) or name == "cumprod":
        return cumprod(x, axis=axis, dtype=dtype, method=method, out=out)
    if method == "blelloch":
        if preop is None:
            raise TypeError(
                'cumreduction with "blelloch" method requires `preop=` argument'
            )
    elif method != "sequential":
        raise ValueError(
            'Invalid method for cumreduction. Expected "sequential" or '
            f'"blelloch". Got: {method!r}'
        )
    x = _coerce(x)
    if axis is None:
        x = x.ravel() if x.ndim != 1 else x
        axis = 0
    axis = validate_axis(axis, x.ndim)
    from dask_array_tpu_torch._collection import new_collection

    return handle_out(out, new_collection(
        _GenericCumLowered(
            x.expr, func, binop, ident, axis, np.dtype(dtype) if dtype else None,
            method, preop,
        )
    ))


class _GenericCumLowered(ArrayExpr):
    _parameters = ("array", "func", "binop", "ident", "axis", "_dtype", "method", "preop")
    _defaults = {"method": "sequential", "preop": None}

    @property
    def chunks(self):
        return self.array.chunks

    @functools.cached_property
    def _meta(self):
        dtype = self.operand("_dtype")
        if dtype is not None:
            return np.empty((0,) * self.array.ndim, dtype=dtype)
        probe = torch.ones((1,) * self.array.ndim, dtype=compute_dtype(self.array.dtype))
        out = self.func(probe, axis=self.axis)
        return np.empty((0,) * self.array.ndim, dtype=numpy_dtype(out.dtype))

    def _scan_one(self, b):
        return cast(self.func(computable(b), axis=self.axis), self.dtype)

    def _build(self, ctx):
        view = ctx.build(self.array)
        axis = self.axis
        blocks = {}
        nb = view.numblocks
        if self.method == "blelloch":
            # phase 1: per-block totals; phase 2: inclusive prefix of totals
            # feeds each block's combine
            prefix = {}
            for idx in iter_block_indices(nb):
                b = view.block(idx)
                key_prev = idx[:axis] + (idx[axis] - 1,) + idx[axis + 1 :]
                if idx[axis] > 0:
                    t_prev = self.preop(view.block(key_prev), axis=axis, keepdims=True)
                    p = t_prev if idx[axis] == 1 else self.binop(prefix[key_prev], t_prev)
                    prefix[tuple(idx)] = p
                    blocks[tuple(idx)] = self.binop(p, self._scan_one(b))
                else:
                    blocks[tuple(idx)] = self._scan_one(b)
            return BlockView(self.chunks, blocks=blocks)
        carry = {}
        for idx in iter_block_indices(nb):
            b = view.block(idx)
            scanned = self._scan_one(b)
            key_prev = idx[:axis] + (idx[axis] - 1,) + idx[axis + 1:]
            if idx[axis] > 0:
                scanned = self.binop(carry[key_prev], scanned)
            # carry: last slice along axis
            last = [slice(None)] * len(nb)
            last[axis] = slice(-1, None)
            carry[idx] = scanned[tuple(last)]
            blocks[idx] = scanned
        return BlockView(self.chunks, blocks=blocks)


# -- generic reduction framework ------------------------------------------------------


def _concat_parts(parts, axis):
    if isinstance(parts[0], torch.Tensor):
        return cat(parts, dim=axis)
    return np.concatenate(parts, axis=axis)


def _concatenate2(arrays, axes=None):
    """Concatenate a nested list of arrays along multiple axes.

    The outer list level concatenates along ``axes[0]``, the next level along
    ``axes[1]``, and so on.  Dicts of arrays concatenate field-wise; torch
    tensors with ``torch.cat``, numpy (structured) arrays on the host.
    """
    if axes is None:
        axes = []
    if not isinstance(arrays, (list, tuple)):
        return arrays
    if len(axes) > 1:
        arrays = [_concatenate2(a, axes=axes[1:]) for a in arrays]
    parts = list(arrays)
    if len(parts) == 1:
        return parts[0]
    if not axes:
        return parts[0]
    first = parts[0]
    if isinstance(first, dict):
        return {k: _concat_parts([p[k] for p in parts], axes[0]) for k in first}
    return _concat_parts(parts, axes[0])


def _concat_then(fn, axes_sorted, window):
    """``concatenate=True`` adapter: flatten the lol window, then reduce."""
    return fn(_concatenate2(window, axes=list(axes_sorted)))


class ChunkReduce(ArrayExpr):
    """Per-block chunk phase of the generic reduction (keepdims=True).

    Each block maps to ``func(block[, weights_block], axis=axes,
    keepdims=True)``; outputs may be tensors or dicts of tensors — they flow
    through the tree as opaque block payloads.
    """

    _parameters = ("array", "func", "axes", "output_size", "_dtype", "weights")
    _defaults = {"weights": None}

    def _name_prefix(self):
        fn = self.func
        base = getattr(fn, "func", fn)
        return f"{getattr(base, '__name__', 'reduce')}-chunk"

    @functools.cached_property
    def chunks(self):
        return tuple(
            (self.output_size,) * len(c) if ax in self.axes else c
            for ax, c in enumerate(self.array.chunks)
        )

    @functools.cached_property
    def _meta(self):
        dtype = self.operand("_dtype")
        dt = np.dtype(dtype) if dtype is not None else self.array.dtype
        return np.empty((0,) * len(self.chunks), dtype=dt)

    def _build(self, ctx):
        view = ctx.build(self.array)
        wview = ctx.build(self.weights) if self.weights is not None else None
        blocks = {}
        for idx in iter_block_indices(view.numblocks):
            b = view.block(idx)
            b = computable(b)  # uint16/32/64 as torch computes on them
            if wview is not None:
                res = self.func(b, wview.block(idx), axis=self.axes, keepdims=True)
            else:
                res = self.func(b, axis=self.axes, keepdims=True)
            blocks[tuple(idx)] = res
        return BlockView(self.chunks, blocks=blocks)


def _as_block(res, dtype, device):
    """A plain numeric result (a tensor, or numpy from a host-side user
    function) becomes a tensor of ``dtype`` on ``device``; dicts and
    structured arrays pass through as partial payloads."""
    if isinstance(res, (np.ndarray, np.generic)) and res.dtype.names is None and res.dtype != object:
        res = torch.as_tensor(np.asarray(res))
    if isinstance(res, torch.Tensor):
        res = as_stored(to_compute(res.to(device=device), dtype), dtype)
    return res


def _partial(b):
    """A partial as a user function sees it: a uint64 block (an unsigned
    sum, stored as uint64) as its int64 bits, in which torch computes."""
    return computable(b)


class PartialReduce(ArrayExpr):
    """One tree step: reduce windows of ``split_every`` blocks per axis.

    ``func`` receives the window as nested lists over the reduced axes (the
    reference's lol structure); with ``concatenate=True`` the ``_concat_then``
    wrapper flattens it first.
    """

    _parameters = ("array", "func", "split_every", "keepdims", "_dtype", "output_size", "name_")
    _defaults = {"output_size": 1, "name_": None}

    def _name_prefix(self):
        return self.operand("name_") or "partial-reduce"

    @functools.cached_property
    def _split_dict(self):
        return dict(self.split_every)

    @functools.cached_property
    def chunks(self):
        se = self._split_dict
        out = []
        for ax, c in enumerate(self.array.chunks):
            if ax in se:
                n_groups = builtins.max(1, -(-len(c) // se[ax]))
                if self.keepdims:
                    out.append((self.output_size,) * n_groups)
            else:
                out.append(c)
        return tuple(out)

    @functools.cached_property
    def _meta(self):
        dtype = self.operand("_dtype")
        dt = np.dtype(dtype) if dtype is not None else self.array.dtype
        return np.empty((0,) * len(self.chunks), dtype=dt)

    def _build(self, ctx):
        view = ctx.build(self.array)
        se = self._split_dict
        nb_in = view.numblocks
        ndim = len(nb_in)
        groups = {}
        for ax, n in enumerate(nb_in):
            if ax in se:
                step = builtins.max(1, se[ax])
                groups[ax] = [range(lo, builtins.min(lo + step, n)) for lo in range(0, n, step)]
        out_nb = tuple(
            len(groups[ax]) if ax in se else nb_in[ax] for ax in range(ndim)
        )
        blocks = {}
        for out_full in iter_block_indices(out_nb):
            def rec(ax, prefix):
                if ax == ndim:
                    return _partial(view.block(prefix))
                if ax in se:
                    return [rec(ax + 1, prefix + (i,)) for i in groups[ax][out_full[ax]]]
                return rec(ax + 1, prefix + (out_full[ax],))

            res = _as_block(self.func(rec(0, ())), self.dtype, ctx.device)
            if self.keepdims:
                out_key = tuple(out_full)
            else:
                out_key = tuple(out_full[ax] for ax in range(ndim) if ax not in se)
            blocks[out_key] = res
        return BlockView(self.chunks, blocks=blocks)


def _normalize_split_every(split_every, axes):
    """Canonical ``{axis: n}`` form."""
    split_every = split_every or 16
    if isinstance(split_every, dict):
        # clamp to >= 2: a fan-in of 1 would never reduce (and the final
        # step's 1-block groups would collide on one output key)
        return {k: builtins.max(2, int(split_every.get(k, 2))) for k in axes}
    if isinstance(split_every, Integral):
        n = builtins.max(int(split_every ** (1 / (len(axes) or 1))), 2)
        return dict.fromkeys(axes, n)
    raise ValueError("split_every must be a int or a dict")


def _build_tree_reduce_expr(
    expr, aggregate, axes, keepdims, dtype, split_every, combine, name,
    concatenate, output_size=1,
):
    """Tree cascade of PartialReduce steps."""
    se = _normalize_split_every(split_every, axes)
    depth = 1
    for ax, n in enumerate(expr.numblocks):
        if ax in se and se[ax] != 1 and n > 1:
            depth = builtins.max(depth, int(math.ceil(math.log(n, se[ax]))))

    func = functools.partial(combine or aggregate, axis=axes, keepdims=True)
    if concatenate:
        func = functools.partial(_concat_then, func, tuple(sorted(axes)))
    se_t = tuple(sorted(se.items()))
    for _ in range(depth - 1):
        expr = PartialReduce(expr, func, se_t, True, dtype, 1)

    agg = functools.partial(aggregate, axis=axes, keepdims=keepdims)
    if concatenate:
        agg = functools.partial(_concat_then, agg, tuple(sorted(axes)))
    # the final step sees <= split_every blocks per reduced axis: one group
    return PartialReduce(expr, agg, se_t, bool(keepdims), dtype, output_size, name)


def _accepts_named_kw(fn, kw):
    base = fn.func if isinstance(fn, functools.partial) else fn
    try:
        params = inspect.signature(base).parameters
    except (TypeError, ValueError):
        return False
    p = params.get(kw)
    return p is not None and p.kind is not inspect.Parameter.VAR_KEYWORD


def reduction(
    x,
    chunk,
    aggregate,
    axis=None,
    keepdims=False,
    dtype=None,
    split_every=None,
    combine=None,
    name=None,
    out=None,
    concatenate=True,
    output_size=1,
    meta=None,
    weights=None,
):
    """Generic tree reduction with user chunk/combine/aggregate functions.

    The chunk function runs per block (``keepdims=True``) on torch tensors;
    combine reduces ``split_every``-sized windows of partials; aggregate
    finishes.  With ``concatenate=True`` (default) the window is
    concatenated into one tensor first; with ``concatenate=False`` the
    functions receive the nested list of raw partials (the dict protocol).
    A function that takes ``dtype=`` receives the torch dtype.  ``weights``
    are broadcast to ``x`` and passed per block as the chunk function's
    second argument.
    """
    from dask_array_tpu_torch._collection import Array, new_collection

    arr = x if isinstance(x, Array) else new_collection(x)
    axes = _axes_of(arr, axis)
    if dtype is None:
        raise ValueError("Must specify dtype")
    dtype = np.dtype(dtype)
    tdtype = compute_dtype(dtype)  # a uint64 reduction runs in int64

    def with_dtype(fn):
        if fn is not None and _accepts_named_kw(fn, "dtype"):
            return functools.partial(fn, dtype=tdtype)
        return fn

    weights_expr = None
    if weights is not None:
        from dask_array_tpu_torch.ops._from_array import from_array

        try:
            wgt = np.broadcast_to(np.asarray(weights), arr.shape)
        except ValueError:
            raise ValueError(
                f"Weights with shape {np.shape(weights)} are not broadcastable "
                f"to x with shape {arr.shape}"
            ) from None
        weights_expr = from_array(np.ascontiguousarray(wgt), chunks=arr.chunks).expr

    expr = ChunkReduce(arr.expr, with_dtype(chunk), axes, int(output_size), dtype, weights_expr)
    expr = _build_tree_reduce_expr(
        expr, with_dtype(aggregate), axes, bool(keepdims), dtype, split_every,
        with_dtype(combine), name, concatenate, int(output_size),
    )
    return handle_out(out, new_collection(expr))


def _tree_reduce(x, aggregate, axis, keepdims, dtype, split_every=None, combine=None, name=None, concatenate=True, reduced_meta=None):
    """Tree-reduce pre-chunked partials."""
    from dask_array_tpu_torch._collection import Array, new_collection

    arr = x if isinstance(x, Array) else new_collection(x)
    axes = _axes_of(arr, axis)
    expr = _build_tree_reduce_expr(
        arr.expr, aggregate, axes, bool(keepdims),
        np.dtype(dtype) if dtype is not None else None,
        split_every, combine, name, concatenate,
    )
    return new_collection(expr)


# -- trace ---------------------------------------------------------------------------


class _Diagonal(ArrayExpr):
    """``numpy.diagonal`` (dense), the diagonal as a new last axis in one
    block: just enough of ``routines.diagonal`` for :func:`trace`."""

    _parameters = ("array", "offset", "axis1", "axis2")

    @functools.cached_property
    def _length(self):
        n1, n2 = self.array.shape[self.axis1], self.array.shape[self.axis2]
        k = self.offset
        return builtins.max(0, builtins.min(n1, n2 - k) if k >= 0 else builtins.min(n1 + k, n2))

    @functools.cached_property
    def chunks(self):
        kept = tuple(c for ax, c in enumerate(self.array.chunks) if ax not in (self.axis1, self.axis2))
        return kept + ((self._length,),)

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.chunks), dtype=self.array.dtype)

    def _build(self, ctx):
        x = ctx.build(self.array).dense()
        dense = torch.diagonal(x, offset=self.offset, dim1=self.axis1, dim2=self.axis2)
        return BlockView(self.chunks, dense=dense)


def trace(a, offset=0, axis1=0, axis2=1, dtype=None):
    from dask_array_tpu_torch._collection import new_collection

    a = _coerce(a)
    ax1, ax2 = validate_axis(axis1, a.ndim), validate_axis(axis2, a.ndim)
    if ax1 == ax2:
        raise ValueError("axis1 and axis2 cannot be the same")
    diag = new_collection(_Diagonal(a.expr, int(offset), ax1, ax2))
    return diag.sum(axis=-1, dtype=dtype)


# ---------------------------------------------------------------------------
# quantiles: sort along the axis (NaN last, as numpy sorts) and gather
# ---------------------------------------------------------------------------


def _interpolate_index(n, q, alpha, beta):
    # numpy's _compute_virtual_index: n * q + (alpha + q * (1 - alpha - beta)) - 1
    return n * q + (alpha + q * (1 - alpha - beta)) - 1


def _discrete_index(index, prefer_previous):
    """numpy's _discret_interpolation_to_boundaries: the order statistic
    below ``index`` where the method's condition holds, else the one above."""
    previous = np.floor(index)
    following = previous + 1
    gamma = index - previous
    res = np.where(prefer_previous(gamma, index), previous, following).astype(np.intp)
    res[res < 0] = 0
    return res


# method -> (virtual index of (n, q), gamma fix of (gamma, index) or None);
# numpy's _QuantileMethods, computed with the same numpy operations
_QUANTILE_METHODS = {
    "inverted_cdf": (lambda n, q: _discrete_index(n * q - 1, lambda g, _: g == 0), None),
    "averaged_inverted_cdf": (lambda n, q: n * q - 1, lambda g, _: np.where(g == 0, 0.5, 1.0)),
    "closest_observation": (
        lambda n, q: _discrete_index(n * q - 1 - 0.5, lambda g, i: (g == 0) & (np.floor(i) % 2 == 1)), None),
    "interpolated_inverted_cdf": (lambda n, q: _interpolate_index(n, q, 0, 1), lambda g, _: g),
    "hazen": (lambda n, q: _interpolate_index(n, q, 0.5, 0.5), lambda g, _: g),
    "weibull": (lambda n, q: _interpolate_index(n, q, 0, 0), lambda g, _: g),
    "linear": (lambda n, q: (n - 1) * q, lambda g, _: g),
    "median_unbiased": (lambda n, q: _interpolate_index(n, q, 1 / 3.0, 1 / 3.0), lambda g, _: g),
    "normal_unbiased": (lambda n, q: _interpolate_index(n, q, 3 / 8.0, 3 / 8.0), lambda g, _: g),
    "lower": (lambda n, q: np.floor((n - 1) * q).astype(np.intp), None),
    "higher": (lambda n, q: np.ceil((n - 1) * q).astype(np.intp), None),
    "midpoint": (lambda n, q: 0.5 * (np.floor((n - 1) * q) + np.ceil((n - 1) * q)),
                 lambda g, i: np.where(i % 1 == 0, 0.0, 0.5)),
    "nearest": (lambda n, q: np.around((n - 1) * q).astype(np.intp), None),
}


def quantile_tables(method, q, counts, inexact):
    """numpy's order statistics and weights of quantiles ``q`` (a typed
    numpy array) in sorted slices of ``counts`` values (an int array), on
    the host with numpy's own arithmetic: its tie rules compare ``n * q``
    exactly, so the tables are not recomputed on the device.

    Returns (lower, upper, gamma), each (len(q), len(counts)); indices may
    be -1 (the slice's last value); gamma is None for a method whose index
    is an integer (one order statistic)."""
    index_of, fix_gamma = _QUANTILE_METHODS[method]
    q = q.reshape(-1, 1)
    n = np.asarray(counts).reshape(1, -1)
    # numpy's count is a Python int: weak against a float q
    n = n.astype(q.dtype) if q.dtype.kind == "f" else n
    index = np.asanyarray(index_of(n, q))
    if index.dtype.kind in "iu" or fix_gamma is None:
        index = np.broadcast_to(index, (q.shape[0], n.shape[1])).astype(np.intp)
        return index, index, None
    lower = np.floor(index)
    upper = lower + 1
    above = index >= n - 1
    lower[above] = upper[above] = -1
    below = index < 0
    lower[below] = upper[below] = 0
    if inexact:
        nan = np.isnan(index)
        lower[nan] = upper[nan] = -1
    lower, upper = lower.astype(np.intp), upper.astype(np.intp)
    gamma = np.asanyarray(fix_gamma(np.asanyarray(index - lower), index), dtype=index.dtype)
    return lower, upper, np.broadcast_to(gamma, lower.shape)


def _work_layout(x, axes):
    """``x`` with the reduced axes moved last and merged: (slices, n)."""
    kept = [d for d in range(x.ndim) if d not in axes]
    work = x.permute(*kept, *axes) if list(axes) != list(range(x.ndim - len(axes), x.ndim)) else x
    return work.reshape(-1, math.prod(x.shape[d] for d in axes)), [x.shape[d] for d in kept]


def _median_acc(dt):
    """numpy's mean dtype for the middle values: float32 for float16,
    float64 for integers and bools."""
    if dt.kind in "biu":
        return np.dtype(np.float64)
    return np.dtype(np.float32) if dt == np.float16 else dt


def _median_sorted(xs, counts, dt, out_dt):
    """numpy's median of each sorted row of ``xs`` over its first ``counts``
    values: the middle value, or the mean of the middle two; NaN where a
    row has none."""
    n = xs.shape[-1]
    acc = _median_acc(dt)
    cnt = torch.as_tensor(counts, device=xs.device).reshape(-1, 1).expand(xs.shape[0], 1)
    hi = torch.clamp(cnt // 2, max=builtins.max(n - 1, 0))
    lo = torch.clamp(cnt - 1 - cnt // 2, min=0)
    if n == 0:
        return torch.full((xs.shape[0],), math.nan, dtype=compute_dtype(out_dt), device=xs.device)
    a = to_compute(moved(torch.gather, xs, -1, lo), acc).reshape(-1)
    b = to_compute(moved(torch.gather, xs, -1, hi), acc).reshape(-1)
    cnt = cnt.reshape(-1)
    out = torch.where(cnt % 2 == 1, b, (a + b) / 2)
    out = out.to(compute_dtype(out_dt))
    return torch.where(cnt == 0, math.nan, out) if out.is_floating_point() or out.is_complex() else out


def _lerp_sorted(xs, counts, lower, upper, gamma, dt, out_dt):
    """numpy's quantiles of each sorted row of ``xs`` from the host tables
    (rows of ``lower``/``upper``/``gamma`` per quantile, columns per row or
    one column for every row): ``_lerp``'s two forms, switched at gamma
    0.5, the difference taken in the data's own dtype as numpy takes it."""
    device = xs.device
    cnt = torch.as_tensor(counts, device=device).reshape(1, -1)

    def take(index):
        idx = torch.as_tensor(np.ascontiguousarray(index), device=device)
        idx = torch.where(idx < 0, cnt + idx, idx).expand(index.shape[0], xs.shape[0])
        return moved(torch.gather, xs, -1, idx.T.contiguous())  # (rows, len(q))

    a = take(lower)
    if gamma is None:
        return to_compute(a, out_dt).T
    b = take(upper)
    diff = cast(computable(b) - computable(a), dt)
    t = np.ascontiguousarray(gamma.T)
    g = torch.as_tensor(t.astype(out_dt), device=device)
    g1 = torch.as_tensor((1 - t).astype(out_dt), device=device)
    high = torch.as_tensor(t >= 0.5, device=device)
    a, b, diff = (to_compute(v, out_dt) for v in (a, b, diff))
    return torch.where(high, b - diff * g1, a + diff * g).T


def quantile_dense(x, q, axes, method, kind, keepdims, out_dt):
    """numpy's median/nanmedian/quantile/nanquantile of the held block
    ``x`` over ``axes``: one sort along the merged axes (``sort_numpy``,
    NaN last; never ``torch.quantile``, which refuses more than 2**24
    values), then gathers by the host tables.  A nan-kind reduction of
    float data takes each row's count of non-NaN values to the host in one
    sync."""
    from dask_array_tpu_torch.ops._fancy_indexing import count_sync

    dt = numpy_dtype(x.dtype)
    work, kept = _work_layout(x, axes)
    xs = sort_numpy(work, dim=-1)
    n = xs.shape[-1]
    inexact = dt.kind in "fc"
    has_nan = None
    if kind.startswith("nan") and inexact:
        counts = (~torch.isnan(xs)).sum(dim=-1).cpu().numpy()
        count_sync()
    else:
        counts = np.array([n])
        if inexact and n:
            has_nan = torch.isnan(xs[:, -1])
    if kind.endswith("median"):
        out = _median_sorted(xs, counts, dt, out_dt)[None]
        lead = ()
    else:
        uniq, inverse = np.unique(counts, return_inverse=True)
        lower, upper, gamma = quantile_tables(method, q, uniq, inexact)
        cols = inverse.reshape(-1)
        lower, upper = lower[:, cols], upper[:, cols]
        gamma = None if gamma is None else gamma[:, cols]
        if n == 0:
            out = torch.full((q.size, xs.shape[0]), math.nan, dtype=compute_dtype(out_dt), device=x.device)
        else:
            out = _lerp_sorted(xs, counts if len(counts) > 1 else counts[:1], lower, upper, gamma, dt, out_dt)
        lead = q.shape
        if kind.startswith("nan") and inexact:
            empty = torch.as_tensor(counts == 0, device=x.device)
            out = torch.where(empty, math.nan, out)
    if has_nan is not None:
        out = torch.where(has_nan, to_compute(xs[:, -1], out_dt), out)
    out = out.reshape(lead + tuple(kept))
    if keepdims:
        for ax in sorted(axes):
            out = out.unsqueeze(len(lead) + ax)
    return as_stored(out, out_dt)


def _quantile_dtype(dt, q, method, kind):
    """numpy's result dtype (a probe of the installed numpy: its refusals
    raise here)."""
    probe = np.ones(3, dtype=dt)
    with np.errstate(all="ignore"):
        if kind.endswith("median"):
            return np.asarray(getattr(np, kind)(probe)).dtype
        return np.asarray(getattr(np, kind)(probe, q, method=method)).dtype


class Quantile(ArrayExpr):
    """numpy's median, nanmedian, quantile or nanquantile over ``axis`` (a
    tuple), every numpy method; ``q`` is numpy's typed quantile array (None
    for a median), whose dims lead the result's."""

    _parameters = ("array", "q", "axis", "method", "kind", "keepdims")

    def _name_prefix(self):
        return self.kind

    @functools.cached_property
    def chunks(self):
        base = []
        for ax, c in enumerate(self.array.chunks):
            if ax in self.axis:
                if self.keepdims:
                    base.append((1,))
            else:
                base.append(c)
        lead = () if self.q is None else tuple((s,) for s in self.q.shape)
        return lead + tuple(base)

    @functools.cached_property
    def _meta(self):
        dt = _quantile_dtype(self.array.dtype, self.q, self.method, self.kind)
        return np.empty((0,) * len(self.chunks), dtype=dt)

    def _build(self, ctx):
        x = ctx.build(self.array).dense()
        out = quantile_dense(x, self.q, self.axis, self.method, self.kind, self.keepdims, self.dtype)
        return BlockView(self.chunks, dense=out)


def _quantile_axes(ndim, axis):
    if axis is None:
        return tuple(range(ndim))
    axes = np.lib.array_utils.normalize_axis_tuple(axis, ndim)
    return tuple(sorted(axes))


def _quantile(a, q, axis, method, keepdims, kind, kwargs):
    from dask_array_tpu_torch._collection import new_collection

    if kwargs.pop("interpolation", None) is not None:
        warnings.warn("The `interpolation` argument to quantile was renamed to `method`.", FutureWarning,
                      stacklevel=3)
    if kwargs.pop("weights", None) is not None:
        raise NotImplementedError("weighted quantiles are not supported")
    kwargs.pop("overwrite_input", None)
    if kwargs:
        raise TypeError(f"unexpected arguments {sorted(kwargs)}")
    a = _coerce(a)
    if a.dtype.kind == "c" and kind.endswith("quantile"):
        raise TypeError("a must be an array of real numbers")
    if q is not None:
        if isinstance(q, (int, float)) and a.dtype.kind == "f":
            q = np.asanyarray(q, dtype=a.dtype)
        else:
            q = np.asanyarray(q)
        if not (np.all(q >= 0) and np.all(q <= 1)):
            raise ValueError("Quantiles must be in the range [0, 1]")
        if method not in _QUANTILE_METHODS:
            raise ValueError(f"'{method}' is not a valid method. Use one of: {sorted(_QUANTILE_METHODS)}")
    expr = Quantile(a.expr, q, _quantile_axes(a.ndim, axis), method, kind, bool(keepdims))
    expr._meta  # numpy's refusals (a bool quantile's difference) raise here
    return new_collection(expr)


def quantile(a, q, axis=None, method="linear", keepdims=False, **kwargs):
    return _quantile(a, q, axis, method, keepdims, "quantile", kwargs)


def nanquantile(a, q, axis=None, method="linear", keepdims=False, **kwargs):
    return _quantile(a, q, axis, method, keepdims, "nanquantile", kwargs)


def median(a, axis=None, keepdims=False, out=None, **kwargs):
    return handle_out(out, _quantile(a, None, axis, "linear", keepdims, "median", kwargs))


def nanmedian(a, axis=None, keepdims=False, out=None, **kwargs):
    return handle_out(out, _quantile(a, None, axis, "linear", keepdims, "nanmedian", kwargs))


def _percent(a, q):
    """numpy's percentile -> quantile conversion: q / 100, the divisor in
    the data's float dtype."""
    q = np.true_divide(q, a.dtype.type(100) if a.dtype.kind == "f" else 100)
    q = np.asanyarray(q)
    if not (np.all(q >= 0) and np.all(q <= 1)):
        raise ValueError("Percentiles must be in the range [0, 100]")
    return q


def _interp(x, xp, fp):
    """Linear interpolation of increasing ``xp`` as the JAX package's
    merge takes it (``jnp.interp``): the segment right of ``x``'s
    right-side position, a zero-width segment giving its left value, the
    ends held flat."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    flat = dx.abs() <= np.spacing(np.finfo(np.float64).eps)
    f = torch.where(flat, fp[i - 1], fp[i - 1] + ((x - xp[i - 1]) / torch.where(flat, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class ApproxPercentile(ArrayExpr):
    """The scalable approximate percentile of a 1-D array (dask's
    ``internal_method="dask"``/``"tdigest"``): each block's percentiles on
    a grid padded with 0 and 100, weighted by the block's length, merged by
    sorted cumulative counts."""

    _parameters = ("array", "q", "method")

    def _name_prefix(self):
        return "approx-percentile"

    @functools.cached_property
    def chunks(self):
        return ((len(self.q),),)

    @functools.cached_property
    def _meta(self):
        dt = self.array.dtype
        return np.empty((0,), dtype=np.dtype("f8") if dt.kind in "biu" else dt)

    def _build(self, ctx):
        view = ctx.build(self.array)
        q = np.asarray(self.q, dtype="f8")
        calc_q = np.pad(q, 1, mode="constant")
        calc_q[-1] = 100.0
        grid = calc_q / 100.0
        vals, weights = [], []
        for bi, n in enumerate(self.array.chunks[0]):
            if n == 0:
                continue
            block = cast(view.block((bi,)), self.dtype)
            vals.append(quantile_dense(block, grid, (0,), self.method, "quantile", False, self.dtype))
            c = np.empty(len(calc_q))
            c[0] = calc_q[0]
            c[1:] = np.diff(calc_q)
            weights.append(c * n)
        if not vals:
            raise ValueError("No non-trivial arrays found")
        total = builtins.sum(n for n in self.array.chunks[0])
        combined = torch.cat([computable(v) for v in vals])
        order = torch.argsort(combined, stable=True)
        combined = combined[order]
        cum = torch.cumsum(torch.as_tensor(np.concatenate(weights), device=combined.device)[order], 0)
        desired = torch.as_tensor(q * total, device=combined.device)
        if self.method == "linear":
            rv = _interp(desired, cum, combined.to(torch.float64))
        else:
            left = torch.searchsorted(cum, desired, right=False)
            right = torch.searchsorted(cum, desired, right=True) - 1
            left = torch.clamp(left, max=combined.numel() - 1)
            lower, upper = torch.minimum(left, right), torch.maximum(left, right)
            if self.method == "lower":
                rv = combined[lower]
            elif self.method == "higher":
                rv = combined[upper]
            elif self.method == "midpoint":
                rv = 0.5 * (combined[lower] + combined[upper])
            elif self.method == "nearest":
                lres, ures = (cum[lower] - desired).abs(), (cum[upper] - desired).abs()
                rv = torch.where(lres > ures, combined[upper], combined[lower])
            else:
                raise ValueError("interpolation method can only be 'linear', 'lower', 'higher', 'midpoint', or "
                                 "'nearest'")
        return BlockView(self.chunks, dense=cast(rv.to(compute_dtype(self.dtype)), self.dtype))


def percentile(a, q, method="linear", internal_method=None, **kwargs):
    """Percentiles of a 1-D array (dask's signature: a 1-D result, one value
    per q); an n-d array gives numpy's percentile.  ``internal_method``
    ``"dask"``/``"tdigest"`` takes the approximate merge of per-block
    percentiles (``ApproxPercentile``); otherwise the exact sort."""
    from dask_array_tpu_torch._collection import new_collection

    if "interpolation" in kwargs:
        warnings.warn("The `interpolation=` argument to percentile was renamed to `method=`", FutureWarning)
        method = kwargs.pop("interpolation")
    if method in ("default", "dask", "tdigest"):
        warnings.warn("The `method=` argument was renamed to `internal_method=`", FutureWarning)
        internal_method, method = method, "linear"
    a = _coerce(a)
    if a.ndim == 0:
        raise NotImplementedError("support for arrays of ndim 0 is not implemented.")
    if a.dtype.kind == "c":
        raise TypeError("a must be an array of real numbers")
    q01 = _percent(a, q)
    if a.ndim > 1:
        return quantile(a, q01, method=method, **kwargs)
    if internal_method in ("dask", "tdigest"):
        return new_collection(ApproxPercentile(a.expr, tuple(np.atleast_1d(np.asarray(q, "f8")).tolist()), method))
    kwargs.pop("axis", None)  # a 1-D array has one
    return quantile(a, np.atleast_1d(q01), axis=0, method=method, **kwargs)


def nanpercentile(a, q, method="linear", **kwargs):
    """numpy's nanpercentile: ``nanquantile`` of q / 100 (axis 0 for 1-D)."""
    if "interpolation" in kwargs:
        warnings.warn("The `interpolation=` argument to nanpercentile was renamed to `method=`", FutureWarning)
        method = kwargs.pop("interpolation")
    a = _coerce(a)
    if a.dtype.kind == "c":
        raise TypeError("a must be an array of real numbers")
    q01 = _percent(a, q)
    if a.ndim == 1 and "axis" not in kwargs:
        kwargs["axis"] = 0
    return nanquantile(a, q01, method=method, **kwargs)


__all__ = [
    "all",
    "median",
    "nanmedian",
    "nanpercentile",
    "nanquantile",
    "percentile",
    "quantile",
    "any",
    "arg_reduction",
    "argmax",
    "argmin",
    "cumprod",
    "cumreduction",
    "cumsum",
    "max",
    "mean",
    "min",
    "moment",
    "nanargmax",
    "nanargmin",
    "nancumprod",
    "nancumsum",
    "nanmax",
    "nanmean",
    "nanmin",
    "nanprod",
    "nanstd",
    "nansum",
    "nanvar",
    "prod",
    "reduction",
    "std",
    "sum",
    "trace",
    "var",
]
