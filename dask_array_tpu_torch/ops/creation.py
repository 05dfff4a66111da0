"""Array creation: constant sources, ranges, identity and diagonal
matrices, padding, tiling and index grids.

Port of ``dask_array_tpu/ops/creation.py``: ``BroadcastTrick`` constant
leaves with slice/rechunk absorption, the ``*_like`` functions, ``Arange``
and ``Linspace``, ``Eye``, ``diag``/``diagonal``, ``Tri``, ``Pad``,
``tile``, ``Repeat``, ``meshgrid``, ``indices`` and ``fromfunction``.
Constants, ranges and matrices are generated on the execution device, so
creation never touches the host.  ``pad``'s index-map and constant modes go
through ``kernels.halo.halo_pad`` (the halo kernel on the card); its other
modes are torch ops that follow numpy's ``pad`` step by step, and a
callable mode runs ``np.pad`` on the host.
"""

from __future__ import annotations

import functools
import math
from numbers import Integral

import numpy as np
import torch

from dask_array_tpu_torch._chunks import (
    INT64_MIN,
    argsort_numpy,
    array_of,
    as_stored,
    cached_cumsum,
    cast,
    computable,
    compute_dtype,
    format_of,
    host_only_dtype,
    normalize_chunks,
    sort_numpy,
    tensor_of,
    to_compute,
    torch_dtype,
    uint64_bits,
    validate_axis,
    value_of,
)
from dask_array_tpu_torch._executor import BlockView
from dask_array_tpu_torch._expr import ArrayExpr
from dask_array_tpu_torch._slicing import sliced_blockdim
from dask_array_tpu_torch.kernels.halo import halo_pad


class BroadcastTrick(ArrayExpr):
    """A constant-fill leaf: absorbs slices and rechunks outright."""

    takes_narrow = True

    _parameters = ("chunks_", "_dtype", "fill_value", "name_")
    _defaults = {"fill_value": None, "name_": None}

    _fusable_leaf = True

    def _collection_name(self):
        return self.operand("name_") or self._name

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.chunks_), dtype=self._dtype)

    def _build(self, ctx):
        # "empty": contents unspecified; zeros here
        fill = 0 if self.fill_value is None else self.fill_value
        dt = np.dtype(self._dtype)
        if host_only_dtype(dt):
            # records, strings, objects: numpy's constant, on the host lane
            dense = np.zeros(self.shape, dt) if self.fill_value is None else np.full(self.shape, fill, dt)
            return BlockView(self.chunks_, dense=dense)
        if dt.kind in "Mm":
            fill = int(np.asarray(fill).astype(dt).view(np.int64))  # the fill's ticks
        if dt == np.uint64:
            fill = uint64_bits(int(fill))
        if format_of(dt) is not None:
            # a narrow type's pattern, as numpy casts the fill (zeros and
            # empty are zero bytes, as numpy's: e8m0 has no zero)
            pattern = 0 if isinstance(self, (Zeros, Empty)) else _pattern(fill, dt)
            return BlockView(self.chunks_, dense=torch.full(self.shape, pattern, dtype=torch.uint8, device=ctx.device))
        dense = as_stored(torch.full(self.shape, fill, dtype=compute_dtype(self._dtype), device=ctx.device),
                          self._dtype)
        return BlockView(self.chunks_, dense=dense)

    def _accept_slice(self, index):
        new_chunks = []
        for ax, ind in enumerate(index):
            if isinstance(ind, Integral):
                continue
            if ind == slice(None):
                new_chunks.append(self.chunks_[ax])
            else:
                nc, _ = sliced_blockdim(self.chunks_[ax], ind)
                new_chunks.append(nc)
        return type(self)(tuple(new_chunks), self._dtype, self.fill_value)

    def _accept_rechunk(self, target_chunks):
        return type(self)(tuple(target_chunks), self._dtype, self.fill_value)


class Ones(BroadcastTrick):
    _defaults = {**BroadcastTrick._defaults, "fill_value": 1}


class Zeros(BroadcastTrick):
    _defaults = {**BroadcastTrick._defaults, "fill_value": 0}


class Empty(BroadcastTrick):
    _defaults = {**BroadcastTrick._defaults, "fill_value": None}


class Full(BroadcastTrick):
    pass


def _pattern(v, dt):
    """The byte of numpy's cast of ``v`` to the narrow dtype ``dt``."""
    with np.errstate(all="ignore"):
        return int(np.asarray(v).astype(dt).view(np.uint8))


def _wrap_shape(shape):
    if isinstance(shape, Integral):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _make(cls, shape, dtype, chunks, fill_value=None, name=None):
    from dask_array_tpu_torch._collection import new_collection

    shape = _wrap_shape(shape)
    dtype = np.dtype(dtype if dtype is not None else float)
    if not host_only_dtype(dtype):
        torch_dtype(dtype)  # refuse dtypes the port cannot compute in, now
    chunks = normalize_chunks(chunks, shape, dtype=dtype)
    if cls is Full:
        return new_collection(Full(chunks, dtype, fill_value, name))
    return new_collection(cls(chunks, dtype, name_=name))


def ones(shape, dtype=float, chunks="auto", name=None):
    return _make(Ones, shape, dtype, chunks, name=name)


def zeros(shape, dtype=float, chunks="auto", name=None):
    return _make(Zeros, shape, dtype, chunks, name=name)


def empty(shape, dtype=float, chunks="auto", name=None):
    return _make(Empty, shape, dtype, chunks, name=name)


def full(shape, fill_value, dtype=None, chunks="auto", name=None):
    if dtype is None:
        dtype = np.asarray(fill_value).dtype
    return _make(Full, shape, dtype, chunks, fill_value=fill_value, name=name)


class Arange(ArrayExpr):
    """Lazy arange, generated on the device."""

    takes_narrow = True

    _parameters = ("start", "stop", "step", "chunks_", "_dtype")

    _fusable_leaf = True

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        return np.empty((0,), dtype=self._dtype)

    def _build(self, ctx):
        # start + i * step in float64 (or int64), then one cast: the values
        # numpy's arange gives for the same arguments
        acc = torch.float64 if self._dtype.kind in "fc" or any(
            isinstance(v, float) for v in (self.start, self.step)
        ) else torch.int64
        idx = torch.arange(self.shape[0], dtype=acc, device=ctx.device)
        dense = cast(self.start + idx * self.step, self._dtype)
        return BlockView(self.chunks_, dense=dense)

    def _accept_slice(self, index):
        (ind,) = index
        if isinstance(ind, Integral):
            return None  # 0-d result; leave to generic slicing
        start, stop, step = ind.indices(self.shape[0])
        new_start = self.start + start * self.step
        new_step = self.step * step
        count = len(range(start, stop, step))
        nc, _ = sliced_blockdim(self.chunks_[0], ind)
        return Arange(new_start, new_start + count * new_step, new_step, (nc,), self._dtype)

    def _accept_rechunk(self, target_chunks):
        return Arange(self.start, self.stop, self.step, tuple(target_chunks), self._dtype)


def arange(start=0, stop=None, step=1, *, chunks="auto", dtype=None):
    from dask_array_tpu_torch._collection import new_collection

    if stop is None:
        start, stop = 0, start
    num = int(max(0, math.ceil((stop - start) / step)))
    if dtype is None:
        # numpy's arange dtype depends only on the argument types
        dtype = np.arange(type(start)(0), type(stop)(0), type(step)(1)).dtype
    dtype = np.dtype(dtype)
    if dtype.kind in "iu" and not (float(start).is_integer() and float(step).is_integer()):
        # numpy casts start/step to the requested int dtype first
        start, step = int(start), int(step)
        stop = start + num * step
    chunks = normalize_chunks(chunks, (num,), dtype=dtype)
    return new_collection(Arange(start, stop, step, chunks, dtype))


def _like(maker, a, dtype=None, chunks=None, shape=None, **kw):
    from dask_array_tpu_torch._collection import Array

    if shape is None:
        shape = a.shape
    elif isinstance(shape, Integral):
        shape = (int(shape),)
    if dtype is None:
        dtype = a.dtype
    if chunks is None:
        chunks = a.chunks if isinstance(a, Array) and tuple(shape) == tuple(a.shape) else "auto"
    return maker(shape, dtype=dtype, chunks=chunks, **kw)


def _check_like_order(order):
    # device tensors are laid out in C order; "F" would lie about strides
    if order not in (None, "C", "K", "A"):
        raise NotImplementedError(f"order={order!r} is not supported (C layout only)")


def ones_like(a, dtype=None, order="C", chunks=None, name=None, shape=None):
    _check_like_order(order)
    return _like(ones, a, dtype, chunks, shape, name=name)


def zeros_like(a, dtype=None, order="C", chunks=None, name=None, shape=None):
    _check_like_order(order)
    return _like(zeros, a, dtype, chunks, shape, name=name)


def empty_like(a, dtype=None, order="C", chunks=None, name=None, shape=None):
    _check_like_order(order)
    return _like(empty, a, dtype, chunks, shape, name=name)


def full_like(a, fill_value, dtype=None, order="C", chunks=None, name=None, shape=None):
    _check_like_order(order)
    if dtype is None and hasattr(a, "dtype"):
        dtype = a.dtype
    return _like(full, a, dtype, chunks, shape, fill_value=fill_value, name=name)


class Linspace(ArrayExpr):
    _parameters = ("start", "stop", "num", "endpoint", "chunks_", "_dtype")

    _fusable_leaf = True

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        return np.empty((0,), dtype=self._dtype)

    @property
    def _step(self):
        div = (self.num - 1) if self.endpoint else self.num
        return (self.stop - self.start) / max(1, div)

    def _build(self, ctx):
        idx = torch.arange(self.num, dtype=torch.float64, device=ctx.device)
        dense = cast(self.start + idx * self._step, self._dtype)
        return BlockView(self.chunks_, dense=dense)

    def _accept_rechunk(self, target_chunks):
        return Linspace(self.start, self.stop, self.num, self.endpoint, tuple(target_chunks), self._dtype)

    def _accept_slice(self, index):
        """A sliced linspace is an arithmetic progression: an ``Arange`` with
        the composed start and step (the same ``start + idx * step``, so the
        values match exactly).  The length comes from the sliced chunk grid,
        never from the float stop."""
        (ind,) = index
        if isinstance(ind, Integral):
            return None
        start, stop, step = ind.indices(self.num)
        st = self._step
        new_start = self.start + start * st
        new_step = st * step
        count = len(range(start, stop, step))
        nc, _ = sliced_blockdim(self.chunks_[0], ind)
        return Arange(new_start, new_start + count * new_step, new_step, (tuple(nc),), self._dtype)


def linspace(start, stop, num=50, endpoint=True, retstep=False, chunks="auto", dtype=None):
    from dask_array_tpu_torch._collection import new_collection

    num = int(num)
    dtype = np.dtype(np.linspace(0, 1, 1).dtype if dtype is None else dtype)
    chunks = normalize_chunks(chunks, (num,), dtype=dtype)
    expr = Linspace(float(start), float(stop), num, bool(endpoint), chunks, dtype)
    arr = new_collection(expr)
    if retstep:
        return arr, expr._step
    return arr


class Eye(ArrayExpr):
    _parameters = ("N", "M", "k", "chunks_", "_dtype")

    _fusable_leaf = True

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        return np.empty((0, 0), dtype=self._dtype)

    def _build(self, ctx):
        rows = torch.arange(self.N, device=ctx.device)[:, None]
        cols = torch.arange(self.M, device=ctx.device)[None, :]
        dense = cast(cols - rows == self.k, self._dtype)
        return BlockView(self.chunks_, dense=dense)

    def _accept_rechunk(self, target_chunks):
        return Eye(self.N, self.M, self.k, tuple(target_chunks), self._dtype)


def eye(N, chunks="auto", M=None, k=0, dtype=float):
    from dask_array_tpu_torch._collection import new_collection

    if M is None:
        M = N
    dtype = np.dtype(dtype)
    ch = normalize_chunks(chunks, (int(N), int(M)), dtype=dtype)
    return new_collection(Eye(int(N), int(M), int(k), ch, dtype))


class Diag1D(ArrayExpr):
    """diag(v) for 1-d v: the k-offset diagonal matrix."""

    _parameters = ("array", "k")

    @functools.cached_property
    def chunks(self):
        c = self.array.chunks[0]
        if self.k == 0:
            return (c, c)
        n = self.array.shape[0] + abs(self.k)
        return ((n,), (n,))

    @functools.cached_property
    def _meta(self):
        return np.empty((0, 0), dtype=self.array.dtype)

    def _build(self, ctx):
        v = ctx.build(self.array).dense()
        return BlockView(self.chunks, dense=torch.diag(v, self.k))


class Diagonal(ArrayExpr):
    takes_narrow = True

    _parameters = ("array", "offset", "axis1", "axis2")

    @functools.cached_property
    def chunks(self):
        arr = self.array
        a1, a2 = self.axis1, self.axis2
        n1, n2 = arr.shape[a1], arr.shape[a2]
        k = self.offset
        length = max(0, min(n1 + min(0, k), n2 - max(0, k)))
        # diagonal chunk boundaries: the union of the row and column
        # boundaries projected onto the diagonal
        b1 = set(cached_cumsum(arr.chunks[a1], initial_zero=True))
        b2 = {b - k for b in cached_cumsum(arr.chunks[a2], initial_zero=True)}
        start = max(0, -k)
        cuts = sorted({min(max(b - start, 0), length) for b in (b1 | b2)})
        out = tuple(b - a for a, b in zip(cuts[:-1], cuts[1:]) if b > a) or (0,)
        other = tuple(c for ax, c in enumerate(arr.chunks) if ax not in (a1, a2))
        return other + (out,)

    @property
    def _meta(self):
        return np.empty((0,) * (self.array.ndim - 1), dtype=self.array.dtype)

    def _build(self, ctx):
        dense = ctx.build(self.array).dense()
        out = torch.diagonal(dense, offset=self.offset, dim1=self.axis1, dim2=self.axis2)
        return BlockView(self.chunks, dense=out)


def diag(v, k=0):
    from dask_array_tpu_torch._collection import new_collection
    from dask_array_tpu_torch.ops._from_array import asarray

    v = asarray(v)
    if v.ndim == 1:
        return new_collection(Diag1D(v.expr, int(k)))
    if v.ndim == 2:
        return diagonal(v, offset=k)
    raise ValueError("Array must be 1d or 2d only")


def diagonal(a, offset=0, axis1=0, axis2=1):
    from dask_array_tpu_torch._collection import new_collection
    from dask_array_tpu_torch.ops._from_array import asarray

    a = asarray(a)
    if a.ndim < 2:
        raise ValueError("diag requires an array of at least two dimensions")
    axis1 = validate_axis(axis1, a.ndim)
    axis2 = validate_axis(axis2, a.ndim)
    if axis1 == axis2:
        raise ValueError("axis1 and axis2 cannot be the same")
    return new_collection(Diagonal(a.expr, int(offset), axis1, axis2))


class Tri(ArrayExpr):
    _parameters = ("N", "M", "k", "chunks_", "_dtype")

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        return np.empty((0, 0), dtype=self._dtype)

    def _build(self, ctx):
        rows = torch.arange(self.N, device=ctx.device)[:, None]
        cols = torch.arange(self.M, device=ctx.device)[None, :]
        dense = cast(cols - rows <= self.k, self._dtype)
        return BlockView(self.chunks_, dense=dense)


def tri(N, M=None, k=0, dtype=float, chunks="auto"):
    from dask_array_tpu_torch._collection import new_collection

    if M is None:
        M = N
    dtype = np.dtype(dtype)
    ch = normalize_chunks(chunks, (int(N), int(M)), dtype=dtype)
    return new_collection(Tri(int(N), int(M), int(k), ch, dtype))


# ---------------------------------------------------------------------------
# pad
# ---------------------------------------------------------------------------


def _as_pairs(x, ndim):
    """numpy's ``_as_pairs``: ``x`` broadcast to one (before, after) pair
    per axis (a scalar, one pair for every axis, or one entry per axis)."""
    if x is None:
        return ((None, None),) * ndim
    x = np.array(x)
    if x.ndim < 3:
        if x.size == 1:
            x = x.ravel()
            return ((x[0], x[0]),) * ndim
        if x.size == 2 and x.shape != (2, 1):
            x = x.ravel()
            return ((x[0], x[1]),) * ndim
    return np.broadcast_to(x, (ndim, 2)).tolist()


def _at(axis, ind, ndim):
    return (slice(None),) * axis + (ind,) + (slice(None),) * (ndim - axis - 1)


def _pad_by_steps(x, widths, mode, kw, dt):
    """numpy's ``pad`` for the modes that are no index map ("linear_ramp",
    "maximum", "mean", "median", "minimum", "empty", and "reflect" /
    "symmetric" with ``reflect_type="odd"``), step by step as numpy does:
    an empty padded tensor with ``x`` (a block of numpy dtype ``dt`` in its
    compute dtype) in its centre, then one axis at a time on the region
    that axes before it have already padded.  The result is in the compute
    dtype of ``dt``."""
    nd = x.ndim
    shape = [n + lo + hi for n, (lo, hi) in zip(x.shape, widths)]
    padded = torch.zeros(shape, dtype=x.dtype, device=x.device)
    centre = tuple(slice(lo, lo + n) for n, (lo, _hi) in zip(x.shape, widths))
    padded[centre] = x
    if mode == "empty":
        return padded  # contents unspecified: zeros here
    for axis, (lo, hi) in enumerate(widths):
        if not (lo or hi):
            continue
        roi = padded[(slice(None),) * (axis + 1) + centre[axis + 1:]]
        n = x.shape[axis]
        if mode in ("reflect", "symmetric"):
            _reflect_odd(roi, axis, lo, hi, n, mode == "symmetric")
        elif mode == "linear_ramp":
            end_lo, end_hi = _as_pairs(kw.get("end_values", 0), nd)[axis]
            for width, end, edge_at, sl in ((lo, end_lo, lo, slice(0, lo)),
                                            (hi, end_hi, lo + n - 1, slice(lo + n, lo + n + hi))):
                if width:
                    edge = roi[_at(axis, slice(edge_at, edge_at + 1), nd)]
                    ramp = _linear_ramp(end, edge, width, axis, dt)
                    roi[_at(axis, sl, nd)] = ramp.flip(axis) if sl.start else ramp
        else:
            length_lo, length_hi = _as_pairs(kw.get("stat_length"), nd)[axis]
            stats = []
            for length, first in ((length_lo, True), (length_hi, False)):
                length = n if length is None or length > n else int(round(length))
                if length == 0 and mode in ("maximum", "minimum"):
                    raise ValueError("stat_length of 0 yields no value for padding")
                part = roi[_at(axis, slice(lo, lo + length) if first else slice(lo + n - length, lo + n), nd)]
                stats.append(_stat(part, mode, axis, dt))
            roi[_at(axis, slice(0, lo), nd)] = stats[0]
            roi[_at(axis, slice(lo + n, lo + n + hi), nd)] = stats[1]
    return padded


def _linear_ramp(end, edge, width, axis, dt):
    """numpy's ``linspace(end, edge, width, endpoint=False, dtype=dt)``
    along ``axis`` in ``dt``'s compute dtype: in numpy's working dtype (the
    result type of the end value and the edge, made inexact), ``i * step +
    end``, or ``i / width * delta + end`` when any step is 0; floored for
    integers."""
    wdt = np.linspace(end, np.zeros((), dt), 2, endpoint=False).dtype
    edge_w = to_compute(as_stored(edge, dt), wdt)
    end_w = torch.as_tensor(np.asarray(end, dtype=wdt), device=edge.device)
    delta = edge_w - end_w
    step = _numpy_div(delta, width)
    shape = [1] * edge.ndim
    shape[axis] = width
    i = torch.arange(width, device=edge.device).to(compute_dtype(wdt))  # numpy's arange in the working dtype
    i = i.reshape(shape)
    ramp = torch.where((step == 0).any(), _numpy_div(i, width) * delta, i * step) + end_w
    if dt.kind in "iu":
        ramp = torch.floor(ramp)
    return to_compute(ramp, dt)


_FLOAT_MEAN = {np.dtype(np.float16): np.dtype(np.float32)}  # numpy's sum dtype of a mean


def _pairwise(t):
    """numpy's pairwise sum along the last axis (``pairwise_sum``: under 8
    values one by one from -0.0, up to 128 in eight interleaved sums, else
    the two halves, a multiple of 8 first).  numpy counts a complex value
    as two: under 4 values one by one, up to 64 in four sums, halves cut
    at a multiple of 4."""
    k = 4 if t.is_complex() else 8
    n = t.shape[-1]
    if n < k:
        acc = torch.full(t.shape[:-1], -0.0, dtype=t.dtype, device=t.device)
        for i in range(n):
            acc = acc + t[..., i]
        return acc
    if n <= 16 * k:
        r = t[..., :k]
        m = n - n % k
        for i in range(k, m, k):
            r = r + t[..., i:i + k]
        res = (r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])
        if k == 8:
            res = res + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
        for i in range(m, n):
            res = res + t[..., i]
        return res
    half = (n - n % 8) // 2 if k == 4 else n // 2 - (n // 2) % 8
    return _pairwise(t[..., :half]) + _pairwise(t[..., half:])


def _numpy_sum(t, axis):
    """numpy's ``add.reduce(t, axis, keepdims=True)`` in numpy's order for a
    C-ordered block: pairwise along the last axis, else one value after
    another (a float64 cumulative sum, exact in order on the CPU; float32
    added one row at a time)."""
    if axis == t.ndim - 1:
        return _pairwise(t).unsqueeze(-1)
    n = t.shape[axis]
    if t.dtype in (torch.float64, torch.complex128):
        return torch.cumsum(t, axis).narrow(axis, n - 1, 1)
    acc = t.narrow(axis, 0, 1)
    for i in range(1, n):
        acc = acc + t.narrow(axis, i, 1)
    return acc


def _numpy_mean(t, axis):
    """numpy's mean over ``axis`` (kept) of ``t`` in its sum dtype: the sum
    in numpy's order, divided by the count (an intp: in float64 or
    complex128) and rounded back."""
    wide = torch.complex128 if t.is_complex() else torch.float64
    return _numpy_div(_numpy_sum(t, axis).to(wide), t.shape[axis]).to(t.dtype)


def _numpy_div(t, n):
    """numpy's ``t / n`` for an integer ``n``: a real value divided by it
    (a 0-d tensor on t's device: torch's CUDA division by a Python number
    multiplies by its reciprocal), a complex one times its reciprocal, as
    numpy's complex division by a real divisor does."""
    if t.is_complex():
        return t * (1.0 / n)
    return t / torch.tensor(n, dtype=t.dtype, device=t.device)


def _stat(part, mode, axis, dt):
    """numpy's statistic of ``part`` (a compute block of numpy dtype
    ``dt``) over ``axis`` (kept), as numpy assigns it to the pad: rounded
    for integers, nonzero for bool."""
    if mode in ("maximum", "minimum"):
        return _extreme(part, axis, dt, mode == "maximum")
    held = as_stored(part, dt)
    work = np.dtype(np.float64) if dt.kind in "biu" else _FLOAT_MEAN.get(dt, dt)
    if mode == "mean":
        out = _numpy_mean(to_compute(held, work), axis)
    else:  # median: numpy's mean of the middle one or two in order, NaN where the sort ends in one
        s = sort_numpy(held, axis)
        k = s.shape[axis]
        mid = to_compute(s.narrow(axis, (k - 1) // 2, 2 - k % 2), work)
        out = _numpy_mean(mid, axis) if k % 2 == 0 else mid
        last = to_compute(s.narrow(axis, k - 1, 1), work)
        if last.is_floating_point() or last.is_complex():
            out = torch.where(torch.isnan(last), last, out)
    if dt.kind in "iu":
        out = torch.round(out)
    return to_compute(out, dt)


def _extreme(part, axis, dt, largest):
    """numpy's ``amax``/``amin`` over ``axis`` (kept): uint64 in unsigned
    order, complex lexicographically with the first NaN winning, NaN
    propagated for floats."""
    if dt == np.uint64:
        flip = part ^ INT64_MIN
        return (flip.amax(axis, keepdim=True) if largest else flip.amin(axis, keepdim=True)) ^ INT64_MIN
    if not part.is_complex():
        return part.amax(axis, keepdim=True) if largest else part.amin(axis, keepdim=True)
    order = argsort_numpy(part, axis)
    pick = order.narrow(axis, part.shape[axis] - 1 if largest else 0, 1)
    nan = torch.isnan(part.real) | torch.isnan(part.imag)
    first_nan = nan.to(torch.uint8).argmax(axis, keepdim=True)
    pick = torch.where(nan.any(axis, keepdim=True), first_nan, pick)
    return torch.gather(part, axis, pick)


def _odd(edge, chunk):
    """``2 * edge - chunk`` as numpy computes it (bool in int64)."""
    if chunk.dtype == torch.bool:
        edge, chunk = edge.to(torch.int64), chunk.to(torch.int64)
    return 2 * edge - chunk


def _reflect_odd(roi, axis, lo, hi, n, include_edge):
    """numpy's ``_set_reflect_both`` loop with ``reflect_type="odd"`` on a
    torch view: each pass reflects what is already there about the current
    edge, ``2 * edge - reflected``, until the pad is filled."""
    nd = roi.ndim
    if n == 1:  # numpy extends a singleton axis by its edge
        roi[_at(axis, slice(0, lo), nd)] = roi[_at(axis, slice(lo, lo + 1), nd)]
        roi[_at(axis, slice(lo + n, lo + n + hi), nd)] = roi[_at(axis, slice(lo, lo + 1), nd)]
        return
    total = roi.shape[axis]
    while lo > 0 or hi > 0:
        old = total - hi - lo
        if include_edge:
            old = old // n * n
            offset = 1
        else:
            old = (old - 1) // (n - 1) * (n - 1) + 1 - 1
            offset = 0
        if lo > 0:
            length = min(old, lo)
            stop = lo - offset
            chunk = roi[_at(axis, slice(stop + 1, stop + length + 1), nd)].flip(axis)
            chunk = _odd(roi[_at(axis, slice(lo, lo + 1), nd)], chunk)
            roi[_at(axis, slice(lo - length, lo), nd)] = chunk
            lo -= length
        if hi > 0:
            length = min(old, hi)
            start = total - hi + offset - 2  # numpy's negative start, as a position
            chunk = roi[_at(axis, slice(start - length + 1, start + 1), nd)].flip(axis)
            edge = roi[_at(axis, slice(total - hi - 1, total - hi), nd)]
            roi[_at(axis, slice(total - hi, total - hi + length), nd)] = _odd(edge, chunk)
            hi -= length


_INDEX_MODES = ("edge", "wrap", "reflect", "symmetric")


class Pad(ArrayExpr):
    takes_narrow = True

    _parameters = ("array", "pad_width", "mode", "kwargs")
    _defaults = {"kwargs": ()}

    @functools.cached_property
    def chunks(self):
        # pad bands follow the adjacent edge chunk's size instead of gluing
        # into one band chunk: padding must not degrade the axis chunk profile
        def band(width, edge, lo_side):
            if edge <= 0:
                return [width]
            k, rem = divmod(width, edge)
            pieces = [edge] * k
            if rem:
                pieces = [rem] + pieces if lo_side else pieces + [rem]
            return pieces

        out = []
        for ax, c in enumerate(self.array.chunks):
            lo, hi = self.pad_width[ax]
            axis = list(c)
            if lo:
                axis = band(lo, c[0] if c else 0, True) + axis
            if hi:
                axis = axis + band(hi, c[-1] if c else 0, False)
            out.append(tuple(axis) or (0,))
        return tuple(out)

    @property
    def _meta(self):
        return self.array._meta

    def _build(self, ctx):
        dense = ctx.build(self.array).dense()
        kw = dict(self.kwargs or ())
        widths = self.pad_width
        mode = self.mode
        if not isinstance(dense, torch.Tensor):
            # a host block (records, strings, objects): numpy's pad
            return BlockView(self.chunks, dense=np.pad(dense, widths, mode, **kw))
        if self.dtype.kind in "Mm" and "constant_values" in kw:
            # datetime ticks: the fill values in the array's unit
            kw["constant_values"] = _ticks(kw["constant_values"], self.dtype)
        if callable(mode):
            # a function mode is arbitrary host code
            out = tensor_of(np.pad(array_of(dense.cpu(), self.dtype), widths, mode, **kw)).to(dense.device)
        elif mode == "constant":
            fills = [tuple(p) for p in _as_pairs(kw.get("constant_values", 0), dense.ndim)]
            if format_of(self.dtype) is not None:
                # a narrow type's fill as its pattern, as numpy casts it
                fills = [tuple(_pattern(v, self.dtype) for v in p) for p in fills]
            out = halo_pad(dense, widths, fills)
        elif mode in _INDEX_MODES and kw.get("reflect_type", "even") == "even":
            out = halo_pad(dense, widths, [mode] * dense.ndim)
        else:
            out = _pad_by_steps(computable(value_of(dense, self.dtype)), widths, mode, kw, self.dtype)
        return BlockView(self.chunks, dense=cast(out, self.dtype))


def _ticks(v, dt):
    if isinstance(v, (tuple, list)):
        return type(v)(_ticks(x, dt) for x in v)
    return int(np.asarray(v).astype(dt).view(np.int64))


_PAD_KWARGS = {
    "constant": {"constant_values"}, "edge": set(), "wrap": set(), "empty": set(),
    "linear_ramp": {"end_values"}, "maximum": {"stat_length"}, "mean": {"stat_length"},
    "median": {"stat_length"}, "minimum": {"stat_length"},
    "reflect": {"reflect_type"}, "symmetric": {"reflect_type"},
}


def pad(array, pad_width, mode="constant", **kwargs):
    from dask_array_tpu_torch._collection import new_collection
    from dask_array_tpu_torch.ops._from_array import asarray

    array = asarray(array)
    # normalize pad_width to ((lo, hi), ...) per axis
    pw = np.asarray(pad_width)
    if pw.ndim == 0:
        norm = tuple((int(pw), int(pw)) for _ in range(array.ndim))
    elif pw.ndim == 1 and pw.shape == (2,):
        norm = tuple((int(pw[0]), int(pw[1])) for _ in range(array.ndim))
    elif pw.ndim == 1:
        norm = tuple((int(x), int(x)) for x in pw)
    else:
        norm = tuple((int(lo), int(hi)) for lo, hi in pw)
    if len(norm) != array.ndim:
        raise ValueError("pad_width does not match array ndim")
    if any(lo < 0 or hi < 0 for lo, hi in norm):
        raise ValueError("index can't contain negative values")
    if not callable(mode):
        if mode not in _PAD_KWARGS:
            raise ValueError(f"mode '{mode}' is not supported")
        unsupported = set(kwargs) - _PAD_KWARGS[mode]
        if unsupported:
            raise ValueError(f"unsupported keyword arguments for mode '{mode}': {unsupported}")
    if all(lo == 0 and hi == 0 for lo, hi in norm):
        # a 0-width pad is the identity: the input collection itself
        return array
    kw = tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in kwargs.items()))
    return new_collection(Pad(array.expr, norm, mode, kw))


# ---------------------------------------------------------------------------
# tile / repeat / meshgrid / indices / fromfunction
# ---------------------------------------------------------------------------


def tile(A, reps):
    from dask_array_tpu_torch.ops._from_array import asarray
    from dask_array_tpu_torch.ops.manipulation import expand_dims
    from dask_array_tpu_torch.ops.stacking import concatenate

    A = asarray(A)
    if isinstance(reps, Integral):
        reps = (reps,)
    reps = tuple(int(r) for r in reps)
    if any(r < 0 for r in reps):
        raise ValueError("negative dimensions are not allowed")
    while A.ndim < len(reps):  # prepend length-1 axes
        A = expand_dims(A, 0)
    reps = (1,) * (A.ndim - len(reps)) + reps
    out = A
    for ax, r in enumerate(reps):
        if r == 0:
            out = out[_at(ax, slice(0, 0), out.ndim)]
        elif r > 1:
            out = concatenate([out] * r, axis=ax)
    return out


class Repeat(ArrayExpr):
    takes_narrow = True

    _parameters = ("array", "repeats", "axis")

    @functools.cached_property
    def chunks(self):
        out = list(self.array.chunks)
        out[self.axis] = tuple(c * self.repeats for c in out[self.axis])
        return tuple(out)

    @property
    def _meta(self):
        return self.array._meta

    def _build(self, ctx):
        dense = ctx.build(self.array).dense()
        return BlockView(self.chunks, dense=torch.repeat_interleave(dense, self.repeats, dim=self.axis))


def repeat(a, repeats, axis=None):
    from dask_array_tpu_torch._collection import new_collection
    from dask_array_tpu_torch.ops._from_array import asarray

    a = asarray(a)
    if axis is None:
        a = a.ravel() if a.ndim != 1 else a
        axis = 0
    axis = validate_axis(axis, a.ndim)
    if not isinstance(repeats, Integral):
        # one count per element: a take of the repeated positions, the
        # counts checked on the host as numpy checks them
        from dask_array_tpu_torch.ops._fancy_indexing import take

        counts = np.asarray(repeats)
        if counts.ndim == 0:
            return repeat(a, int(counts), axis)
        n = a.shape[axis]
        if counts.ndim != 1 or counts.shape[0] not in (1, n):
            raise ValueError(f"operands could not be broadcast together with shape ({n},) ({counts.shape[0]},)")
        if counts.dtype.kind not in "iub":
            raise TypeError(f"Cannot cast array data from {counts.dtype} to int64 according to the rule 'safe'")
        if (counts < 0).any():
            raise ValueError("repeats may not contain negative values.")
        return take(a, np.repeat(np.arange(n, dtype=np.int64), np.broadcast_to(counts, (n,))), axis=axis)
    if repeats < 0:
        raise ValueError("repeats may not contain negative values.")
    return new_collection(Repeat(a.expr, int(repeats), axis))


def meshgrid(*xi, sparse=False, indexing="xy", **kwargs):
    from dask_array_tpu_torch.ops._from_array import asarray
    from dask_array_tpu_torch.ops.manipulation import broadcast_to

    xi = [asarray(x) for x in xi]
    if indexing not in ("ij", "xy"):
        raise ValueError("indexing must be 'ij' or 'xy'")
    ndim = len(xi)
    order = list(range(ndim))
    if indexing == "xy" and ndim > 1:
        order[0], order[1] = order[1], order[0]
    shapes = [xi[i].shape[0] if xi[i].ndim else 1 for i in range(ndim)]
    full_shape = tuple(shapes[order[d]] for d in range(ndim))
    out = []
    for i, x in enumerate(xi):
        pos = order.index(i)
        xr = x.reshape(tuple(x.shape[0] if d == pos else 1 for d in range(ndim)))
        out.append(xr if sparse else broadcast_to(xr, full_shape))
    return out


def indices(dimensions, dtype=int, chunks="auto"):
    from dask_array_tpu_torch.ops._from_array import from_array
    from dask_array_tpu_torch.ops.manipulation import broadcast_to
    from dask_array_tpu_torch.ops.stacking import stack

    dimensions = tuple(int(d) for d in dimensions)
    grids = []
    for i, d in enumerate(dimensions):
        if isinstance(chunks, (tuple, list)) and len(chunks) == len(dimensions):
            axis_chunks = chunks[i]  # per-axis spec: this axis's entry
        else:
            axis_chunks = chunks
        r = arange(d, dtype=dtype, chunks=axis_chunks)
        shape_i = tuple(d if j == i else 1 for j in range(len(dimensions)))
        grids.append(broadcast_to(r.reshape(shape_i), dimensions))
    if not grids:
        return from_array(np.empty((0,), dtype=dtype))
    return stack(grids, axis=0)


def fromfunction(func, shape=None, chunks="auto", dtype=float, **kwargs):
    from dask_array_tpu_torch._blockwise import elemwise

    idx = indices(shape, dtype=dtype, chunks=chunks)
    return elemwise(lambda *ix: func(*ix, **kwargs), *[idx[i] for i in range(len(shape))])
