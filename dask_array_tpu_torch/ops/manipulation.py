"""Shape manipulation: transpose, squeeze, expand_dims, broadcast_to, flips.

Port of ``dask_array_tpu/ops/manipulation.py`` without its host lanes
(masked/duck blocks), the ``ExpandDims`` fold into ``FromMap`` leaves and
the shuffle hooks.  A transpose that swaps the last two axes and keeps the
leading ones in place goes through ``kernels/transpose.py`` (the tiled
transpose kernel on a GPU), so its result is laid out, not a strided view;
every other permutation is a ``permute`` view.  Reshape lives in
``ops/_reshape.py``.
"""

from __future__ import annotations

import functools
from numbers import Integral

import numpy as np
import torch

from dask_array_tpu_torch import _host
from dask_array_tpu_torch._blockwise import Blockwise, _NHEAD
from dask_array_tpu_torch._chunks import validate_axis
from dask_array_tpu_torch._executor import BlockView
from dask_array_tpu_torch._expr import ArrayExpr
from dask_array_tpu_torch._slicing import Slice, is_basic_index, normalize_slice
from dask_array_tpu_torch.kernels.transpose import transpose_last2


def _swaps_last2(axes) -> bool:
    nd = len(axes)
    return nd >= 2 and tuple(axes) == (*range(nd - 2), nd - 1, nd - 2)


def _transpose_fn(block, axes=None):
    if _host.is_host_block(block):
        return np.transpose(block, axes)
    if _swaps_last2(axes):
        return transpose_last2(block)
    return block.permute(axes)


class Transpose(Blockwise):
    """Axis permutation as a blockwise op with permuted block coordinates."""

    takes_narrow = True

    _pushdown_gate = "_transpose_pushdown"

    @property
    def array(self):
        return self.operands[_NHEAD]

    @property
    def axes(self):
        return self.out_ind

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * self.array.ndim, dtype=self.array.dtype)

    def _lower(self):
        return None  # no alignment needed: single operand

    def _simplify_down(self):
        if self.axes == tuple(range(self.array.ndim)):
            return self.array
        if type(self.array) is Transpose:
            inner = self.array
            composed = tuple(inner.axes[a] for a in self.axes)
            return make_transpose(inner.array, composed)
        return None

    def _build(self, ctx):
        dense = ctx.build(self.array).dense()
        return BlockView(self.chunks, dense=_transpose_fn(dense, self.axes))

    def _accept_rechunk(self, target_chunks):
        from dask_array_tpu_torch._rechunk import Rechunk

        # rechunk(transpose(x)) == transpose(rechunk(x, inverse-permuted))
        inner_target = [None] * len(self.axes)
        for out_pos, in_ax in enumerate(self.axes):
            inner_target[in_ax] = tuple(target_chunks[out_pos])
        return make_transpose(Rechunk(self.array, tuple(inner_target)), self.axes)

    def _accept_slice(self, index):
        if not is_basic_index(index):
            return None
        axes = self.axes
        inner_index = [slice(None)] * len(axes)
        for out_pos, ind in enumerate(index):
            inner_index[axes[out_pos]] = ind
        sliced = Slice(self.array, tuple(inner_index))
        # integer indices drop axes: recompute the permutation on kept axes
        dropped = {axes[p] for p, ind in enumerate(index) if isinstance(ind, Integral)}
        kept_in = [a for a in range(len(axes)) if a not in dropped]
        remap = {a: i for i, a in enumerate(kept_in)}
        new_axes = tuple(remap[a] for a in axes if a not in dropped)
        if new_axes == tuple(range(len(new_axes))):
            return sliced
        return make_transpose(sliced, new_axes)


def make_transpose(expr: ArrayExpr, axes: tuple) -> ArrayExpr:
    axes = tuple(int(a) for a in axes)
    if axes == tuple(range(expr.ndim)):
        return expr
    return Transpose(
        _transpose_fn,
        axes,  # out_ind = axes (out dim i carries input axis axes[i])
        "transpose",
        expr.dtype,
        None,
        None,
        True,
        (("axes", axes),),
        expr,
        tuple(range(expr.ndim)),
    )


def transpose(a, axes=None):
    from dask_array_tpu_torch._collection import Array, new_collection

    expr = a.expr if isinstance(a, Array) else a
    if axes is None:
        axes = tuple(range(expr.ndim))[::-1]
    else:
        axes = tuple(validate_axis(ax, expr.ndim) for ax in axes)
        if len(set(axes)) != expr.ndim:
            raise ValueError("axes don't match array")
    if isinstance(a, Array) and axes == tuple(range(expr.ndim)):
        return a  # identity permutation: skip entirely
    return new_collection(make_transpose(expr, axes))


def swapaxes(a, axis1, axis2):
    nd = a.ndim
    axis1 = validate_axis(axis1, nd)
    axis2 = validate_axis(axis2, nd)
    axes = list(range(nd))
    axes[axis1], axes[axis2] = axes[axis2], axes[axis1]
    return transpose(a, axes)


def moveaxis(a, source, destination):
    source = tuple(validate_axis(int(s), a.ndim) for s in np.atleast_1d(source))
    destination = tuple(validate_axis(int(d), a.ndim) for d in np.atleast_1d(destination))
    if len(source) != len(destination):
        raise ValueError("source and destination must have the same number of elements")
    order = [n for n in range(a.ndim) if n not in source]
    for dest, src in sorted(zip(destination, source)):
        order.insert(dest, src)
    return transpose(a, order)


def rollaxis(a, axis, start=0):
    axis = validate_axis(axis, a.ndim)
    if start < 0:
        start += a.ndim
    if not 0 <= start <= a.ndim:
        raise ValueError("start out of bounds")
    axes = list(range(a.ndim))
    axes.remove(axis)
    if axis < start:
        start -= 1
    axes.insert(start, axis)
    return transpose(a, axes)


# ---------------------------------------------------------------------------
# squeeze / expand_dims / broadcast_to
# ---------------------------------------------------------------------------


class Squeeze(ArrayExpr):
    takes_narrow = True

    _parameters = ("array", "axes")  # axes: tuple of dropped axes (all size 1)

    @functools.cached_property
    def chunks(self):
        return tuple(c for i, c in enumerate(self.array.chunks) if i not in self.axes)

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.chunks), dtype=self.array.dtype)

    def _simplify_down(self):
        if not self.axes:
            return self.array
        return None

    def _build(self, ctx):
        dense = ctx.build(self.array).dense()
        if _host.is_host_block(dense):
            return BlockView(self.chunks, dense=np.squeeze(dense, axis=self.axes))
        return BlockView(self.chunks, dense=torch.squeeze(dense, dim=self.axes))

    def _accept_rechunk(self, target_chunks):
        from dask_array_tpu_torch._rechunk import Rechunk

        it = iter(target_chunks)
        inner = tuple((1,) if ax in self.axes else tuple(next(it)) for ax in range(self.array.ndim))
        return Squeeze(Rechunk(self.array, inner), self.axes)

    def _accept_slice(self, index):
        if not is_basic_index(index):
            return None
        inner = []
        it = iter(index)
        for ax in range(self.array.ndim):
            if ax in self.axes:
                inner.append(slice(None))
            else:
                inner.append(next(it, slice(None)))
        sliced = Slice(self.array, tuple(inner))
        # integer indices drop non-squeezed axes; recompute squeeze axes
        kept = [ax for ax in range(self.array.ndim) if not (ax not in self.axes and isinstance(inner[ax], Integral))]
        new_axes = tuple(sorted(kept.index(ax) for ax in self.axes))
        return Squeeze(sliced, new_axes)


def squeeze(a, axis=None):
    from dask_array_tpu_torch._collection import Array, new_collection

    expr = a.expr if isinstance(a, Array) else a
    if axis is None:
        axes = tuple(i for i, s in enumerate(expr.shape) if s == 1)
    else:
        axes = validate_axis(axis if isinstance(axis, tuple) else (axis,), expr.ndim)
        for ax in axes:
            if expr.shape[ax] != 1:
                raise ValueError("cannot squeeze axis with size other than one")
    if not axes:
        return new_collection(expr)
    return new_collection(Squeeze(expr, tuple(sorted(axes))))


class ExpandDims(ArrayExpr):
    takes_narrow = True

    _parameters = ("array", "axes")  # axes: positions of the new size-1 dims in the OUTPUT

    @functools.cached_property
    def chunks(self):
        nd_out = self.array.ndim + len(self.axes)
        it = iter(self.array.chunks)
        return tuple((1,) if i in self.axes else next(it) for i in range(nd_out))

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * (self.array.ndim + len(self.axes)), dtype=self.array.dtype)

    def _simplify_down(self):
        # fold into a loader leaf: size-1 inserted axes keep the C-order
        # block numbering, so the same per-block args describe the higher
        # rank grid (stack() is expand_dims + concatenate: with this,
        # stack-of-from_delayed collapses to one FromMap)
        from dask_array_tpu_torch.io._from_map import FromMap, fm_pinned

        if type(self.array) is FromMap and not fm_pinned(self.array):
            fm = self.array
            return FromMap(fm.func, fm.args_per_block, self.chunks, fm.operand("_dtype"), fm.kwargs)
        return None

    def _build(self, ctx):
        dense = ctx.build(self.array).dense()
        if _host.is_host_block(dense):
            return BlockView(self.chunks, dense=np.expand_dims(dense, tuple(self.axes)))
        for ax in self.axes:  # ascending output positions
            dense = dense.unsqueeze(ax)
        return BlockView(self.chunks, dense=dense)

    def _accept_rechunk(self, target_chunks):
        """Push the rechunk past the size-1 new axes into the source."""
        from dask_array_tpu_torch._rechunk import Rechunk

        if any(tuple(target_chunks[ax]) != (1,) for ax in self.axes):
            return None
        inner = tuple(tuple(c) for ax, c in enumerate(target_chunks) if ax not in self.axes)
        if inner == self.array.chunks:
            return ExpandDims(self.array, self.axes)
        return ExpandDims(Rechunk(self.array, inner), self.axes)

    def _accept_slice(self, index):
        if not is_basic_index(index):
            return None
        inner = []
        new_axes = []
        out_kept = 0
        for out_ax, ind in enumerate(index):
            if out_ax in self.axes:
                # slicing a size-1 new axis: only slice(None)/slice(0,1)/0 make sense
                if isinstance(ind, Integral):
                    continue  # drops the new axis
                if ind not in (slice(None), slice(0, 1, 1)):
                    return None
                new_axes.append(out_kept)
                out_kept += 1
            else:
                inner.append(ind)
                if not isinstance(ind, Integral):
                    out_kept += 1
        sliced = Slice(self.array, tuple(inner))
        if not new_axes:
            return sliced
        return ExpandDims(sliced, tuple(new_axes))


def expand_dims(a, axis):
    from dask_array_tpu_torch._collection import Array, new_collection

    expr = a.expr if isinstance(a, Array) else a
    if isinstance(axis, Integral):
        axis = (axis,)
    out_ndim = expr.ndim + len(axis)
    axis = tuple(sorted(validate_axis(ax, out_ndim) for ax in axis))
    if len(set(axis)) != len(axis):
        raise ValueError("repeated axis")
    return new_collection(ExpandDims(expr, axis))


def _atleast(arys, lift):
    from dask_array_tpu_torch.ops._from_array import asarray

    out = [lift(asarray(a)) for a in arys]
    return out[0] if len(out) == 1 else tuple(out)


def atleast_1d(*arys):
    return _atleast(arys, lambda a: expand_dims(a, 0) if a.ndim == 0 else a)


def atleast_2d(*arys):
    def lift(a):
        while a.ndim < 2:
            a = expand_dims(a, 0)
        return a

    return _atleast(arys, lift)


def atleast_3d(*arys):
    new_axes = {0: (0, 1, 2), 1: (0, 2), 2: 2}
    return _atleast(arys, lambda a: expand_dims(a, new_axes[a.ndim]) if a.ndim in new_axes else a)


def _slice_len(ind: slice, dim: int) -> int:
    return len(range(*ind.indices(dim)))


class BroadcastTo(ArrayExpr):
    takes_narrow = True

    _parameters = ("array", "shape_", "chunks_")

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.chunks_), dtype=self.array.dtype)

    def _simplify_down(self):
        if self.shape_ == self.array.shape:
            return self.array
        if type(self.array) is BroadcastTo:
            return BroadcastTo(self.array.array, self.shape_, self.chunks_)
        return None

    def _accept_slice(self, index):
        """Slices on non-broadcast axes push to the source; broadcast and
        new axes keep theirs on the (shrunken) broadcast."""
        if not is_basic_index(index):
            return None
        ndim_new = len(self.shape_) - self.array.ndim
        inner = []
        outer = []
        out_shape = []
        pushed = False
        shrunk = False
        for ax, ind in enumerate(index):
            dim = self.shape_[ax]
            src_ax = ax - ndim_new
            is_bcast = src_ax < 0 or self.array.shape[src_ax] != dim
            if isinstance(ind, Integral):
                # rank change: keep the integer outside, shrink via slice
                ind = slice(int(ind), int(ind) + 1, 1)
                outer.append(0)
            else:
                outer.append(slice(None))
            norm = normalize_slice(ind, dim)
            n = _slice_len(norm, dim)
            out_shape.append(n)
            if is_bcast:
                # values along a broadcast dim are identical, so any slice
                # just shrinks the extent
                shrunk = shrunk or n != dim
                if src_ax >= 0:
                    inner.append(slice(None))
            else:
                pushed = pushed or norm != slice(None)
                inner.append(norm)
        if not pushed and not shrunk:
            return None
        src = Slice(self.array, tuple(inner)) if any(i != slice(None) for i in inner) else self.array
        new_chunks = tuple(
            src.chunks[ax - ndim_new]
            if ax - ndim_new >= 0 and self.array.shape[ax - ndim_new] == self.shape_[ax]
            else (out_shape[ax],)
            for ax in range(len(out_shape))
        )
        out = BroadcastTo(src, tuple(out_shape), new_chunks)
        if any(isinstance(o, Integral) for o in outer):
            return Slice(out, tuple(outer))
        return out

    def _build(self, ctx):
        dense = ctx.build(self.array).dense()
        if _host.is_host_block(dense):
            return BlockView(self.chunks_, dense=np.broadcast_to(dense, self.shape_))
        return BlockView(self.chunks_, dense=dense.expand(self.shape_))


def broadcast_to(x, shape, chunks=None, meta=None):
    from dask_array_tpu_torch._chunks import normalize_chunks
    from dask_array_tpu_torch._collection import new_collection
    from dask_array_tpu_torch.ops._from_array import asarray

    expr = asarray(x).expr
    shape = tuple(int(s) for s in (shape if not isinstance(shape, Integral) else (shape,)))
    ndim_new = len(shape) - expr.ndim
    if ndim_new < 0 or any(new != old and old != 1 for new, old in zip(shape[ndim_new:], expr.shape)):
        raise ValueError(f"cannot broadcast shape {expr.shape} to shape {shape}")
    if chunks is None:
        out_chunks = tuple((s,) for s in shape[:ndim_new]) + tuple(
            old_c if old == new else (new,)
            for old_c, old, new in zip(expr.chunks, expr.shape, shape[ndim_new:])
        )
    else:
        out_chunks = normalize_chunks(chunks, shape, dtype=expr.dtype)
        for old_c, old_s, new_c in zip(expr.chunks, expr.shape, out_chunks[ndim_new:]):
            if old_s != 1 and tuple(old_c) != tuple(new_c):
                raise ValueError("cannot rechunk broadcast dimensions in broadcast_to")
    if shape == expr.shape and out_chunks == expr.chunks:
        return new_collection(expr)
    return new_collection(BroadcastTo(expr, shape, out_chunks))


# ---------------------------------------------------------------------------
# flips / roll
# ---------------------------------------------------------------------------


def flip(m, axis=None):
    if axis is None:
        axes = tuple(range(m.ndim))
    else:
        axes = validate_axis(axis if isinstance(axis, (tuple, list)) else (axis,), m.ndim)
    index = tuple(slice(None, None, -1) if i in axes else slice(None) for i in range(m.ndim))
    return m[index]


def flipud(m):
    if m.ndim < 1:
        raise ValueError("Input must be >= 1-d.")
    return m[::-1]


def fliplr(m):
    if m.ndim < 2:
        raise ValueError("Input must be >= 2-d.")
    return m[:, ::-1]


def rot90(m, k=1, axes=(0, 1)):
    axes = tuple(axes)
    if len(axes) != 2:
        raise ValueError("len(axes) must be 2.")
    ax0, ax1 = validate_axis(axes[0], m.ndim), validate_axis(axes[1], m.ndim)
    if ax0 == ax1:
        raise ValueError("Axes must be different.")
    k %= 4
    if k == 0:
        return m[tuple(slice(None) for _ in range(m.ndim))]
    if k == 2:
        return flip(flip(m, ax0), ax1)
    axes_list = list(range(m.ndim))
    axes_list[ax0], axes_list[ax1] = axes_list[ax1], axes_list[ax0]
    if k == 1:
        return transpose(flip(m, ax1), axes_list)
    return flip(transpose(m, axes_list), ax1)


def roll(array, shift, axis=None):
    result = array
    if axis is None:
        result = result.reshape(-1) if result.ndim != 1 else result
        shift_list = (shift,) if not isinstance(shift, (tuple, list)) else tuple(shift)
        if len(shift_list) != 1:
            raise TypeError("Must specify axis if providing more than one shift")
        res = _roll_one(result, shift_list[0], 0)
        return res.reshape(array.shape) if array.ndim != 1 else res
    shifts = (shift,) if isinstance(shift, Integral) else tuple(shift)
    axes = (axis,) if isinstance(axis, Integral) else tuple(axis)
    if len(shifts) != len(axes):
        raise ValueError("Must have the same number of shifts as axes.")
    for s, ax in zip(shifts, axes):
        result = _roll_one(result, s, validate_axis(ax, result.ndim))
    return result


def _roll_one(x, shift, axis):
    from dask_array_tpu_torch.ops.stacking import concatenate

    n = x.shape[axis]
    if n == 0:
        return x
    shift = int(shift) % n
    if shift == 0:
        return x[tuple(slice(None) for _ in range(x.ndim))]
    sl_a = tuple(slice(-shift, None) if i == axis else slice(None) for i in range(x.ndim))
    sl_b = tuple(slice(None, -shift) if i == axis else slice(None) for i in range(x.ndim))
    return concatenate([x[sl_a], x[sl_b]], axis=axis)
