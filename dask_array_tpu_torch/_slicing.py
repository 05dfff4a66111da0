"""Basic slicing: the ``Slice`` expression, index normalization, slice fusion.

Port of ``dask_array_tpu/_slicing.py``.  Execution is dense: the tensor is
sliced directly (a view); the per-axis chunk bookkeeping keeps the block
metadata equal to dask.array's.  torch slices take no negative step, so
``getitem_tensor`` turns a descending slice into an ascending one plus a
flip.  Fancy indexing waits for a later slice of the port.
"""

from __future__ import annotations

import functools
import math
from numbers import Integral

import numpy as np
import torch

from dask_array_tpu_torch._chunks import cached_cumsum, moved
from dask_array_tpu_torch._executor import BlockView
from dask_array_tpu_torch._expr import ArrayExpr


def _is_nan(x):
    return isinstance(x, float) and math.isnan(x)


def normalize_slice(sl: slice, dim) -> slice:
    """Canonicalize a slice against a dimension (stable tokens).

    Full-coverage slices become ``slice(None)``; bounded positive-step
    slices get concrete non-negative start/stop.
    """
    if _is_nan(dim):
        return sl
    start, stop, step = sl.indices(int(dim))
    if step == 1:
        if start == 0 and stop == dim:
            return slice(None)
        if start >= stop:
            return slice(0, 0, 1)
        return slice(start, stop, 1)
    if step > 0:
        if start >= stop:
            return slice(0, 0, 1)
        n = (stop - start - 1) // step
        return slice(start, start + n * step + 1, step)
    count = max(0, (stop - start + 1) // step + 1) if start > stop else 0
    if count == 0:
        return slice(0, 0, 1)
    return slice(start, None if stop < 0 else stop, step)


def normalize_index(index, shape):
    """Normalize a user __getitem__ index to a full-length tuple.

    Handles Ellipsis expansion, negative ints, bounds checks, and per-axis
    slice canonicalization.  Anything else (None, arrays, lists) passes
    through for the router to accept or refuse.
    """
    if not isinstance(index, tuple):
        index = (index,)
    n_ell = sum(1 for i in index if i is Ellipsis)
    if n_ell > 1:
        raise IndexError("an index can only have a single ellipsis ('...')")
    n_consumed = sum(1 for i in index if i is not None and i is not Ellipsis)
    if n_ell:
        fill = (slice(None),) * (len(shape) - n_consumed)
        pos = index.index(Ellipsis)
        index = index[:pos] + fill + index[pos + 1:]
    elif n_consumed < len(shape):
        index = index + (slice(None),) * (len(shape) - n_consumed)
    n_used = sum(1 for i in index if i is not None)
    if n_used > len(shape):
        raise IndexError(
            f"too many indices for array: array is {len(shape)}-dimensional, "
            f"but {n_used} were indexed"
        )

    out = []
    axis = 0
    for ind in index:
        if ind is None:
            out.append(None)
            continue
        dim = shape[axis]
        if isinstance(ind, Integral) and not isinstance(ind, bool):
            i = int(ind)
            if not _is_nan(dim):
                if i < -dim or i >= dim:
                    raise IndexError(f"index {i} is out of bounds for axis {axis} with size {dim}")
                if i < 0:
                    i += dim
            out.append(i)
        elif isinstance(ind, slice):
            out.append(normalize_slice(ind, dim))
        else:
            out.append(ind)
        axis += 1
    return tuple(out)


def is_basic_index(index) -> bool:
    return all(isinstance(i, (slice, Integral)) and not isinstance(i, bool) for i in index)


def getitem_tensor(t: torch.Tensor, index) -> torch.Tensor:
    """``t[index]`` for a normalized basic index, numpy semantics.

    Descending slices select the same elements ascending, then flip."""
    index = tuple(index)
    if not isinstance(t, torch.Tensor) or all(not isinstance(i, slice) or (i.step or 1) > 0 for i in index):
        return t[index]  # (a host block takes numpy's index as it is)
    asc = []
    flip_dims = []
    out_dim = 0
    for ax, ind in enumerate(index):
        if isinstance(ind, Integral):
            asc.append(ind)
            continue
        start, stop, step = ind.indices(t.shape[ax])
        if step < 0:
            n = len(range(start, stop, step))
            if n:
                last = start + (n - 1) * step
                asc.append(slice(last, start + 1, -step))
                flip_dims.append(out_dim)
            else:
                asc.append(slice(0, 0, 1))
        else:
            asc.append(ind)
        out_dim += 1
    out = t[tuple(asc)]
    return moved(torch.flip, out, flip_dims) if flip_dims else out


def sliced_blockdim(dim_chunks, sl: slice):
    """New per-block counts for one axis under a basic slice.

    Returns (new_chunks, kept) where kept is the list of (block, inner_slice)
    in output order; empty contributions are dropped (dask semantics).
    Long positive-step axes take the native plankit kernel, which leaves
    ``kept`` None (every caller reads only the new chunks).
    """
    total = sum(dim_chunks)
    start, stop, step = sl.indices(int(total))
    if step > 0 and len(dim_chunks) > 256:
        from dask_array_tpu_torch import native

        counts = native.sliced_blockdim_counts(dim_chunks, start, stop, step)
        if counts is not None:
            nc = tuple(int(c) for c in counts if c)
            return (nc or (0,)), None
    bounds = cached_cumsum(dim_chunks, initial_zero=True)
    new_chunks = []
    kept = []
    if step > 0:
        for b in range(len(dim_chunks)):
            lo, hi = bounds[b], bounds[b + 1]
            lo_eff = max(lo, start)
            hi_eff = min(hi, stop)
            if hi_eff <= lo_eff:
                continue
            # first selected index >= lo_eff on the progression start + k*step
            k0 = -(-(lo_eff - start) // step)
            first = start + k0 * step
            if first >= hi_eff:
                continue
            count = (hi_eff - first - 1) // step + 1
            new_chunks.append(count)
            kept.append((b, slice(first - lo, first - lo + (count - 1) * step + 1, step)))
    else:
        for b in reversed(range(len(dim_chunks))):
            lo, hi = bounds[b], bounds[b + 1]
            hi_eff = min(hi - 1, start)
            lo_eff = max(lo, stop + 1)
            if hi_eff < lo_eff:
                continue
            k0 = -(-(start - hi_eff) // (-step))
            first = start + k0 * step  # largest selected index <= hi_eff
            if first < lo_eff:
                continue
            count = (first - lo_eff) // (-step) + 1
            last = first + (count - 1) * step
            new_chunks.append(count)
            stop_inner = last - lo + step
            kept.append((b, slice(first - lo, stop_inner if stop_inner >= 0 else None, step)))
    if not new_chunks:
        return (0,), []
    return tuple(new_chunks), kept


class Slice(ArrayExpr):
    """Basic slicing (slices + integers) of an array expression.

    operands: [array, index] with index a normalized full-length tuple.
    """

    takes_narrow = True

    _parameters = ("array", "index")
    _pushdown_gate = "_slice_pushdown"

    @functools.cached_property
    def chunks(self):
        chunks = []
        for ax, ind in enumerate(self.index):
            dim_chunks = self.array.chunks[ax]
            if isinstance(ind, Integral):
                continue
            if ind == slice(None):
                chunks.append(tuple(dim_chunks))
                continue
            if any(_is_nan(c) for c in dim_chunks):
                raise ValueError(
                    "Cannot slice an axis with unknown chunk sizes; call "
                    "compute_chunk_sizes() first"
                )
            new, _ = sliced_blockdim(dim_chunks, ind)
            chunks.append(tuple(new))
        return tuple(chunks)

    @functools.cached_property
    def _meta(self):
        nd = sum(1 for i in self.index if not isinstance(i, Integral))
        return np.empty((0,) * nd, dtype=self.array.dtype)

    def _simplify_down(self):
        if all(i == slice(None) for i in self.index):
            return self.array
        # slice-of-slice fusion
        if type(self.array) is Slice:
            inner = self.array
            fused = fuse_slice(inner.index, self.index, inner.array.shape)
            if fused is not None:
                return Slice(inner.array, fused)
        return None

    def _build(self, ctx):
        dense = ctx.build(self.array).dense()
        return BlockView(self.chunks, dense=getitem_tensor(dense, self.index))


def slice_for_ndim(index, out_ndim, arg_ndim, arg_shape, out_shape=None):
    """Map an out-index onto a broadcast-aligned elemwise argument.

    Returns the sub-index for the argument, () if it would be a no-op, or
    None to decline.  Broadcast dims (arg size 1) map ints to 0 and slices
    to slice(None) — emptiness of a slice on a broadcast dim is judged
    against the OUTPUT axis length.
    """
    if arg_ndim == 0:
        return ()
    idx = list(index)
    if len(idx) != out_ndim or not is_basic_index(idx):
        return None
    sub = idx[out_ndim - arg_ndim:]
    out_sub = list(out_shape)[out_ndim - arg_ndim:] if out_shape is not None else None
    out = []
    trivial = True
    for pos, ind in enumerate(sub):
        dim = arg_shape[pos]
        if not _is_nan(dim) and dim == 1:
            if isinstance(ind, Integral):
                out.append(0)
                trivial = False
            else:
                out_dim = out_sub[pos] if out_sub is not None else None
                if out_dim is None or _is_nan(out_dim):
                    out_dim = 1
                start, stop, step = ind.indices(int(out_dim))
                if len(range(start, stop, step)) == 0:
                    out.append(slice(0, 0, 1))
                    trivial = False
                else:
                    out.append(slice(None))
        else:
            out.append(ind)
            if ind != slice(None):
                trivial = False
    if trivial:
        return ()
    return tuple(out)


def _compose_slice_slice(inner: slice, outer: slice, dim):
    """index by inner then by outer == index by returned slice (known dim)."""
    if _is_nan(dim):
        return None
    i_start, i_stop, i_step = inner.indices(int(dim))
    n_inner = len(range(i_start, i_stop, i_step))
    o_start, o_stop, o_step = outer.indices(n_inner)
    new_step = i_step * o_step
    new_start = i_start + o_start * i_step
    count = len(range(o_start, o_stop, o_step))
    if count == 0:
        return slice(0, 0, 1)
    last = new_start + (count - 1) * new_step
    if new_step > 0:
        return slice(new_start, last + 1, new_step)
    stop = last - 1
    return slice(new_start, stop if stop >= 0 else None, new_step)


def fuse_slice(inner, outer, inner_base_shape):
    """Compose two normalized basic-index tuples: x[inner][outer] == x[fused].

    Returns None to decline (unknown dims, unsupported combos).
    """
    if not (is_basic_index(inner) and is_basic_index(outer)):
        return None
    fused = []
    outer_iter = iter(outer)
    for ax, ind in enumerate(inner):
        dim = inner_base_shape[ax] if ax < len(inner_base_shape) else None
        if isinstance(ind, Integral):
            fused.append(ind)
            continue
        o = next(outer_iter, slice(None))
        if isinstance(o, Integral):
            if _is_nan(dim):
                return None
            start, stop, step = ind.indices(int(dim))
            n = len(range(start, stop, step))
            oi = int(o)
            if oi < 0:
                oi += n
            fused.append(start + oi * step)
        else:
            comp = _compose_slice_slice(ind, o, dim)
            if comp is None:
                return None
            fused.append(normalize_slice(comp, dim))
    for o in outer_iter:
        if o != slice(None):
            return None
    return tuple(fused)
