"""Fancy indexing: integer-array take, boolean masks, vindex.

Port of ``dask_array_tpu/ops/_fancy_indexing.py``.  An integer-array take
is one ``index_select`` of the dense tensor; its numpy indices are checked
on the host when the expression is built (numpy's ``IndexError``), wrapped
to non-negative, and reach the device as an int64 leaf, once per
``compute()``.  A lazy (device) index is checked with one min/max reduction
and one host sync before any gather: on CUDA an out-of-range gather is a
device-side assert that leaves the process's CUDA context unusable, so no
bad index may reach one.

A boolean mask has a data-dependent result size: ``BooleanIndex`` gives one
block of unknown (nan) size per input block (the grid ``compute_chunk_sizes``
recovers), at one host sync per block.  ``SYNCS`` counts the host syncs of
these data-dependent paths (masks, ``nonzero``, lazy-index checks).
"""

from __future__ import annotations

import functools
from numbers import Integral

import numpy as np
import torch

from dask_array_tpu_torch import _host
from dask_array_tpu_torch._chunks import computable, moved, validate_axis
from dask_array_tpu_torch._executor import BlockView, iter_block_indices
from dask_array_tpu_torch._expr import ArrayExpr
from dask_array_tpu_torch._slicing import Slice, _is_nan, is_basic_index

# host syncs of the data-dependent paths (read and reset by callers)
SYNCS = 0

# one shared nan: chunk tuples of unknown sizes built from it compare equal
NAN = float("nan")


def count_sync(n=1):
    global SYNCS
    SYNCS += n


def checked_indices(idx: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """A device index tensor as int64, bounds-checked with one min/max
    reduction and one host sync (numpy's ``IndexError``), negatives wrapped."""
    idx = computable(idx).to(torch.int64)
    if idx.numel():
        lo, hi = torch.stack(torch.aminmax(idx)).tolist()
        count_sync()
        if lo < -dim or hi >= dim:
            bad = lo if lo < -dim else hi
            raise IndexError(f"index {bad} is out of bounds for axis {axis} with size {dim}")
    return torch.where(idx < 0, idx + dim, idx)


class Take(ArrayExpr):
    """Integer-array indexing along one axis (one ``index_select``)."""

    takes_narrow = True

    _parameters = ("array", "indices", "axis", "out_chunks_axis")

    @functools.cached_property
    def chunks(self):
        chunks = list(self.array.chunks)
        chunks[self.axis] = self.out_chunks_axis
        return tuple(chunks)

    def transfer_bytes(self):
        nb = self.array.nbytes
        if isinstance(nb, float) and nb != nb:
            return (0, 0)
        return (0, int(nb * len(self.indices) / max(1, self.array.shape[self.axis])))

    @property
    def _meta(self):
        return self.array._meta

    def _simplify_down(self):
        n = self.array.shape[self.axis]
        idx = np.asarray(self.indices)
        # an identity take disappears (a relayout if only the grid differs)
        if isinstance(n, (int, np.integer)) and len(idx) == n and np.array_equal(idx, np.arange(n)):
            if self.chunks == self.array.chunks:
                return self.array
            from dask_array_tpu_torch._rechunk import Rechunk

            return Rechunk(self.array, self.chunks)
        # take-of-take on one axis composes: x[i1][i2] == x[i1[i2]]
        if type(self.array) is Take and self.array.axis == self.axis:
            inner = self.array
            composed = np.ascontiguousarray(np.asarray(inner.indices)[idx])
            return Take(inner.array, composed, self.axis, self.out_chunks_axis)
        # span culling: indices touching a sub-range of blocks slice the
        # source to that block-aligned window first (slice pushdown culls)
        src_axis_chunks = self.array.chunks[self.axis]
        if (
            isinstance(n, (int, np.integer))
            and idx.size
            and len(src_axis_chunks) > 1
            and not any(_is_nan(c) for c in src_axis_chunks)
        ):
            bounds = np.cumsum((0,) + tuple(src_axis_chunks))
            lo_b = int(np.searchsorted(bounds, idx.min(), side="right") - 1)
            hi_b = int(np.searchsorted(bounds, idx.max(), side="right"))
            if hi_b - lo_b < len(src_axis_chunks):
                lo, hi = int(bounds[lo_b]), int(bounds[hi_b])
                index = tuple(slice(lo, hi) if ax == self.axis else slice(None) for ax in range(self.array.ndim))
                return Take(Slice(self.array, index), np.ascontiguousarray(idx - lo), self.axis,
                            self.out_chunks_axis)
        return None

    def _accept_slice(self, index):
        """Slices on the axes not taken commute below the take."""
        if not is_basic_index(index) or any(isinstance(i, Integral) for i in index):
            return None
        if index[self.axis] != slice(None) or all(i == slice(None) for i in index):
            return None
        return Take(Slice(self.array, tuple(index)), self.indices, self.axis, self.out_chunks_axis)

    @functools.cached_property
    def _index_key(self):
        return f"take-{self._name}"

    def _leaf_buffers(self):
        yield (self._index_key, self.indices)

    def _build(self, ctx):
        dense = ctx.build(self.array).dense()
        if _host.is_host_block(dense):
            # numpy's take: a masked block keeps its mask, a duck block
            # dispatches through its type
            idx = np.asarray(_host.host_array(ctx.leaf(self._index_key)), dtype=np.int64)
            return BlockView(self.chunks, dense=np.take(dense, idx, axis=self.axis))
        out = moved(torch.index_select, dense, self.axis, ctx.leaf(self._index_key))
        return BlockView(self.chunks, dense=out)


def take(a, indices, axis=0):
    from dask_array_tpu_torch._collection import Array, new_collection
    from dask_array_tpu_torch.ops._from_array import asarray

    a = asarray(a)
    axis = validate_axis(axis, a.ndim)
    if isinstance(indices, Array):
        return _take_lazy(a, indices, axis)
    indices = np.asarray(indices)
    if indices.dtype == bool:
        return fancy_getitem(a, tuple(indices if ax == axis else slice(None) for ax in range(a.ndim)))
    if indices.ndim != 1:
        from dask_array_tpu_torch.ops._reshape import reshape

        flat = take(a, indices.ravel(), axis=axis)
        return reshape(flat, a.shape[:axis] + indices.shape + a.shape[axis + 1:])
    if indices.size == 0:
        indices = indices.astype(np.int64)  # numpy takes [] as an empty integer index
    if indices.dtype.kind not in "iu":
        raise IndexError(
            "only integers, slices, ellipsis, newaxis and integer or boolean arrays are valid "
            f"indices (got dtype {indices.dtype})"
        )
    n = a.shape[axis]
    idx = indices.astype(np.int64)
    if _is_nan(n):
        raise ValueError("Cannot take along an axis with unknown chunk sizes; call compute_chunk_sizes() first")
    neg = idx < 0
    if neg.any():
        idx = np.where(neg, idx + n, idx)
    if ((idx < 0) | (idx >= n)).any():
        bad = indices[(idx < 0) | (idx >= n)][0]
        raise IndexError(f"index {bad} is out of bounds for axis {axis} with size {n}")
    # chunk the output axis like the input's typical chunk
    mean = max(1, int(np.mean(a.chunks[axis]))) if len(a.chunks[axis]) else 1
    ngroups = max(1, -(-len(idx) // mean))
    out_axis = tuple(len(g) for g in np.array_split(idx, ngroups) if len(g)) or (0,)
    return new_collection(Take(a.expr, np.ascontiguousarray(idx), axis, out_axis))


def _take_lazy(a, indices, axis):
    """Take with a lazy integer Array of indices (any ndim, known chunks)."""
    from dask_array_tpu_torch._chunks import has_unknown_chunks
    from dask_array_tpu_torch._collection import new_collection

    if np.dtype(indices.dtype).kind not in "iu":
        raise IndexError(f"arrays used as indices must be of integer (or boolean) type, not {indices.dtype}")
    if indices.ndim != 1:
        from dask_array_tpu_torch.ops._reshape import reshape

        if has_unknown_chunks(indices.chunks):
            raise ValueError(
                "Slicing with a >1-D lazy index array of unknown chunks is not supported; call "
                "compute_chunk_sizes() on the index first"
            )
        flat = _take_lazy(a, indices.ravel(), axis)
        return reshape(flat, a.shape[:axis] + indices.shape + a.shape[axis + 1:])
    return new_collection(TakeLazy(a.expr, indices.expr, axis))


class TakeLazy(ArrayExpr):
    """Take with device indices: bounds-checked by ``checked_indices``."""

    takes_narrow = True

    _parameters = ("array", "indices", "axis")

    @functools.cached_property
    def chunks(self):
        chunks = list(self.array.chunks)
        chunks[self.axis] = self.indices.chunks[0]
        return tuple(chunks)

    @property
    def _meta(self):
        return self.array._meta

    def _build(self, ctx):
        dense = ctx.build(self.array).dense()
        idx = checked_indices(ctx.build(self.indices).dense(), dense.shape[self.axis], self.axis)
        return BlockView(self.chunks, dense=moved(torch.index_select, dense, self.axis, idx))


class BooleanIndex(ArrayExpr):
    """x[mask]: one block of unknown (nan) size per input block.

    ``axis`` None: array and mask are 1-D (raveled in C order at
    construction), each block one ``masked_select``.  Otherwise a 1-D mask
    along ``axis``: its positions are found once per block along that axis
    (one sync each) and every block takes them with ``index_select``.  A
    numpy mask is a leaf on the device, a lazy one is rechunked to the
    array's blocks.
    """

    takes_narrow = True

    _parameters = ("array", "mask", "axis")

    @functools.cached_property
    def chunks(self):
        if self.axis is None:
            return ((NAN,) * int(np.prod([len(c) for c in self.array.chunks])),)
        chunks = list(self.array.chunks)
        chunks[self.axis] = (NAN,) * len(chunks[self.axis])
        return tuple(chunks)

    @property
    def _meta(self):
        nd = 1 if self.axis is None else self.array.ndim
        return np.empty((0,) * nd, dtype=self.array.dtype)

    @functools.cached_property
    def _mask_key(self):
        return f"mask-{self._name}"

    def _leaf_buffers(self):
        if isinstance(self.mask, np.ndarray):
            yield (self._mask_key, self.mask)

    def _mask_blocks(self, ctx, chunks):
        if isinstance(self.mask, ArrayExpr):
            return ctx.build(self.mask)
        return BlockView(chunks, dense=ctx.leaf(self._mask_key))

    def _build(self, ctx):
        view = ctx.build(self.array)
        blocks = {}
        if self.axis is None:
            mview = self._mask_blocks(ctx, self.array.chunks)
            for j, idx in enumerate(iter_block_indices(view.numblocks)):
                blocks[(j,)] = moved(torch.masked_select, view.block(idx), mview.block(idx))
                count_sync()
            return BlockView(self.chunks, blocks=blocks)
        mview = self._mask_blocks(ctx, (self.array.chunks[self.axis],))
        positions = {}
        for idx in iter_block_indices(view.numblocks):
            k = idx[self.axis]
            if k not in positions:
                positions[k] = torch.nonzero(mview.block((k,))).reshape(-1)
                count_sync()
            blocks[tuple(idx)] = moved(torch.index_select, view.block(idx), self.axis, positions[k])
        return BlockView(self.chunks, blocks=blocks)


class VIndex(ArrayExpr):
    """Pointwise (coordinate) indexing: one gather.

    ``pattern`` marks, per input axis, a slice or the slot of an index
    operand (``operands[4 + slot]``); ``lazy`` flags the slots whose values
    were not checked on the host.  The broadcast index dims lead the output
    (the vindex contract).
    """

    takes_narrow = True

    _parameters = ("array", "pattern", "bshape", "lazy")

    def _name_prefix(self):
        return "vindex"

    @property
    def _index_exprs(self):
        return self.operands[4:]

    def transfer_bytes(self):
        nb = self.array.nbytes
        if isinstance(nb, float) and nb != nb:
            return (0, 0)
        return (0, int(nb))

    @functools.cached_property
    def chunks(self):
        lead = tuple((s,) for s in self.bshape)
        rest = tuple(self.array.chunks[ax] for ax, p in enumerate(self.pattern) if isinstance(p, slice))
        return lead + rest

    @property
    def _meta(self):
        return np.empty((0,) * len(self.chunks), dtype=self.array.dtype)

    def _build(self, ctx):
        dense = ctx.build(self.array).dense()
        arr_axes = [ax for ax, p in enumerate(self.pattern) if not isinstance(p, slice)]
        slice_axes = [ax for ax, p in enumerate(self.pattern) if isinstance(p, slice)]
        idxs = [computable(ctx.build(self._index_exprs[self.pattern[ax]]).dense()).to(torch.int64)
                for ax in arr_axes]
        lazy = [i for i, ax in enumerate(arr_axes) if self.lazy[self.pattern[ax]] and idxs[i].numel()]
        if lazy:
            # every lazy index checked with one sync
            ranges = torch.stack([torch.stack(torch.aminmax(idxs[i])) for i in lazy]).tolist()
            count_sync()
            for i, (lo, hi) in zip(lazy, ranges):
                dim = dense.shape[arr_axes[i]]
                if lo < -dim or hi >= dim:
                    raise IndexError(f"vindex index {lo if lo < -dim else hi} is out of bounds for axis "
                                     f"{arr_axes[i]} with size {dim}")
                idxs[i] = torch.where(idxs[i] < 0, idxs[i] + dim, idxs[i])
        out = moved(_gather, dense.permute(arr_axes + slice_axes), tuple(idxs))
        return BlockView(self.chunks, dense=out)


def _gather(t, idxs):
    return t[idxs]


class VIndexAccessor:
    def __init__(self, array):
        self._array = array

    def __getitem__(self, index):
        from dask_array_tpu_torch._collection import Array, new_collection
        from dask_array_tpu_torch.ops._from_array import from_array

        if not isinstance(index, tuple):
            index = (index,)
        x = self._array
        if len(index) > x.ndim:
            raise IndexError(
                f"too many indices for vindex: array is {x.ndim}-dimensional, but {len(index)} were indexed"
            )
        index = index + (slice(None),) * (x.ndim - len(index))
        pattern, index_exprs, shapes, lazy = [], [], [], []
        for ax, (i, dim) in enumerate(zip(index, x.shape)):
            if isinstance(i, slice):
                if i != slice(None):
                    raise NotImplementedError("vindex only supports full slices alongside index arrays")
                pattern.append(i)
                continue
            if isinstance(i, Array):
                if np.dtype(i.dtype) == bool:
                    raise NotImplementedError(
                        "vindex with lazy boolean arrays is not supported; use x[mask]"
                    )
                expr = i.expr
                lazy.append(True)
            else:
                arr = np.asarray(i)
                if arr.dtype == bool:
                    arr = np.nonzero(arr)[0]
                arr = arr.astype(np.int64)
                arr = np.where(arr < 0, arr + dim, arr)
                if ((arr < 0) | (arr >= dim)).any():
                    bad = int(arr[(arr < 0) | (arr >= dim)][0])
                    raise IndexError(f"vindex index {bad} is out of bounds for axis {ax} with size {dim}")
                expr = from_array(arr, chunks=arr.shape or ()).expr
                lazy.append(False)
            pattern.append(len(index_exprs))
            index_exprs.append(expr)
            shapes.append(expr.shape)
        if not index_exprs:
            return new_collection(x.expr)
        bshape = tuple(int(s) for s in np.broadcast_shapes(*shapes))
        return new_collection(VIndex(x.expr, tuple(pattern), bshape, tuple(lazy), *index_exprs))


def _multi_fancy(x, index):
    """``x[idx...]`` with several advanced indices, numpy semantics: every
    non-slice entry (arrays and integers) broadcasts together; the
    broadcast dims land in place when the advanced entries are consecutive,
    else first.  Basic pre-slicing, one ``vindex`` gather, a moveaxis."""
    from dask_array_tpu_torch._collection import Array

    adv_pos = [k for k, j in enumerate(index) if not isinstance(j, slice)]
    basic = tuple(j if isinstance(j, slice) else slice(None) for j in index)
    y = x if all(j == slice(None) for j in basic) else x[basic]
    vargs = []
    for k, j in enumerate(index):
        if isinstance(j, slice):
            vargs.append(slice(None))
        elif isinstance(j, Integral):
            vargs.append(np.asarray(j))
        elif isinstance(j, Array):
            if np.dtype(j.dtype) == bool:
                raise NotImplementedError(
                    "lazy boolean arrays among several advanced indices are not supported"
                )
            vargs.append(j)
        else:
            arr = np.asarray(j)
            if arr.dtype == bool:
                if arr.ndim != 1:
                    raise IndexError("multi-dimensional boolean index among several advanced indices")
                if arr.shape[0] != x.shape[k]:
                    raise IndexError(
                        f"boolean index length {arr.shape[0]} does not match axis {k} size {x.shape[k]}"
                    )
                arr = np.nonzero(arr)[0]
            vargs.append(arr)
    v = y.vindex[tuple(vargs)]
    n_slices = sum(1 for j in index if isinstance(j, slice))
    n_b = v.ndim - n_slices
    consecutive = adv_pos == list(range(adv_pos[0], adv_pos[-1] + 1))
    if consecutive and n_b:
        lead_slices = sum(1 for j in index[: adv_pos[0]] if isinstance(j, slice))
        if lead_slices:
            from dask_array_tpu_torch.ops.manipulation import moveaxis

            v = moveaxis(v, tuple(range(n_b)), tuple(range(lead_slices, lead_slices + n_b)))
    return v


def _known_mismatch(a, b):
    return not _is_nan(a) and not _is_nan(b) and a != b


def fancy_getitem(x, index):
    """Route a normalized index holding arrays or lists to its expression."""
    from dask_array_tpu_torch._collection import Array, new_collection

    index = tuple(np.asarray(i) if isinstance(i, list) else i for i in index)

    # a boolean mask of the array's whole shape
    for pos, i in enumerate(index):
        is_mask = isinstance(i, (np.ndarray, Array)) and np.dtype(i.dtype) == bool
        if is_mask and i.ndim == x.ndim and x.ndim > 1 and all(
            j == slice(None) for k, j in enumerate(index) if k != pos
        ):
            if any(_known_mismatch(a, b) for a, b in zip(i.shape, x.shape)):
                raise IndexError(
                    f"boolean index shape {tuple(i.shape)} did not match indexed array shape {tuple(x.shape)}"
                )
            # both raveled first (global C order), so the per-block
            # selections concatenate in numpy's order
            from dask_array_tpu_torch.ops._reshape import ravel

            xr = ravel(x)
            if isinstance(i, Array):
                m = ravel(i).rechunk(xr.chunks).expr
            else:
                m = np.ascontiguousarray(i).ravel()
            return new_collection(BooleanIndex(xr.expr, m, None))

    fancy_pos = [pos for pos, i in enumerate(index) if not isinstance(i, (slice, Integral))]
    if len(fancy_pos) > 1:
        return _multi_fancy(x, index)
    (pos,) = fancy_pos
    i = index[pos]

    if isinstance(i, Array):
        if np.dtype(i.dtype) == bool:
            if i.ndim != 1 or _known_mismatch(i.shape[0], x.shape[pos]):
                raise IndexError(f"boolean index of shape {i.shape} does not match axis {pos} of {x.shape}")
            out = new_collection(BooleanIndex(x.expr, i.rechunk((x.chunks[pos],)).expr, pos))
        else:
            out = _take_lazy(x, i, pos)
    else:
        arr = np.asarray(i)
        if arr.dtype == bool:
            if arr.ndim != 1:
                raise IndexError("boolean index did not match indexed array")
            if arr.shape[0] != x.shape[pos]:
                raise IndexError(
                    f"boolean index did not match indexed array along axis {pos}; size of axis is "
                    f"{x.shape[pos]} but size of corresponding boolean axis is {arr.shape[0]}"
                )
            out = take(x, np.nonzero(arr)[0], axis=pos)
        else:
            out = take(x, arr, axis=pos)

    # the remaining basic index around the fancy axis
    rest = [j for k, j in enumerate(index) if k != pos]
    if all(isinstance(j, slice) and j == slice(None) for j in rest):
        return out
    full = list(index)
    full[pos] = slice(None)
    return new_collection(Slice(out.expr, tuple(full)))


def leading_mask_getitem(x, index):
    """``x[mask, ...]`` with a k-d boolean mask over the first k axes
    (k < x.ndim): the masked axes merge into one, which the raveled mask
    selects."""
    from dask_array_tpu_torch._collection import Array

    mask, rest = index[0], index[1:]
    mask = mask if isinstance(mask, Array) else np.asarray(mask)
    if mask.ndim == x.ndim and all(j is Ellipsis or j == slice(None) for j in rest):
        return fancy_getitem(x, (mask,) + (slice(None),) * (x.ndim - 1))
    if not all(j is Ellipsis or (isinstance(j, slice) and j == slice(None)) for j in rest):
        raise NotImplementedError("a multi-dimensional boolean index is supported only alone, over leading axes")
    k = mask.ndim
    if k > x.ndim or any(_known_mismatch(a, b) for a, b in zip(mask.shape, x.shape[:k])):
        raise IndexError(f"boolean index shape {tuple(mask.shape)} did not match indexed array shape {x.shape}")
    return x.reshape((-1,) + tuple(x.shape[k:]))[mask.ravel()]
