"""from_map / from_delayed / from_blocks: arrays from block-making host
functions.

Port of ``dask_array_tpu/io/_from_map.py``.  The block-making functions
(file readers, loaders) are host code: each runs once per block per walk,
when the executor binds the leaves, and may return a numpy array or a torch
tensor; each block then goes up to the configured device once.
``LOADS`` counts the blocks loaded in walks (not the probe that finds a
dtype or grid at construction), so a slice that culls blocks shows in it.
"""

from __future__ import annotations

import functools
from numbers import Integral

import numpy as np
import torch

from dask_array_tpu_torch._chunks import cast, normalize_chunks, numpy_dtype
from dask_array_tpu_torch._executor import BlockView, iter_block_indices
from dask_array_tpu_torch._expr import ArrayExpr

LOADS = 0


class FromMap(ArrayExpr):
    """One host function call per block."""

    takes_narrow = True

    _parameters = ("func", "args_per_block", "chunks_", "_dtype", "kwargs", "name_", "opaque_")
    _defaults = {"kwargs": (), "name_": None, "opaque_": False}

    def _collection_name(self):
        return self.operand("name_") or self._name

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.chunks_), dtype=self._dtype)

    @functools.cached_property
    def _block_order(self):
        return list(iter_block_indices(tuple(len(c) for c in self.chunks_)))

    def _leaf_key(self, i):
        return f"frommap-{self._name}-{i}"

    def _leaf_buffers(self):
        kwargs = dict(self.kwargs or ())
        for i, args in enumerate(self.args_per_block):
            yield (self._leaf_key(i), _LazyBlock(self.func, args, kwargs))

    def _structural_operands(self):
        # func and args only decide the blocks' contents; the program's
        # shape is the chunk grid and the dtype
        from dask_array_tpu_torch._chunks import dtype_key

        return [("frommap", dtype_key(self._dtype)), self.chunks_]

    def _build(self, ctx):
        blocks = {}
        resolved = [list(c) for c in self.chunks_]
        for i, idx in enumerate(self._block_order):
            val = ctx.leaf(self._leaf_key(i))
            if self.operand("opaque_"):
                # opaque payload blocks (store(load_stored=False): each block
                # is the write target object): no shape contract
                blocks[tuple(idx)] = val
                continue
            want = tuple(self.chunks_[ax][j] for ax, j in enumerate(idx))
            if any(w != w for w in want):
                # nan dims (from_delayed(shape=(nan,))): the declared shape is
                # unknown, so the made block's shape is adopted
                if len(val.shape) != len(want):
                    raise ValueError(
                        f"from_map block {tuple(idx)} has ndim {len(val.shape)}, expected {len(want)}"
                    )
                for ax, j in enumerate(idx):
                    size = int(val.shape[ax])
                    prev = resolved[ax][j]
                    if prev == prev and prev != size and not isinstance(prev, float):
                        raise ValueError(
                            f"from_map block {tuple(idx)} axis {ax} has size {size}, "
                            f"inconsistent with {prev} from a sibling"
                        )
                    resolved[ax][j] = size
                blocks[tuple(idx)] = cast(val, self._dtype)
                continue
            if tuple(val.shape) != want:
                # unit-axis folds (expand_dims into the loader grid) re-rank
                # blocks; a reordering of the elements (same size, permuted
                # dims) is a user error
                if tuple(d for d in val.shape if d != 1) != tuple(d for d in want if d != 1):
                    raise ValueError(
                        f"from_map block {tuple(idx)} has shape {tuple(val.shape)}, "
                        f"incompatible with the declared chunk shape: expected {want}"
                    )
                val = val.reshape(want)
            blocks[tuple(idx)] = cast(val, self._dtype)
        chunks = tuple(tuple(c) for c in resolved)
        return BlockView(chunks, blocks=blocks)

    def _accept_slice(self, index):
        """Cull untouched blocks: only the blocks a slice touches are
        loaded (the IO payoff of slice pushdown)."""
        from dask_array_tpu_torch._chunks import cached_cumsum
        from dask_array_tpu_torch._slicing import Slice, is_basic_index, normalize_slice

        if not is_basic_index(index):
            return None
        keep_ranges = []
        residual = []
        outer = []
        any_cull = False
        for ax, ind in enumerate(index):
            c = self.chunks_[ax]
            dim = sum(c)
            if isinstance(ind, Integral):
                ind = slice(int(ind), int(ind) + 1, 1)
                outer.append(0)
            else:
                outer.append(slice(None))
            sl = normalize_slice(ind, dim)
            start, stop, step = sl.indices(dim)
            if step != 1 or stop <= start:
                return None  # strided or empty: the slice stays above
            bounds = cached_cumsum(c, initial_zero=True)
            b0 = int(np.searchsorted(bounds, start, side="right")) - 1
            b1 = int(np.searchsorted(bounds, stop, side="left"))
            keep_ranges.append(range(b0, b1))
            if b0 > 0 or b1 < len(c):
                any_cull = True
            off = int(bounds[b0])
            residual.append(slice(start - off, stop - off, 1))
        if not any_cull:
            return None
        new_chunks = tuple(tuple(self.chunks_[ax][i] for i in r) for ax, r in enumerate(keep_ranges))
        grid = tuple(len(c) for c in self.chunks_)
        kept_args = []
        for flat, idx in enumerate(iter_block_indices(grid)):
            if all(idx[ax] in keep_ranges[ax] for ax in range(len(grid))):
                kept_args.append(self.args_per_block[flat])
        out = FromMap(self.func, tuple(kept_args), new_chunks, self._dtype, self.kwargs, None,
                      self.operand("opaque_"))
        if any(r != slice(0, sum(c), 1) for r, c in zip(residual, new_chunks)):
            out = Slice(out, tuple(residual))
        if any(isinstance(o, Integral) for o in outer):
            out = Slice(out, tuple(outer))
        return out


def fm_pinned(fm):
    """True when a FromMap leaf must not be rewritten or merged: a user's
    name pins its identity, and opaque payload blocks have no reshape or
    merge semantics."""
    return fm.operand("name_") is not None or bool(fm.operand("opaque_"))


class _LazyBlock:
    """A host block made on demand, when the executor binds the leaves."""

    __slots__ = ("func", "args", "kwargs", "_value")

    def __init__(self, func, args, kwargs):
        self.func = func
        self.args = args
        self.kwargs = kwargs
        self._value = None

    def materialize(self):
        global LOADS
        if self._value is None:
            out = self.func(
                *[_resolve_delayed(a) for a in self.args],
                **{k: _resolve_delayed(v) for k, v in self.kwargs.items()},
            )
            LOADS += 1
            self._value = out if isinstance(out, torch.Tensor) else np.asarray(out)
        return self._value


def _resolve_delayed(v):
    """Compute nested ``Delayed`` arguments, when the block is made."""
    if isinstance(v, Delayed):
        return v.compute()
    if isinstance(v, tuple):
        return tuple(_resolve_delayed(x) for x in v)
    if isinstance(v, list):
        return [_resolve_delayed(x) for x in v]
    return v


def _shape_dtype(out):
    """(shape, numpy dtype) of a loader's block: a tensor or array-like."""
    if isinstance(out, torch.Tensor):
        return tuple(out.shape), numpy_dtype(out.dtype)
    out = np.asarray(out)
    return out.shape, out.dtype


def from_map(func, *iterables, chunks=None, shape=None, args=None, dtype=None, meta=None, name=None,
             _opaque=False, **kwargs):
    """Create an Array from a function applied to each element of iterables.

    Each call makes one block (blocks stack along axis 0 unless
    ``chunks`` and ``shape`` describe a full grid).
    """
    from dask_array_tpu_torch._collection import new_collection

    if len(iterables) == 1 and isinstance(iterables[0], np.ndarray) and iterables[0].dtype == object:
        # a single object ndarray whose shape is the block grid (values[idx]
        # is block idx's argument): n-d, 0-d too
        values = iterables[0]
        if chunks is None:
            raise ValueError("from_map with an object values grid requires chunks=")
        if shape is not None:
            chunks = normalize_chunks(chunks, shape, dtype=dtype)
        chunks = tuple(tuple(int(x) for x in c) for c in chunks)
        grid = tuple(len(c) for c in chunks)
        if values.shape != grid:
            raise ValueError(
                f"from_map values grid {values.shape} does not match the block grid {grid} implied by chunks"
            )
        call_args = tuple((v,) + tuple(args or ()) for v in values.ravel(order="C"))
        if dtype is None:
            dtype = _shape_dtype(func(*call_args[0], **kwargs))[1]
        return new_collection(
            FromMap(func, call_args, chunks, np.dtype(dtype), tuple(sorted(kwargs.items())), name, _opaque)
        )

    iterables = [list(it) for it in iterables]
    if not iterables:
        raise ValueError("from_map requires at least one iterable")
    n = len(iterables[0])
    if not all(len(it) == n for it in iterables):
        raise ValueError("All iterables must have the same length")
    call_args = [tuple(it[i] for it in iterables) + tuple(args or ()) for i in range(n)]

    if dtype is None or chunks is None:
        bshape, bdtype = _shape_dtype(func(*call_args[0], **kwargs))
        if dtype is None:
            dtype = bdtype
        if chunks is None:
            # blocks concatenate along axis 0 (shape, if given, must agree)
            chunks = ((bshape[0],) * n,) + tuple((s,) for s in bshape[1:])
            if shape is not None and tuple(shape) != tuple(sum(c) for c in chunks):
                raise ValueError(
                    f"from_map: shape={shape} does not match the {n} stacked probe blocks of "
                    f"shape {bshape}; pass chunks= explicitly"
                )
    dtype = np.dtype(dtype)
    if shape is not None:
        chunks = normalize_chunks(chunks, shape, dtype=dtype)
    else:
        # chunks without shape must already be explicit tuples of tuples
        if not all(isinstance(c, (tuple, list)) for c in chunks):
            raise ValueError(
                "from_map: chunks given without shape= must be explicit per-axis tuples, e.g. chunks=((4, 4), (6,))"
            )
        chunks = tuple(tuple(int(x) for x in c) for c in chunks)
    nblocks = int(np.prod([len(c) for c in chunks]))
    if nblocks != n:
        raise ValueError(f"from_map got {n} calls but the chunk grid has {nblocks} blocks")
    return new_collection(
        FromMap(func, tuple(call_args), tuple(chunks), dtype, tuple(sorted(kwargs.items())), name, _opaque)
    )


class Delayed:
    """A small delayed-call handle (dask's ``dask.delayed`` in its place)."""

    __slots__ = ("func", "args", "kwargs", "_key")

    def __init__(self, func, args=(), kwargs=None, key=None):
        self.func = func
        self.args = args
        self.kwargs = kwargs or {}
        self._key = key

    def compute(self):
        return self.func(
            *[_resolve_delayed(a) for a in self.args],
            **{k: _resolve_delayed(v) for k, v in self.kwargs.items()},
        )


def delayed(func, *args, **kwargs):
    if args or kwargs:
        return Delayed(func, args, kwargs)

    def wrap(*a, **kw):
        return Delayed(func, a, kw)

    return wrap


def from_delayed(value, shape, dtype=None, meta=None, name=None):
    """Create an Array (one block) from a delayed or callable value."""
    from dask_array_tpu_torch._collection import new_collection

    if isinstance(value, Delayed):
        fn, args, kw = value.func, value.args, value.kwargs
    elif callable(value):
        fn, args, kw = value, (), {}
    else:
        raise TypeError("from_delayed expects a Delayed or a callable")
    if dtype is None:
        raise ValueError("from_delayed requires an explicit dtype")
    chunks = tuple((s,) for s in shape)
    return new_collection(FromMap(fn, (tuple(args),), chunks, np.dtype(dtype), tuple(sorted(kw.items())), name))


def from_blocks(blocks: dict, chunks, dtype=None, name=None):
    """Wrap precomputed blocks ``{idx: array-like}``: the caller supplies
    every block directly (external-graph interop without a scheduler)."""
    from dask_array_tpu_torch._collection import new_collection

    first = next(iter(blocks.values()))
    if dtype is None:
        dtype = _shape_dtype(first)[1]
    chunks = tuple(tuple(c) for c in chunks)
    order = list(iter_block_indices(tuple(len(c) for c in chunks)))
    missing = [idx for idx in order if tuple(idx) not in blocks]
    if missing:
        raise ValueError(f"from_blocks: missing blocks {missing[:4]}...")
    args = tuple((tuple(idx),) for idx in order)
    getter = _BlockGetter({tuple(k): v for k, v in blocks.items()})
    return new_collection(FromMap(getter, args, chunks, np.dtype(dtype), ()))


class _BlockGetter:
    def __init__(self, blocks):
        self.blocks = blocks

    def __call__(self, idx):
        return self.blocks[idx]
