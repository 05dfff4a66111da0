"""FromArray: wrap a concrete array or an array-like store as a leaf.

Port of ``dask_array_tpu/ops/_from_array.py``, including the deferred
``region`` slicing: pushed-down slices shrink what is copied to the device,
because the executor moves only ``source[region]``.  An array-like store
(an h5py dataset, a zarr array: anything with ``shape``, ``dtype`` and
``__getitem__``) is kept as it is and read at compute time, only the
region a slice needs; its grid defaults to the storage granule (its
``shards`` or ``chunks``), and a rechunk is absorbed only where its
boundaries land on granule edges.
"""

from __future__ import annotations

import functools
from numbers import Integral

import numpy as np
import torch

from dask_array_tpu_torch._chunks import host_only_dtype, normalize_chunks, numpy_dtype, torch_dtype
from dask_array_tpu_torch._executor import BlockView
from dask_array_tpu_torch._expr import ArrayExpr
from dask_array_tpu_torch._slicing import fuse_slice, is_basic_index, sliced_blockdim
from dask_array_tpu_torch.utils._tokenize import tokenize


def _storage_granule(src):
    """Per-axis storage read granule of ``src``: its ``.shards`` (the larger
    IO unit) or ``.chunks``, or None for in-memory arrays.  Lazy-indexing
    adapters (xarray's) wrap a chunked store without re-exposing its grid;
    the store is reached through the adapter chain (``.array`` /
    ``._array``), a handful deep at most."""
    for _ in range(16):
        if isinstance(src, np.ndarray) or hasattr(src, "device"):
            return None
        granule = getattr(src, "shards", None) or getattr(src, "chunks", None)
        if granule is not None:
            return granule
        nxt = getattr(src, "array", None)
        if nxt is None:
            nxt = getattr(src, "_array", None)
        if nxt is None or nxt is src:
            return None
        src = nxt
    return None


def is_store(x) -> bool:
    """An array-like that ``from_array`` keeps as it is: numpy's ``shape``
    and ``dtype`` and ``__getitem__``, but not a numpy array or scalar."""
    return (
        not isinstance(x, (np.ndarray, np.generic))
        and isinstance(getattr(x, "dtype", None), np.dtype)
        and hasattr(x, "shape")
        and hasattr(x, "__getitem__")
    )


class FromArray(ArrayExpr):
    takes_narrow = True

    _parameters = ("source", "chunks_", "region", "name_", "source_token")
    _defaults = {"region": None, "name_": None, "source_token": None}

    _fusable_leaf = True

    @functools.cached_property
    def deterministic_token(self) -> str:
        # ``from_array`` hashes the source once and every node a pushdown
        # derives from it (a slice, a region: each panel of the streaming
        # lane) names it by that token, and does not read it again
        tok = self.source_token
        if tok is None:
            return super().deterministic_token
        return tokenize(type(self).__qualname__, ("source-token", tok), *self.operands[1:4])

    def _collection_name(self):
        return self.operand("name_") or self._name

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _source_dtype(self):
        # a tensor source is a leaf the streaming lane made resident on the
        # card (``_streaming._pin_resident``)
        src = self.source
        return numpy_dtype(src.dtype) if isinstance(src, torch.Tensor) else src.dtype

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.chunks_), dtype=self._source_dtype)

    @functools.cached_property
    def _leaf_key(self):
        return f"leaf-{self._name}"

    def _leaf_buffers(self):
        src = self.source
        if self.region is not None:
            src = src[tuple(self.region)]
        yield (self._leaf_key, src)

    def _structural_operands(self):
        # the bound buffer's spec, not its contents: same-shaped datasets
        # share one structural key
        from dask_array_tpu_torch._chunks import dtype_key

        return [("buf", dtype_key(self._source_dtype)), self.chunks_]

    def _build(self, ctx):
        return BlockView(self.chunks_, dense=ctx.leaf(self._leaf_key))

    def _accept_slice(self, index):
        if not is_basic_index(index):
            return None
        if isinstance(self.source, torch.Tensor) and any(
            isinstance(i, slice) and (i.step or 1) < 0 for i in index
        ):
            return None  # torch slices take no negative step
        if self.region is not None:
            region = fuse_slice(tuple(self.region), tuple(index), self.source.shape)
            if region is None:
                return None
        else:
            region = tuple(index)
        new_chunks = []
        for ax, ind in enumerate(index):
            if isinstance(ind, Integral):
                continue
            if ind == slice(None):
                new_chunks.append(self.chunks_[ax])
            else:
                nc, _ = sliced_blockdim(self.chunks_[ax], ind)
                new_chunks.append(nc)
        return FromArray(self.source, tuple(new_chunks), region, None, self.source_token)

    @functools.cached_property
    def _storage_chunks(self):
        """Per-axis storage granule of a chunked store, or None for an
        in-memory source (where slicing is free)."""
        granule = _storage_granule(self.source)
        if granule is None:
            return None
        try:
            granule = tuple(int(c) for c in granule)
        except (TypeError, ValueError):
            return None
        if len(granule) != len(self.chunks_) or any(g <= 0 for g in granule):
            return None
        return granule

    def _accept_rechunk(self, target_chunks):
        storage = self._storage_chunks
        if storage is None:
            # in-memory source: slicing is free, so any grid is absorbed
            return FromArray(self.source, tuple(target_chunks), self.region, None, self.source_token)
        # chunked store: absorb only grids whose boundaries land on granule
        # boundaries (each granule read once); a finer axis reads at the
        # granule grid with the fine rechunk left outside
        from dask_array_tpu_torch._rechunk import Rechunk

        starts = tuple(
            (r.start or 0) if isinstance(r, slice) else 0
            for r in (self.region or (slice(None),) * len(storage))
        )
        leaf_chunks = []
        residual = False
        for ax, want in enumerate(target_chunks):
            s = storage[ax]
            off = starts[ax]
            bounds = np.cumsum((0,) + tuple(want))
            if all((off + int(b)) % s == 0 or b == bounds[-1] for b in bounds):
                leaf_chunks.append(tuple(want))
                continue
            total = int(bounds[-1])
            first = min(total, s - (off % s) if off % s else s)
            grid = [first]
            while sum(grid) < total:
                grid.append(min(s, total - sum(grid)))
            leaf_chunks.append(tuple(grid))
            residual = residual or tuple(grid) != tuple(want)
        leaf = (
            self
            if tuple(leaf_chunks) == self.chunks_
            else FromArray(self.source, tuple(leaf_chunks), self.region, None, self.source_token)
        )
        if not residual:
            return leaf
        if leaf is self:
            return None  # already reading at the granule grid: the Rechunk stays
        return Rechunk(leaf, tuple(target_chunks))


def from_array(x, chunks="auto", name=None, lock=False, asarray=None, fancy=True, meta=None, inline_array=False):
    """Create a lazy Array from a numpy array or an array-like store.

    A store (anything with ``shape``, ``dtype`` and ``__getitem__`` that is
    not a numpy array) is kept as it is and read at compute time, only the
    region a slice needs; its grid defaults to the storage granule.
    ``lock``, ``asarray``, ``fancy``, ``meta`` and ``inline_array`` are
    accepted for dask's signature: reads are serial, and the executor
    makes every block a tensor.  A masked array, a registered duck array
    (``register_chunk_type``) and records, strings or objects are kept as
    they are: their blocks compute on the host lane (``_host.py``).
    """
    from dask_array_tpu_torch._collection import Array, new_collection

    if isinstance(x, Array):
        raise ValueError("Array is already a lazy dask_array_tpu_torch.Array")
    if not is_store(x) and not isinstance(x, np.ma.MaskedArray):
        x = np.asarray(x)
    if not host_only_dtype(x.dtype):
        torch_dtype(x.dtype)  # refuse dtypes the port cannot compute in, now
    prev = None
    granule = _storage_granule(x)
    if granule is not None:
        try:
            prev = tuple((int(c),) for c in granule)
        except (TypeError, ValueError):
            prev = None
        if prev is not None and len(prev) != len(x.shape):
            prev = None
    chunks = normalize_chunks(chunks, tuple(x.shape), dtype=x.dtype, previous_chunks=prev)
    return new_collection(FromArray(x, chunks, None, name, tokenize(x)))


def asarray(a, chunks=None, dtype=None):
    from dask_array_tpu_torch._collection import Array

    if isinstance(a, Array):
        if dtype is not None and np.dtype(dtype) != a.dtype:
            return a.astype(dtype)
        return a
    return from_array(np.asarray(a, dtype=dtype), chunks=chunks if chunks is not None else "auto")


def asanyarray(a, dtype=None, order=None, *, like=None, inline_array=False):
    return asarray(a, dtype=dtype)


def array(x, dtype=None, ndmin=None, *, like=None):
    out = asarray(x, dtype=dtype)
    if ndmin is not None:
        while out.ndim < ndmin:
            out = out[None]
    return out
