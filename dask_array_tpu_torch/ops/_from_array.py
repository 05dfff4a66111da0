"""FromArray: wrap a concrete numpy array as a leaf.

Port of ``dask_array_tpu/ops/_from_array.py``, including the deferred
``region`` slicing: pushed-down slices shrink what is copied to the device,
because the executor moves only ``source[region]``.
"""

from __future__ import annotations

import functools
from numbers import Integral

import numpy as np

from dask_array_tpu_torch._chunks import normalize_chunks, torch_dtype
from dask_array_tpu_torch._executor import BlockView
from dask_array_tpu_torch._expr import ArrayExpr
from dask_array_tpu_torch._slicing import fuse_slice, is_basic_index, sliced_blockdim


class FromArray(ArrayExpr):
    _parameters = ("source", "chunks_", "region", "name_")
    _defaults = {"region": None, "name_": None}

    _fusable_leaf = True

    def _collection_name(self):
        return self.operand("name_") or self._name

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.chunks_), dtype=self.source.dtype)

    @functools.cached_property
    def _leaf_key(self):
        return f"leaf-{self._name}"

    def _leaf_buffers(self):
        src = self.source
        if self.region is not None:
            src = src[tuple(self.region)]
        yield (self._leaf_key, src)

    def _build(self, ctx):
        return BlockView(self.chunks_, dense=ctx.leaf(self._leaf_key))

    def _accept_slice(self, index):
        if not is_basic_index(index):
            return None
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
        return FromArray(self.source, tuple(new_chunks), region)

    def _accept_rechunk(self, target_chunks):
        # in-memory source: slicing is free, so any grid is absorbed
        return FromArray(self.source, tuple(target_chunks), self.region)


def from_array(x, chunks="auto", name=None):
    """Create a lazy Array from a numpy array-like."""
    from dask_array_tpu_torch._collection import Array, new_collection

    if isinstance(x, Array):
        raise ValueError("Array is already a lazy dask_array_tpu_torch.Array")
    x = np.asarray(x)
    torch_dtype(x.dtype)  # refuse dtypes the port cannot compute in, now
    chunks = normalize_chunks(chunks, x.shape, dtype=x.dtype)
    return new_collection(FromArray(x, chunks, None, name))


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
