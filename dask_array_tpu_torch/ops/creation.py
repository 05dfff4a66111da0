"""Array creation: constant sources and ranges.

Port of the constant and range part of ``dask_array_tpu/ops/creation.py``
(``BroadcastTrick`` constant leaves with slice/rechunk absorption,
``Arange``).  Constants and ranges are generated on the execution device
(``torch.full``/``torch.arange``), so creation never touches the host.
"""

from __future__ import annotations

import functools
import math
from numbers import Integral

import numpy as np
import torch

from dask_array_tpu_torch._chunks import normalize_chunks, torch_dtype
from dask_array_tpu_torch._executor import BlockView
from dask_array_tpu_torch._expr import ArrayExpr
from dask_array_tpu_torch._slicing import sliced_blockdim


class BroadcastTrick(ArrayExpr):
    """A constant-fill leaf: absorbs slices and rechunks outright."""

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
        dense = torch.full(self.shape, fill, dtype=torch_dtype(self._dtype), device=ctx.device)
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


def _wrap_shape(shape):
    if isinstance(shape, Integral):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _make(cls, shape, dtype, chunks, fill_value=None, name=None):
    from dask_array_tpu_torch._collection import new_collection

    shape = _wrap_shape(shape)
    dtype = np.dtype(dtype if dtype is not None else float)
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
        dense = (self.start + idx * self.step).to(torch_dtype(self._dtype))
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
