"""Shuffle: reorder the elements along one axis by groups of positions.

Port of ``dask_array_tpu/_shuffle.py``: each indexer group becomes one
output chunk (small neighbouring groups merged toward the mean input
chunk); the reorder is one ``index_select`` along the axis from an int64
leaf, its positions checked on the host when the expression is built, so
no out-of-range gather ever launches.  ``transfer_bytes`` is the JAX
package's estimate of the bytes the reorder moves between blocks.
"""

from __future__ import annotations

import functools
from numbers import Integral

import numpy as np
import torch

from dask_array_tpu_torch._chunks import moved, validate_axis
from dask_array_tpu_torch._executor import BlockView
from dask_array_tpu_torch._expr import ArrayExpr


class Shuffle(ArrayExpr):
    takes_narrow = True

    _parameters = ("array", "indexer", "axis")

    @functools.cached_property
    def chunks(self):
        chunks = list(self.array.chunks)
        chunks[self.axis] = tuple(len(g) for g in self.indexer)
        return tuple(chunks)

    @property
    def _meta(self):
        return self.array._meta

    @functools.cached_property
    def _flat_index(self):
        return np.concatenate([np.asarray(g, dtype=np.int64) for g in self.indexer])

    def _simplify_down(self):
        # an identity shuffle (the groups are the chunks, in order) goes
        flat = self._flat_index
        n = self.array.shape[self.axis]
        if (not (isinstance(n, float) and np.isnan(n)) and len(flat) == n and np.array_equal(flat, np.arange(n))
                and self.chunks == self.array.chunks):
            return self.array
        return None

    def _accept_slice(self, index):
        """Slices on the other axes commute below the shuffle."""
        from dask_array_tpu_torch._slicing import Slice, is_basic_index

        if not is_basic_index(index) or any(isinstance(i, Integral) for i in index):
            return None
        if index[self.axis] != slice(None) or all(i == slice(None) for i in index):
            return None
        return Shuffle(Slice(self.array, tuple(index)), self.indexer, self.axis)

    @functools.cached_property
    def _index_key(self):
        return f"shuffle-{self._name}"

    def _leaf_buffers(self):
        yield (self._index_key, self._flat_index)

    def _build(self, ctx):
        dense = ctx.build(self.array).dense()
        out = moved(torch.index_select, dense, self.axis, ctx.leaf(self._index_key))
        return BlockView(self.chunks, dense=out)

    def transfer_bytes(self):
        """(min, max) bytes between blocks: the gathered share of the
        input, as the JAX package estimates it."""
        nb = self.array.nbytes
        if isinstance(nb, float) and np.isnan(nb):
            return (0, 0)
        out_elems = sum(len(g) for g in self.indexer)
        n = self.array.shape[self.axis]
        return (0, int(nb * out_elems / max(1, n)))


def shuffle(x, indexer, axis=0, chunks="auto"):
    """Reorder ``x`` along ``axis`` by ``indexer``, a list of lists of
    positions; each group lands in one output chunk (small neighbouring
    groups merged toward the mean input chunk, within
    ``array.chunk-size-tolerance``)."""
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch._collection import Array, new_collection

    expr = x.expr if isinstance(x, Array) else x
    axis = validate_axis(axis, expr.ndim)
    if not isinstance(indexer, (list, tuple)) or not all(isinstance(g, (list, tuple, np.ndarray)) for g in indexer):
        raise ValueError("indexer must be a list of lists of ints")
    indexer = [tuple(int(i) for i in g) for g in indexer]
    n = expr.shape[axis]
    for g in indexer:
        for i in g:
            if i < 0 or i >= n:
                raise IndexError(f"indexer position {i} out of bounds for axis of size {n}")
    tol = config.get("array.chunk-size-tolerance", 1.25)
    mean = np.mean(expr.chunks[axis]) if len(expr.chunks[axis]) else 1
    limit = int(mean * tol)
    merged: list = []
    for g in indexer:
        if merged and len(merged[-1]) + len(g) <= limit:
            merged[-1] = merged[-1] + g
        else:
            merged.append(tuple(g))
    return new_collection(Shuffle(expr, tuple(merged), axis))
