"""The ``.blocks`` accessor: index an array by block coordinates; and
``from_blocks``, an array made of computed device blocks.

Port of ``dask_array_tpu/ops/_blocks.py``.  Selecting blocks maps to
element slices over the block boundaries, so the result is an ordinary
(sliced, concatenated) expression.  ``FromBlocks`` is the port's own small
stand-in for the JAX package's ``io/_from_map.py::from_blocks`` (IO is a
later slice): its blocks stay where they were computed, on the device.
"""

from __future__ import annotations

import functools
import itertools
import uuid
from numbers import Integral

import numpy as np

from dask_array_tpu_torch._chunks import cached_cumsum, numpy_dtype
from dask_array_tpu_torch._executor import BlockView
from dask_array_tpu_torch._expr import ArrayExpr


class FromBlocks(ArrayExpr):
    """A leaf of computed tensors, one per block of ``chunks_``.

    Named by ``pinned_name`` (a token of its own), so tokenizing a plan
    that holds it never hashes, or copies, the tensors."""

    takes_narrow = True

    _parameters = ("blocks", "chunks_", "pinned_name")

    _fusable_leaf = True

    @property
    def _name(self):  # type: ignore[override]
        return self.pinned_name

    @property
    def deterministic_token(self):  # type: ignore[override]
        return self.pinned_name

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        dtype = numpy_dtype(next(iter(self.blocks.values())).dtype)
        return np.empty((0,) * len(self.chunks_), dtype=dtype)

    def _leaf_buffers(self):
        for idx, t in self.blocks.items():
            yield (f"{self.pinned_name}-{'.'.join(map(str, idx))}", t)

    def _build(self, ctx):
        blocks = {idx: ctx.leaf(f"{self.pinned_name}-{'.'.join(map(str, idx))}") for idx in self.blocks}
        return BlockView(self.chunks_, blocks=blocks)


def from_blocks(blocks: dict, chunks):
    """An Array of computed tensors keyed by block index (the full grid of
    ``chunks``); the tensors are used where they are, without a copy."""
    from dask_array_tpu_torch._collection import new_collection

    return new_collection(FromBlocks(dict(blocks), tuple(chunks), f"from-blocks-{uuid.uuid4().hex}"))


class BlockAccessor:
    def __init__(self, array):
        self._array = array

    @property
    def shape(self):
        return self._array.numblocks

    @property
    def size(self):
        return int(np.prod(self._array.numblocks))

    def ravel(self):
        return [self[idx] for idx in itertools.product(*(range(n) for n in self.shape))]

    def __iter__(self):
        return iter(self.ravel())

    def __getitem__(self, index):
        from dask_array_tpu_torch.ops.stacking import concatenate

        x = self._array
        if not isinstance(index, tuple):
            index = (index,)
        if len(index) > x.ndim:
            raise IndexError(f"too many indices for blocks: {index}")
        index = index + (slice(None),) * (x.ndim - len(index))

        out = x
        for ax, ind in enumerate(index):
            nblocks = len(out.chunks[ax])
            bounds = cached_cumsum(out.chunks[ax], initial_zero=True)

            def block_slice(b):
                sl = slice(int(bounds[b]), int(bounds[b + 1]))
                return out[tuple(sl if a == ax else slice(None) for a in range(out.ndim))]

            if isinstance(ind, Integral):
                b = int(ind)
                if b < -nblocks or b >= nblocks:
                    raise IndexError(f"block index {b} out of range for axis {ax}")
                out = block_slice(b % nblocks)
                continue
            if isinstance(ind, slice):
                sel = list(range(nblocks))[ind]
                if sel == list(range(nblocks)):
                    continue
            elif isinstance(ind, (list, np.ndarray)):
                sel = [int(b) % nblocks for b in np.asarray(ind).tolist()]
            else:
                raise IndexError(f"unsupported block index {ind!r}")
            parts = [block_slice(b) for b in sel]
            out = concatenate(parts, axis=ax) if len(parts) > 1 else parts[0]
        return out
