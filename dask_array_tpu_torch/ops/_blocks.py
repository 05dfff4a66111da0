"""The ``.blocks`` accessor: index an array by block coordinates.

Port of ``dask_array_tpu/ops/_blocks.py``.  Selecting blocks maps to
element slices over the block boundaries, so the result is an ordinary
(sliced, concatenated) expression.
"""

from __future__ import annotations

import itertools
from numbers import Integral

import numpy as np

from dask_array_tpu_torch._chunks import cached_cumsum


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
