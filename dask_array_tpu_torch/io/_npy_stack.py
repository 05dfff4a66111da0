"""npy-stack persistence: one .npy file per block along an axis, plus an
info file.

Port of ``dask_array_tpu/io/_npy_stack.py``; the on-disk format is dask's:
``<dirname>/<i>.npy`` and a pickled ``info`` with chunks, axis and dtype.
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def to_npy_stack(dirname, x, axis=0):
    """Write x to a directory of .npy files (one per block along ``axis``)."""
    from dask_array_tpu_torch._collection import Array

    if not isinstance(x, Array):
        raise TypeError("to_npy_stack expects an Array")
    chunks = tuple((c if i == axis else (sum(c),)) for i, c in enumerate(x.chunks))
    xx = x.rechunk(chunks)
    os.makedirs(dirname, exist_ok=True)
    meta = {"chunks": xx.chunks, "dtype": x.dtype, "axis": axis}
    with open(os.path.join(dirname, "info"), "wb") as f:
        pickle.dump(meta, f)
    dense = np.asarray(xx.compute())
    bounds = np.cumsum((0,) + tuple(xx.chunks[axis]))
    for i in range(len(xx.chunks[axis])):
        sl = tuple(
            slice(int(bounds[i]), int(bounds[i + 1])) if ax == axis else slice(None)
            for ax in range(x.ndim)
        )
        np.save(os.path.join(dirname, f"{i}.npy"), dense[sl])


def from_npy_stack(dirname, mmap_mode="r"):
    """Load an array saved by to_npy_stack."""
    from dask_array_tpu_torch.io._from_map import from_map

    with open(os.path.join(dirname, "info"), "rb") as f:
        info = pickle.load(f)
    chunks = info["chunks"]
    dtype = np.dtype(info["dtype"])
    axis = info["axis"]
    n = len(chunks[axis])

    def load(i):
        block = np.load(os.path.join(dirname, f"{i}.npy"), mmap_mode=mmap_mode)
        if block.dtype != dtype and block.dtype.itemsize == dtype.itemsize:
            # ml_dtypes round-trip: np.save writes bfloat16/float8 as raw
            # void descrs ('<V2'), so np.load returns void — the pickled
            # info dtype is the logical type; re-view restores it
            block = block.view(dtype)
        return block

    shape = tuple(sum(c) for c in chunks)
    return from_map(load, range(n), chunks=chunks, shape=shape, dtype=dtype)
