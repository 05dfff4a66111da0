"""Lazy reads from HDF5 datasets (the complement of to_hdf5).

Port of ``dask_array_tpu/io/_hdf5_read.py``.  ``from_array`` of an h5py
dataset works too (the dataset is an array-like store), but its handle
then lives in the leaf; ``from_hdf5`` opens the file per block instead, so
the expression pickles and file handles live only while a block loads.
h5py is imported where it is called.
"""

from __future__ import annotations

import numpy as np


def from_hdf5(filename, datapath, chunks=None):
    import h5py

    from dask_array_tpu_torch._chunks import normalize_chunks
    from dask_array_tpu_torch.io._from_map import from_map

    with h5py.File(filename, "r") as f:
        dset = f[datapath]
        shape = dset.shape
        dtype = dset.dtype
        native = dset.chunks
    if chunks is None:
        chunks = native if native else "auto"
    chunks = normalize_chunks(chunks, shape, dtype=dtype)

    import itertools

    bounds = [np.cumsum((0,) + tuple(c)) for c in chunks]
    slices = [
        tuple(slice(int(bounds[ax][i]), int(bounds[ax][i + 1])) for ax, i in enumerate(idx))
        for idx in itertools.product(*[range(len(c)) for c in chunks])
    ]

    def load(sl):
        with h5py.File(filename, "r") as f:
            return f[datapath][sl]

    return from_map(load, slices, chunks=chunks, shape=shape, dtype=dtype)
