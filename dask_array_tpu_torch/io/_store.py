"""store(): write computed arrays into array-like targets; to_hdf5.

Port of ``dask_array_tpu/io/_store.py``: regions, locks, ``compute=False``
and ``return_stored``/``load_stored``.  Writing is host IO: each source
computes on the configured device (one walk per source), then each target
region is assigned on the host.
"""

from __future__ import annotations

import threading

import numpy as np


class SerializableLock:
    """A named lock usable across threads (dask's ``SerializableLock``)."""

    _locks: dict = {}
    _global = threading.Lock()

    def __init__(self, token=None):
        self.token = token or str(id(self))
        with SerializableLock._global:
            self.lock = SerializableLock._locks.setdefault(self.token, threading.Lock())

    def acquire(self, *args, **kwargs):
        return self.lock.acquire(*args, **kwargs)

    def release(self):
        return self.lock.release()

    def __enter__(self):
        self.lock.acquire()
        return self

    def __exit__(self, *exc):
        self.lock.release()

    def __reduce__(self):
        return (SerializableLock, (self.token,))


class _DelayedStore:
    """Handle returned by store(compute=False)."""

    def __init__(self, thunks):
        self._thunks = thunks

    def compute(self):
        for t in self._thunks:
            t()
        return None


def _compose_region(region, sl):
    """Target index for a source-block slice ``sl`` written into ``region``.

    Step-1 (or integer-start) region slices only; callers fall back to the
    whole-array write for anything fancier."""
    if region is None:
        return sl
    region = region if isinstance(region, tuple) else (region,)
    out = []
    for ax, s in enumerate(sl):
        r = region[ax] if ax < len(region) else slice(None)
        start = r.start or 0
        step = r.step or 1
        out.append(slice(start + s.start * step, start + (s.stop - 1) * step + 1, step))
    return tuple(out)


def _lazy_stored(src, tgt, region, lock, load_stored):
    """A lazy array whose block computation writes the block to the target
    and yields either the written value (``load_stored=True``) or the target
    object itself (``load_stored=False``, the icechunk contract: its blocks
    are object payloads that stay on the host)."""
    from dask_array_tpu_torch._executor import block_slices, iter_block_indices
    from dask_array_tpu_torch.io._from_map import from_map

    chunks = src.chunks
    state: dict = {}

    def dense_of():
        if "v" not in state:
            state["v"] = np.asarray(src.compute())
        return state["v"]

    def store_block(bid):
        sl = block_slices(chunks, tuple(bid))
        value = dense_of()[sl]
        if lock is not None:
            lock.acquire()
        try:
            tgt[_compose_region(region, sl)] = value
        finally:
            if lock is not None:
                lock.release()
        return value if load_stored else tgt

    ids = [tuple(int(i) for i in b) for b in iter_block_indices([len(c) for c in chunks])]
    dtype = src.dtype if load_stored else np.dtype(object)
    return from_map(store_block, ids, chunks=chunks, dtype=dtype, _opaque=not load_stored)


def store(sources, targets, lock=True, regions=None, compute=True, return_stored=False, load_stored=None, **kwargs):
    """Store lazy arrays into array-like (``__setitem__``-able) targets."""
    from dask_array_tpu_torch._collection import Array

    single = isinstance(sources, Array)
    if single:
        sources = [sources]
        targets = [targets]
    if len(sources) != len(targets):
        raise ValueError(
            f"Different number of sources [{len(sources)}] and targets [{len(targets)}]"
        )
    if isinstance(regions, tuple) or regions is None:
        regions = [regions] * len(sources)
    if len(regions) != len(sources):
        raise ValueError("Different number of sources and regions")

    if lock is True:
        lock = SerializableLock("store-global")
    elif lock is False or lock is None:
        lock = None

    def write_one(src, tgt, region):
        value = np.asarray(src.compute())
        if lock is not None:
            lock.acquire()
        try:
            if region is None:
                tgt[tuple(slice(0, s) for s in value.shape)] = value
            else:
                tgt[region] = value
        finally:
            if lock is not None:
                lock.release()
        return value

    if load_stored is None:
        load_stored = return_stored
    if return_stored and not load_stored and not compute:
        # the icechunk contract: a lazy array whose blocks are the write targets
        out = [_lazy_stored(s, t, r, lock, False) for s, t, r in zip(sources, targets, regions)]
        return out[0] if single else out
    if return_stored and not compute:
        out = [_lazy_stored(s, t, r, lock, True) for s, t, r in zip(sources, targets, regions)]
        return out[0] if single else out

    thunks = [
        (lambda s=s, t=t, r=r: write_one(s, t, r))
        for s, t, r in zip(sources, targets, regions)
    ]
    if not compute:
        return _DelayedStore(thunks)
    results = [t() for t in thunks]
    if return_stored:
        from dask_array_tpu_torch.ops._from_array import from_array

        out = []
        for s, t, r in zip(sources, targets, regions):
            if r is None:
                out.append(from_array(t, chunks=s.chunks))
            else:
                # the stored view is the written region of the target
                out.append(from_array(t, chunks="auto")[r])
        return out[0] if single else out
    return None


def to_hdf5(filename, *args, chunks=True, **kwargs):
    """Store arrays into an HDF5 file: to_hdf5(fn, '/x', x) or
    to_hdf5(fn, {'/x': x, '/y': y})."""
    import h5py

    if len(args) == 2 and isinstance(args[0], str):
        data = {args[0]: args[1]}
    elif len(args) == 1 and isinstance(args[0], dict):
        data = args[0]
    else:
        raise ValueError("Please use to_hdf5(fn, '/data', x) or to_hdf5(fn, {'/data': x})")

    with h5py.File(filename, mode="a") as f:
        dsets = []
        for dp, x in data.items():
            chunks_ds = (
                tuple(c[0] for c in x.chunks) if chunks is True else chunks
            )
            if dp in f:
                del f[dp]
            dsets.append(
                f.create_dataset(
                    dp,
                    shape=x.shape,
                    dtype=x.dtype,
                    chunks=chunks_ds if chunks else None,
                    **kwargs,
                )
            )
        store(list(data.values()), dsets, lock=SerializableLock(f"h5-{filename}"))
