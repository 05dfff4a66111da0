"""zarr IO: from_zarr / to_zarr.

Port of ``dask_array_tpu/io/_zarr.py``: region-aware writes, chunk
regularity checks, v2/v3.  The real zarr package is used where it is
importable; else the vendored lite store (``io/_zarr_lite.py``), so the
checkpoint path always runs.  ``from_zarr`` reads one ``from_map`` block
per chunk region, so a slice loads only the chunk files it touches.
"""

from __future__ import annotations

import math

import numpy as np

from dask_array_tpu_torch._chunks import PerformanceWarning


def _require_zarr():
    """The real zarr package when importable, else the vendored lite
    backend (``io/_zarr_lite.py``: v2/v3 local directory stores)."""
    try:
        import zarr

        return zarr
    except ImportError:
        from dask_array_tpu_torch.io import _zarr_lite

        return _zarr_lite


def from_zarr(url, component=None, storage_options=None, chunks=None, name=None, inline_array=False, **kwargs):
    """Read a zarr array lazily (one from_map block per zarr chunk region)."""
    zarr = _require_zarr()
    from dask_array_tpu_torch.io._from_map import from_map
    from dask_array_tpu_torch._chunks import normalize_chunks

    if isinstance(url, zarr.Array):
        z = url
    else:
        z = zarr.open_array(url, mode="r", path=component, storage_options=storage_options, **kwargs)
    chunks = chunks if chunks is not None else z.chunks
    chunks = normalize_chunks(chunks, z.shape, dtype=z.dtype)

    import itertools

    bounds = [np.cumsum((0,) + tuple(c)) for c in chunks]
    grid = [range(len(c)) for c in chunks]
    slices = []
    for idx in itertools.product(*grid):
        slices.append(
            tuple(
                slice(int(bounds[ax][i]), int(bounds[ax][i + 1]))
                for ax, i in enumerate(idx)
            )
        )

    def load(sl):
        return z[sl]

    shape = z.shape
    return from_map(load, slices, chunks=chunks, shape=shape, dtype=z.dtype)


def _window_blockdim(chunks, sl, dim):
    """Chunk profile of the window ``sl`` cut out of an axis chunked as
    ``chunks`` (each output chunk is the window's overlap with one chunk)."""
    start, stop, _ = sl.indices(int(dim))
    out = []
    pos = 0
    for c in chunks:
        lo, hi = max(start, pos), min(stop, pos + c)
        if hi > lo:
            out.append(hi - lo)
        pos += c
    return tuple(out) or (0,)


def _align_to_existing(arr, z, region):
    """Rechunk ``arr`` so every dask chunk is a whole multiple of the target
    zarr array's on-disk chunks — partial-granule writes from different dask
    blocks would race / read-modify-write.  Warns ``PerformanceWarning`` when
    a rechunk is forced."""
    import warnings

    from dask_array_tpu_torch._chunks import normalize_chunks
    from dask_array_tpu_torch._slicing import normalize_index

    granules = tuple(int(c) for c in z.chunks)
    target = normalize_chunks(
        "auto", shape=tuple(z.shape), dtype=z.dtype,
        previous_chunks=tuple((g,) for g in granules),
    )
    if region is not None:
        index = normalize_index(region, tuple(z.shape))
        if not all(isinstance(r, slice) and (r.step or 1) == 1 for r in index):
            return arr  # exotic region: leave the caller's chunking alone
        target = tuple(
            _window_blockdim(c, r, s)
            for s, c, r in zip(z.shape, target, index)
        )
    if tuple(arr.chunks) == tuple(target):
        return arr
    if region is not None:
        # a region window may start mid-granule; the windowed target keeps
        # interior boundaries granule-aligned in the global frame
        return arr.rechunk(target)
    for ax, (dw, zw) in enumerate(zip(arr.chunks, granules)):
        # every chunk but the trailing remainder must cover whole granules,
        # else two dask blocks share one on-disk chunk (read-modify-write)
        if any(c % zw != 0 for c in dw[:-1]):
            warnings.warn(
                f"The input array will be rechunked along axis {ax}: its "
                f"chunks {dw} are not multiples of the Zarr array's "
                f"on-disk chunk size {zw}, which is required to write "
                "safely. Rechunk to a multiple yourself to avoid this.",
                PerformanceWarning,
                stacklevel=3,
            )
            break
    else:
        # already granule-aligned everywhere: write as-is
        return arr
    return arr.rechunk(target)


def to_zarr(arr, url, component=None, storage_options=None, overwrite=False, region=None, compute=True, return_stored=False, **kwargs):
    """Write an Array to zarr (regular chunks required, as dask requires)."""
    zarr = _require_zarr()
    from dask_array_tpu_torch._collection import Array
    from dask_array_tpu_torch.io._store import store

    if not isinstance(arr, Array):
        raise TypeError("to_zarr expects an Array")
    if any(
        any(isinstance(c, float) and math.isnan(c) for c in axis) for axis in arr.chunks
    ):
        raise ValueError(
            "Attempting to save array with unknown chunk sizes; call "
            "compute_chunk_sizes() first"
        )
    # zarr requires regular chunking (all equal except possibly the last);
    # irregular grids auto-rechunk with a warning, as dask's do
    irregular = any(
        len(set(axis[:-1])) > 1 or (len(axis) > 1 and axis[-1] > axis[0])
        for axis in arr.chunks
    )
    if irregular and not isinstance(url, zarr.Array):
        import warnings

        warnings.warn(
            "The array uses irregular chunk sizes; rechunking to regular "
            "(uniform) chunks so the data can be written safely. Rechunk "
            "manually (arr = arr.rechunk(...)) to avoid this.",
            PerformanceWarning,
            stacklevel=2,
        )
        arr = arr.rechunk(tuple(max(axis) for axis in arr.chunks))
    if isinstance(url, zarr.Array):
        z = url
        arr = _align_to_existing(arr, z, region)
    elif region is not None:
        # region writes target an EXISTING array (the patch's shape is a
        # window of it, not the array's shape)
        z = zarr.open_array(
            url, mode="a", path=component,
            storage_options=storage_options, **kwargs,
        )
        arr = _align_to_existing(arr, z, region)
    else:
        # an explicit chunks= targets the on-disk granularity; default to
        # the array's own grid
        store_chunks = kwargs.pop("chunks", tuple(c[0] for c in arr.chunks))
        z = zarr.open_array(
            url,
            mode="w" if overwrite else "a",
            path=component,
            shape=arr.shape,
            dtype=arr.dtype,
            chunks=store_chunks,
            storage_options=storage_options,
            **kwargs,
        )
        arr = _align_to_existing(arr, z, None)
    return store(arr, z, regions=region, compute=compute, return_stored=return_stored, lock=False)
