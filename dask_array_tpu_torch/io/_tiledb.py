"""TileDB IO, gated on the optional tiledb package.

Port of ``dask_array_tpu/io/_tiledb.py``: without tiledb both functions
raise ``ImportError``.
"""

from __future__ import annotations

import numpy as np


def _require_tiledb():
    try:
        import tiledb
    except ImportError as e:
        raise ImportError("from_tiledb/to_tiledb require the optional dependency `tiledb`") from e
    return tiledb


def from_tiledb(uri, attribute=None, chunks=None, storage_options=None, **kwargs):
    """Load a chunked array from a TileDB array (URI or open handle).

    Chunks default to the store's tile extents so reads stay
    granule-aligned.
    """
    tiledb = _require_tiledb()
    from dask_array_tpu_torch.io._from_map import from_map
    from dask_array_tpu_torch._chunks import normalize_chunks

    if isinstance(uri, tiledb.Array):
        tdb = uri
    else:
        tdb = tiledb.open(uri, **(storage_options or {}))
    schema = tdb.schema
    if attribute is None:
        attribute = schema.attr(0).name
    shape = tuple(int(schema.domain.dim(i).size) for i in range(schema.ndim))
    dtype = schema.attr(attribute).dtype
    if chunks is None:
        chunks = tuple(int(schema.domain.dim(i).tile) for i in range(schema.ndim))
    chunks = normalize_chunks(chunks, shape, dtype=dtype)

    import itertools

    bounds = [np.cumsum((0,) + tuple(c)) for c in chunks]
    slices = [
        tuple(slice(int(bounds[ax][i]), int(bounds[ax][i + 1])) for ax, i in enumerate(idx))
        for idx in itertools.product(*[range(len(c)) for c in chunks])
    ]

    def load(sl):
        return tdb[sl][attribute]

    return from_map(load, slices, chunks=chunks, shape=shape, dtype=dtype)


def to_tiledb(darray, uri, compute=True, return_stored=False, storage_options=None, **kwargs):
    """Write a chunked array to a TileDB array (creating it if needed).

    ``compute=False`` returns a lazy store barrier; ``return_stored=True``
    returns arrays whose blocks read back from the written store.
    """
    tiledb = _require_tiledb()
    from dask_array_tpu_torch.io._store import store

    if isinstance(uri, tiledb.Array):
        tdb = uri
    else:
        key = (storage_options or {}).get("key")
        tdb = tiledb.empty_like(uri, darray, key=key, **kwargs)
    return store(darray, tdb, compute=compute, return_stored=return_stored, lock=False)
