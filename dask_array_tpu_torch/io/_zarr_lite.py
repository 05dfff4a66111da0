"""Minimal vendored zarr v2/v3 directory-store backend.

A copy of ``dask_array_tpu/io/_zarr_lite.py`` (numpy and the standard
library).  Neither this image nor the card's machine ships ``zarr``, so
this module implements the small, well-specified subset the IO layer
needs: local directory stores, C order, raw/zlib/gzip compression, in a
format interoperable with real zarr (v2 ``.zarray`` JSON + ``i.j`` chunk
files; v3 ``zarr.json`` + ``c/i/j`` chunk files with the ``bytes``/``gzip``
codecs).  When the real ``zarr`` package is importable it is preferred
(``io/_zarr.py:_require_zarr``).  Storage semantics: regular chunk grids,
edge chunks stored padded to full chunk shape, missing chunks read as
``fill_value``, read-modify-write partial chunk updates.
"""

from __future__ import annotations

import gzip as _gzip
import itertools
import json
import math
import os
import zlib as _zlib

import numpy as np

_V3_DTYPES = {
    "bool": "?",
    "int8": "i1", "int16": "i2", "int32": "i4", "int64": "i8",
    "uint8": "u1", "uint16": "u2", "uint32": "u4", "uint64": "u8",
    "float16": "f2", "float32": "f4", "float64": "f8",
    "complex64": "c8", "complex128": "c16",
}
_V3_NAMES = {np.dtype(v).str.lstrip("<>|="): k for k, v in _V3_DTYPES.items()}


def _encode_fill(v, dtype):
    if v is None:
        return None
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    if np.issubdtype(dtype, np.bool_):
        return bool(v)
    if np.issubdtype(dtype, np.integer):
        return int(v)
    return float(v)


def _decode_fill(v, dtype):
    if v is None:
        return 0
    if v == "NaN":
        return np.nan
    if v in ("Infinity", "-Infinity"):
        return np.inf if v == "Infinity" else -np.inf
    return v


class ZarrLiteArray:
    """One zarr array in a local directory store."""

    def __init__(self, root, shape, dtype, chunks, zarr_format, fill_value, compressor):
        self._root = root
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.chunks = tuple(int(c) for c in chunks)
        self.zarr_format = zarr_format
        self.fill_value = fill_value
        self.compressor = compressor  # None | "zlib" | "gzip"

    # -- metadata -------------------------------------------------------------

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def _grid(self):
        return tuple(
            -(-s // c) if c else 0 for s, c in zip(self.shape, self.chunks)
        )

    @classmethod
    def create(cls, root, shape, dtype, chunks, zarr_format=2, fill_value=0, compressor=None, overwrite=False):
        meta_name = ".zarray" if zarr_format == 2 else "zarr.json"
        meta_path = os.path.join(root, meta_name)
        exists = os.path.exists(os.path.join(root, ".zarray")) or os.path.exists(
            os.path.join(root, "zarr.json")
        )
        if exists and not overwrite:
            existing = cls.open(root)
            if existing.shape != tuple(shape) or existing.dtype != np.dtype(dtype):
                raise ValueError(
                    f"array exists at {root!r} with different shape/dtype"
                )
            return existing
        if exists and overwrite:
            # mode="w" must leave NO trace of the previous array: stale chunk
            # files would otherwise be read back as data (or old metadata of
            # the other format would shadow the new zarr.json/.zarray)
            import shutil

            shutil.rmtree(root)
        os.makedirs(root, exist_ok=True)
        dtype = np.dtype(dtype)
        arr = cls(root, shape, dtype, chunks, zarr_format, fill_value, compressor)
        if zarr_format == 2:
            meta = {
                "zarr_format": 2,
                "shape": list(arr.shape),
                "chunks": list(arr.chunks),
                "dtype": dtype.str,
                "compressor": (
                    None if compressor is None else {"id": compressor, "level": 5}
                ),
                "fill_value": _encode_fill(fill_value, dtype),
                "order": "C",
                "filters": None,
                "dimension_separator": ".",
            }
        else:
            base = dtype.str.lstrip("<>|=")
            if base not in _V3_NAMES:
                raise ValueError(f"dtype {dtype} not supported by zarr v3 lite")
            codecs = [{"name": "bytes", "configuration": {"endian": "little"}}]
            if compressor == "gzip":
                codecs.append({"name": "gzip", "configuration": {"level": 5}})
            elif compressor is not None:
                raise ValueError("v3 lite supports only gzip compression")
            meta = {
                "zarr_format": 3,
                "node_type": "array",
                "shape": list(arr.shape),
                "data_type": _V3_NAMES[base],
                "chunk_grid": {
                    "name": "regular",
                    "configuration": {"chunk_shape": list(arr.chunks)},
                },
                "chunk_key_encoding": {
                    "name": "default",
                    "configuration": {"separator": "/"},
                },
                "codecs": codecs,
                "fill_value": _encode_fill(fill_value, dtype),
                "attributes": {},
            }
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        if zarr_format == 2:
            from dask_array_tpu_torch._chunks import dtype_key

            key = dtype_key(dtype)
            if dtype.kind == "V" and dtype.names is None and key != dtype.str:
                # ml_dtypes (bfloat16, ...): the .zarray descr is the raw
                # void storage type; record the LOGICAL dtype in .zattrs
                # (free-form sidecar — real zarr readers see plain void)
                with open(os.path.join(root, ".zattrs"), "w") as f:
                    json.dump({"dask_array_tpu:dtype": key}, f)
        arr._sep = "." if zarr_format == 2 else "/"
        return arr

    @classmethod
    def open(cls, root):
        v2 = os.path.join(root, ".zarray")
        v3 = os.path.join(root, "zarr.json")
        if os.path.exists(v2):
            meta = json.load(open(v2))
            if meta.get("filters"):
                raise ValueError("zarr lite does not support filters")
            if meta.get("order", "C") != "C":
                raise ValueError("zarr lite supports C order only")
            comp = meta.get("compressor")
            comp_id = None
            if comp is not None:
                comp_id = comp.get("id")
                if comp_id not in ("zlib", "gzip"):
                    raise ValueError(
                        f"zarr lite cannot decode compressor {comp_id!r}; "
                        "install the real zarr package"
                    )
            dtype = np.dtype(meta["dtype"])
            zattrs = os.path.join(root, ".zattrs")
            if dtype.kind == "V" and dtype.names is None and os.path.exists(zattrs):
                logical = json.load(open(zattrs)).get("dask_array_tpu:dtype")
                if logical is not None:
                    cand = np.dtype(logical)
                    if cand.itemsize == dtype.itemsize:
                        dtype = cand  # ml_dtypes round-trip (see create)
            arr = cls(
                root, meta["shape"], dtype, meta["chunks"], 2,
                _decode_fill(meta.get("fill_value"), dtype), comp_id,
            )
            arr._sep = meta.get("dimension_separator", ".")
            return arr
        if os.path.exists(v3):
            meta = json.load(open(v3))
            if meta.get("node_type") != "array":
                raise ValueError(f"no zarr array at {root!r}")
            grid = meta["chunk_grid"]
            if grid.get("name") != "regular":
                raise ValueError("zarr lite supports regular chunk grids only")
            dtype = np.dtype(_V3_DTYPES[meta["data_type"]])
            comp_id = None
            for codec in meta.get("codecs", []):
                name = codec.get("name")
                if name == "bytes":
                    if codec.get("configuration", {}).get("endian", "little") != "little":
                        raise ValueError("zarr lite reads little-endian only")
                elif name == "gzip":
                    comp_id = "gzip"
                else:
                    raise ValueError(
                        f"zarr lite cannot decode codec {name!r}; "
                        "install the real zarr package"
                    )
            arr = cls(
                root, meta["shape"], dtype.newbyteorder("<"),
                grid["configuration"]["chunk_shape"], 3,
                _decode_fill(meta.get("fill_value"), dtype), comp_id,
            )
            arr._sep = meta.get("chunk_key_encoding", {}).get(
                "configuration", {}
            ).get("separator", "/")
            return arr
        raise FileNotFoundError(f"no zarr array metadata under {root!r}")

    # -- chunk codec ------------------------------------------------------------

    def _chunk_path(self, idx):
        if self.zarr_format == 2:
            return os.path.join(self._root, self._sep.join(map(str, idx)) or "0")
        return os.path.join(self._root, "c", *map(str, idx))

    def _decode(self, payload):
        if self.compressor == "zlib":
            payload = _zlib.decompress(payload)
        elif self.compressor == "gzip":
            payload = _gzip.decompress(payload)
        return np.frombuffer(payload, dtype=self.dtype).reshape(self.chunks).copy()

    def _encode(self, block):
        payload = np.ascontiguousarray(block, dtype=self.dtype).tobytes()
        if self.compressor == "zlib":
            payload = _zlib.compress(payload, 5)
        elif self.compressor == "gzip":
            payload = _gzip.compress(payload, 5)
        return payload

    def _read_chunk(self, idx):
        path = self._chunk_path(idx)
        if not os.path.exists(path):
            fill = self.fill_value if self.fill_value is not None else 0
            return np.full(self.chunks, fill, dtype=self.dtype)
        with open(path, "rb") as f:
            return self._decode(f.read())

    def _write_chunk(self, idx, block):
        path = self._chunk_path(idx)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(self._encode(block))

    # -- slicing -----------------------------------------------------------------

    def _normalize_index(self, index):
        if not isinstance(index, tuple):
            index = (index,)
        if len(index) < self.ndim:
            index = index + (slice(None),) * (self.ndim - len(index))
        out = []
        for sl, dim in zip(index, self.shape):
            if isinstance(sl, slice):
                start, stop, step = sl.indices(dim)
                if step != 1:
                    raise ValueError("zarr lite supports contiguous slices only")
                out.append((start, stop))
            else:
                raise ValueError("zarr lite supports slice indexing only")
        return out

    def __getitem__(self, index):
        bounds = self._normalize_index(index)
        out = np.empty([hi - lo for lo, hi in bounds], dtype=self.dtype)
        ranges = [
            range(lo // c, -(-hi // c) if hi > lo else lo // c)
            for (lo, hi), c in zip(bounds, self.chunks)
        ]
        for idx in itertools.product(*ranges):
            block = self._read_chunk(idx)
            src, dst = [], []
            for ax, (i, (lo, hi)) in enumerate(zip(idx, bounds)):
                c = self.chunks[ax]
                blo, bhi = i * c, min((i + 1) * c, self.shape[ax])
                s, e = max(lo, blo), min(hi, bhi)
                src.append(slice(s - blo, e - blo))
                dst.append(slice(s - lo, e - lo))
            out[tuple(dst)] = block[tuple(src)]
        return out

    def __setitem__(self, index, value):
        bounds = self._normalize_index(index)
        value = np.broadcast_to(
            np.asarray(value, dtype=self.dtype),
            tuple(hi - lo for lo, hi in bounds),
        )
        ranges = [
            range(lo // c, -(-hi // c) if hi > lo else lo // c)
            for (lo, hi), c in zip(bounds, self.chunks)
        ]
        for idx in itertools.product(*ranges):
            src, dst, full = [], [], True
            for ax, (i, (lo, hi)) in enumerate(zip(idx, bounds)):
                c = self.chunks[ax]
                blo, bhi = i * c, min((i + 1) * c, self.shape[ax])
                s, e = max(lo, blo), min(hi, bhi)
                src.append(slice(s - blo, e - blo))
                dst.append(slice(s - lo, e - lo))
                if s != blo or e != blo + c:
                    full = False  # partial coverage (incl. padded edge)
            if full:
                block = value[tuple(dst)]
            else:
                block = self._read_chunk(idx)  # read-modify-write
                block[tuple(src)] = value[tuple(dst)]
            self._write_chunk(idx, block)


def open_array(url, mode="r", path=None, shape=None, dtype=None, chunks=None, zarr_format=2, fill_value=0, compressor=None, storage_options=None, **kwargs):
    """zarr.open_array-alike over the lite backend (local paths only)."""
    if storage_options:
        raise ValueError(
            "storage_options require the real zarr package (lite backend is "
            "local-filesystem only)"
        )
    root = os.fspath(url)
    if path:
        root = os.path.join(root, path)
    if mode == "r":
        return ZarrLiteArray.open(root)
    if mode in ("a", "w", "w-"):
        if mode == "w-" and (
            os.path.exists(os.path.join(root, ".zarray"))
            or os.path.exists(os.path.join(root, "zarr.json"))
        ):
            # exclusive create: zarr raises ContainsArrayError here
            raise FileExistsError(f"array already exists at {root!r} (mode='w-')")
        if shape is None:
            try:
                return ZarrLiteArray.open(root)
            except FileNotFoundError:
                raise ValueError("creating a zarr array requires shape=")
        if chunks is None:
            chunks = shape
        return ZarrLiteArray.create(
            root, shape, dtype, chunks, zarr_format=zarr_format,
            fill_value=fill_value, compressor=compressor,
            overwrite=(mode == "w"),
        )
    raise ValueError(f"unsupported mode {mode!r}")


# zarr-module-shaped shim: io/_zarr.py uses `zarr.Array` and `zarr.open_array`
Array = ZarrLiteArray
