"""Chunk-grid algebra: normalization, auto-chunking, unification helpers,
and the numpy <-> torch dtype map.

Chunks are a tuple (one entry per axis) of tuples of block sizes, e.g.
``((100, 100), (100, 100))`` for a (200, 200) array in 100x100 blocks.
Unknown block sizes are ``nan``.

Backend-neutral port of ``dask_array_tpu/_chunks.py``: the same
normalization and unification policies; long axes take the native plankit
library (``native/``), as in the JAX package.
"""

from __future__ import annotations

import functools
import math
import warnings
from numbers import Integral, Number

import numpy as np
import torch

from dask_array_tpu_torch import _narrow
from dask_array_tpu_torch._narrow import format_of


class PerformanceWarning(Warning):
    """A warning given when bad chunking may cause poor performance."""


CHUNKS_NONE_ERROR_MESSAGE = """
You must specify a chunks= keyword argument.
This specifies the chunksize of your array blocks.
""".lstrip()


def parse_bytes(s) -> int:
    """Parse a byte string ('128 MiB', '1kB', 128) to an int number of bytes."""
    if isinstance(s, (int, float)):
        return int(s)
    s = s.replace(" ", "").lower()
    suffixes = {
        "kib": 2**10, "mib": 2**20, "gib": 2**30, "tib": 2**40,
        "kb": 10**3, "mb": 10**6, "gb": 10**9, "tb": 10**12,
        "b": 1,
    }
    for suf in sorted(suffixes, key=len, reverse=True):
        if s.endswith(suf):
            return int(float(s[: -len(suf)]) * suffixes[suf])
    return int(float(s))


# ---------------------------------------------------------------------------
# dtypes: metadata follows numpy's rules; tensors carry the torch twin
# ---------------------------------------------------------------------------

# numpy dtype -> the torch dtype its blocks are held in
_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}

# ml_dtypes' extension floats that torch holds.  numpy knows them only when
# ml_dtypes is importable (nothing installs it for the port).  The narrow
# types torch has no dtype for (int2/int4, float4, float8_e3m4 ...) are held
# as uint8 bit patterns (``_narrow``); the two float6 types are refused by
# name (``torch_dtype``), as the JAX package cannot compute them either.
try:
    import ml_dtypes
except ImportError:  # pragma: no cover - the port runs without it
    ml_dtypes = None
ML_FLOATS = ("bfloat16", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz", "float8_e5m2fnuz")
if ml_dtypes is not None:
    for _name in ML_FLOATS:
        _TORCH_DTYPES[np.dtype(getattr(ml_dtypes, _name))] = getattr(torch, _name)
_NUMPY_DTYPES = {v: k for k, v in _TORCH_DTYPES.items()}
# a torch dtype numpy cannot hold as such crosses as the unsigned integer of
# its width (the bytes of ``torch.from_numpy`` and ``Tensor.numpy``)
_CROSSING = {t: (torch.uint16 if t.itemsize == 2 else torch.uint8) for t in _NUMPY_DTYPES
             if _NUMPY_DTYPES[t].type.__module__ == "ml_dtypes"}


def is_ml_dtype(dt) -> bool:
    """An ml_dtypes extension type (kind 'V' without fields, or 'f' for
    float8_e5m2)."""
    dt = np.dtype(dt)
    return dt.names is None and getattr(dt.type, "__module__", "") == "ml_dtypes"


def device_dtype(dt) -> np.dtype:
    """The numpy dtype a block of logical dtype ``dt`` holds on the device:
    datetime64 and timedelta64 as their int64 ticks (the unit stays in the
    metadata), anything else as it is."""
    dt = np.dtype(dt)
    return np.dtype(np.int64) if dt.kind in "Mm" else dt


def host_only_dtype(dt) -> bool:
    """True for dtypes with no device form (structured records, strings,
    objects): their blocks stay host numpy.  ml_dtypes types report kind
    'V' like records but are device dtypes (or refused by name)."""
    dt = np.dtype(dt)
    return dt.kind in "VUSOT" and not is_ml_dtype(dt)


def torch_dtype(dt) -> torch.dtype:
    """The torch dtype a block of numpy dtype ``dt`` is held in (datetime
    and timedelta blocks as int64 ticks)."""
    dt = device_dtype(dt)
    got = _TORCH_DTYPES.get(dt)
    if got is None:
        if format_of(dt) is not None:
            return torch.uint8  # the carrier of its bit patterns
        if is_ml_dtype(dt):
            raise TypeError(f"ml_dtypes.{dt.name} has no torch dtype: dask_array_tpu_torch holds "
                            f"{', '.join(ML_FLOATS + _narrow.NAMES)} of ml_dtypes' types")
        raise TypeError(f"dtype {dt} has no torch counterpart in dask_array_tpu_torch")
    return got


def tensor_of(arr: np.ndarray) -> torch.Tensor:
    """``torch.from_numpy`` for every held dtype: ml_dtypes floats cross as
    the unsigned integer of their width, datetimes as int64 ticks."""
    held = torch_dtype(arr.dtype)
    if format_of(arr.dtype) is not None:
        return torch.from_numpy(arr.view(np.uint8))
    cross = _CROSSING.get(held)
    if cross is not None:
        return torch.from_numpy(arr.view(_NUMPY_DTYPES[cross])).view(held)
    if arr.dtype.kind in "Mm":
        arr = arr.view(np.int64)
    return torch.from_numpy(arr)


def array_of(t: torch.Tensor, dtype=None) -> np.ndarray:
    """``Tensor.numpy()`` of a CPU tensor for every held dtype; a uint8
    carrier as the narrow ``dtype`` its patterns are elements of."""
    if dtype is not None and format_of(dtype) is not None:
        return t.numpy().view(dtype)
    cross = _CROSSING.get(t.dtype)
    if cross is not None:
        return t.view(cross).numpy().view(_NUMPY_DTYPES[t.dtype])
    return t.numpy()


def numpy_dtype(dt: torch.dtype) -> np.dtype:
    got = _NUMPY_DTYPES.get(dt)
    if got is None:
        raise TypeError(f"torch dtype {dt} has no numpy counterpart in dask_array_tpu_torch")
    return got


# numpy's unsigned integers.  torch holds uint16/32/64 tensors (views,
# copies, .numpy()) but computes almost nothing in them ("add_stub not
# implemented for 'UInt64'"), so a block of such a dtype is held in its torch
# twin and computed in a signed type: uint16 in int32 and uint32 in int64,
# exactly, and wrapped to the width when stored (numpy's modular result is
# the low bits); uint64 in the bits of an int64, where two's complement gives
# numpy's + - * << & | ^ ~ (ops/ufuncs.py::uint64_loop the rest).  Every
# conversion goes through a view as the signed type of the same width, so
# no torch kernel of an unsigned dtype is needed, on the CPU or the card.
_UINT64 = np.dtype(np.uint64)
_COMPUTE = {np.dtype(np.uint16): torch.int32, np.dtype(np.uint32): torch.int64, _UINT64: torch.int64}
# torch holds the float8 types but computes in none of them ("add_stub not
# implemented for 'Float8_e4m3fn'"): a value is computed in float32 and
# rounded back by its format's encode (``_narrow.HELD``), as ml_dtypes
# rounds it (torch's own conversion saturates float8_e4m3fn's overflow)
_FLOAT8 = {t for t in _NUMPY_DTYPES if t.itemsize == 1 and t.is_floating_point}
_COMPUTE.update({_NUMPY_DTYPES[t]: torch.float32 for t in _FLOAT8})
_SIGNED_TWIN = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}
_WRAP = {np.dtype(np.uint16): 0xFFFF, np.dtype(np.uint32): 0xFFFFFFFF}
INT64_MIN = -(1 << 63)


def is_narrow(dt) -> bool:
    """Whether numpy dtype ``dt`` is one byte an element that a node
    computes wider and rounds once: ml_dtypes' narrow types (held as uint8
    patterns, ``_narrow``) and torch's float8 types (computed in float32).
    A combine of per-shard parts would order the patterns as numbers or
    round once a part, so the mesh lanes leave such nodes to the dense
    build."""
    dt = np.dtype(dt)
    return format_of(dt) is not None or _TORCH_DTYPES.get(dt) in _FLOAT8


def compute_dtype(dt) -> torch.dtype:
    """The torch dtype a value of numpy dtype ``dt`` is computed in: int32
    for uint16, int64 for uint32 and uint64, float32 (int32) for a narrow
    float (integer) type, else ``torch_dtype(dt)``."""
    dt = np.dtype(dt)
    fmt = format_of(dt)
    if fmt is not None:
        return _narrow.compute_dtype(fmt)
    return _COMPUTE.get(dt) or torch_dtype(dt)


def u64_to_float(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint64 values held as int64 bits in float ``dtype``, rounded once as
    numpy's cast rounds them: a value of 2**63 or more is halved, keeping
    its last bit as a sticky bit, converted and doubled."""
    real = torch.float32 if dtype in (torch.float16, torch.float32, torch.complex64) else torch.float64
    halved = ((bits >> 1) & ~INT64_MIN) | (bits & 1)
    out = torch.where(bits < 0, halved.to(real) * 2, bits.to(real))
    return out.to(dtype)


def _float_to_u64(t: torch.Tensor) -> torch.Tensor:
    """numpy's float -> uint64 cast, as int64 bits: truncation toward zero,
    exact up to 2**64 (a negative value wraps through int64, as on x86; 2**64
    and above give x86's 0 on every device, where CUDA would saturate)."""
    top = 2.0**63
    high = torch.where(t >= 2 * top, INT64_MIN, (t - top).to(torch.int64))
    return torch.where(t >= top, high + INT64_MIN, t.to(torch.int64))


def to_compute(t: torch.Tensor, dt) -> torch.Tensor:
    """A held block ``t`` (its torch dtype names its numpy dtype) in
    ``compute_dtype(dt)``, converted as numpy's ``astype(dt)`` converts.
    For a narrow ``dt`` a uint8 ``t`` is a carrier of ``dt`` (a uint8
    block becomes a narrow one through ``convert``)."""
    dt = np.dtype(dt)
    want = compute_dtype(dt)
    fmt = format_of(dt)
    if fmt is not None:
        if t.dtype == torch.uint8:
            return _narrow.decode(t, fmt)  # a carrier of ``dt``
        if t.is_complex():
            t = t.real
        return t.to(torch.float32) if fmt.is_float else _narrow.decode(_narrow.encode(t, fmt), fmt)
    if t.dtype == want and dt not in _WRAP:
        return t
    if t.dtype == torch.uint64:
        t = t.view(torch.int64)
        if want.is_floating_point or want.is_complex:
            return u64_to_float(t, want)
    elif t.dtype in _SIGNED_TWIN:
        # uint16/32: the signed twin's bits, zero-extended (exact)
        same = t.dtype == _TORCH_DTYPES.get(dt)
        t = t.view(_SIGNED_TWIN[t.dtype]).to(torch.int64) & _WRAP[numpy_dtype(t.dtype)]
        if same:
            return t.to(want)
    elif t.is_complex() and dt.kind in "biu":
        t = t.real  # numpy drops the imaginary part (with a ComplexWarning)
    if t.is_floating_point() and dt.kind == "u":
        if dt == _UINT64:
            return _float_to_u64(t)
        t = t.to(torch.int64)  # truncate, then wrap below
    if dt in _WRAP:
        return (t.to(torch.int64) & _WRAP[dt]).to(want)
    return t.to(want)


def as_stored(t: torch.Tensor, dt) -> torch.Tensor:
    """A value computed in ``compute_dtype(dt)`` as the tensor a block of
    numpy dtype ``dt`` holds: the low bits of the signed type of the width,
    viewed as the unsigned one (int64 bits as uint64)."""
    dt = np.dtype(dt)
    fmt = format_of(dt)
    if fmt is not None:
        return t if t.dtype == torch.uint8 else _narrow.encode(t, fmt)
    held = _TORCH_DTYPES.get(dt)
    if held in _FLOAT8:
        return t if t.dtype == held else _narrow.encode(t, _narrow.HELD[dt.name]).view(held)
    twin = _SIGNED_TWIN.get(held)
    if twin is None:
        return t
    return (t if t.dtype == twin else t.to(twin)).view(held)


def cast(t: torch.Tensor, dt) -> torch.Tensor:
    """A held block, or a value in ``compute_dtype(dt)``, as the block of
    numpy dtype ``dt`` that numpy's ``astype`` makes of it.  A host block
    (``_host.is_host_block``) is cast by numpy."""
    if not isinstance(t, torch.Tensor):
        return t if t.dtype == np.dtype(dt) else t.astype(dt)
    if t.dtype == torch_dtype(dt):
        return t
    return as_stored(t if t.dtype == compute_dtype(dt) else to_compute(t, dt), dt)


def convert(t: torch.Tensor, src, dst) -> torch.Tensor:
    """numpy's ``astype(dst)`` of a held block ``t`` of numpy dtype
    ``src``, where either may be a narrow type: a narrow source decodes to
    its value first, a narrow target encodes the value (``_narrow``)."""
    fs, fd = format_of(src), format_of(dst)
    if fs is not None:
        return _narrow.recast(t, fs, fd) if fd is not None else cast(_narrow.decode(t, fs), dst)
    if fd is None:
        return cast(t, dst)
    if t.dtype == torch.uint64:
        t = u64_to_float(t.view(torch.int64), torch.float64) if fd.is_float else t.view(torch.int64)
    t = computable(t)
    return _narrow.encode(t.real if t.is_complex() else t, fd)


def value_of(t, dt):
    """A held block of numpy dtype ``dt`` with a narrow type's carrier
    decoded to its values (float32 or int32); any other block as it is."""
    fmt = format_of(dt)
    if fmt is not None and isinstance(t, torch.Tensor):
        return _narrow.decode(t, fmt)
    return t


def computable(t):
    """A held block as torch computes on it: uint16/32/64 and the float8
    types in ``compute_dtype`` (uint64 as its int64 bits); anything else as
    it is."""
    if isinstance(t, torch.Tensor) and (t.dtype in _SIGNED_TWIN or t.dtype in _FLOAT8):
        return to_compute(t, numpy_dtype(t.dtype))
    return t


def cat(parts, dim=0) -> torch.Tensor:
    """``torch.cat`` of held blocks, uint16/32/64 through their signed twin.
    Host blocks (``_host.is_host_block``) concatenate on the host as numpy
    does (``_host.concatenate``)."""
    if not all(isinstance(p, torch.Tensor) for p in parts):
        from dask_array_tpu_torch._host import concatenate

        return concatenate(parts, dim)
    twin = _SIGNED_TWIN.get(parts[0].dtype)
    if twin is None or any(p.dtype != parts[0].dtype for p in parts):
        return torch.cat(parts, dim=dim)
    return torch.cat([p.view(twin) for p in parts], dim=dim).view(parts[0].dtype)


def signed_bits(t: torch.Tensor) -> torch.Tensor:
    """A uint16/32/64 tensor viewed as its signed twin (the same bits, so
    nonzero where the value is); any other tensor as it is."""
    twin = _SIGNED_TWIN.get(t.dtype)
    return t if twin is None else t.view(twin)


def moved(fn, t: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """``fn(t, ...)`` for a function that only moves elements (flip,
    index_select, gather), through the signed twin of a uint16/32/64
    tensor: torch has no such kernels for those dtypes."""
    twin = _SIGNED_TWIN.get(t.dtype)
    if twin is None:
        return fn(t, *args, **kwargs)
    return fn(t.view(twin), *args, **kwargs).view(t.dtype)


def uint64_bits(v):
    """A Python int in [0, 2**64) as the int64 bits of that uint64."""
    return v - (1 << 64) if v >= 1 << 63 else v


# numpy's sort order of a held block: NaN last (all NaNs equal), -0.0 equal
# to +0.0, uint64 unsigned, complex lexicographic with numpy's NaN classes

_FLOAT_BITS = {torch.float16: torch.int16, torch.bfloat16: torch.int16, torch.float32: torch.int32, torch.float64: torch.int64}


def order_key(t: torch.Tensor) -> torch.Tensor:
    """An integer (or integer-valued) tensor whose torch order is numpy's
    sort order of the real held block ``t``: ints as computed, a uint64's
    bits with the sign bit flipped, bool as uint8, and a float as the
    integer of its bits (negatives' magnitude bits flipped) after -0.0 is
    folded onto +0.0 and every NaN onto one NaN, which lands above +inf."""
    if t.dtype == torch.bool:
        return t.to(torch.uint8)
    if t.dtype == torch.uint64:
        return t.view(torch.int64) ^ INT64_MIN
    t = computable(t)
    if not t.is_floating_point():
        return t
    bits_dt = _FLOAT_BITS[t.dtype]
    bits = torch.where(torch.isnan(t), math.nan, t + 0.0).view(bits_dt)
    width = torch.iinfo(bits_dt).bits
    return bits ^ ((bits >> (width - 1)) & torch.iinfo(bits_dt).max)


def complex_keys(z: torch.Tensor):
    """Real keys, most significant first, whose lexicographic order is
    numpy's complex sort order: R + Rj, then R + nanj, nan + Rj and
    nan + nanj, each class ordered by its non-NaN parts."""
    re_nan, im_nan = torch.isnan(z.real), torch.isnan(z.imag)
    cls = torch.where(re_nan, torch.where(im_nan, 3, 2), torch.where(im_nan, 1, 0)).to(torch.int8)
    first = torch.where(re_nan, torch.where(im_nan, 0.0, z.imag), z.real)
    second = torch.where(re_nan | im_nan, 0.0, z.imag)
    return [cls, first, second]


def lexsort(keys, dim=-1) -> torch.Tensor:
    """The stable permutation along ``dim`` that orders ``keys`` (most
    significant first) lexicographically: one stable sort per key, from the
    least significant."""
    perm = torch.argsort(keys[-1], dim=dim, stable=True)
    for key in reversed(keys[:-1]):
        perm = torch.gather(perm, dim, torch.argsort(torch.gather(key, dim, perm), dim=dim, stable=True))
    return perm


def argsort_numpy(t: torch.Tensor, dim=-1) -> torch.Tensor:
    """Stable argsort of a held block along ``dim`` in numpy's order."""
    if t.is_complex():
        return lexsort(complex_keys(t), dim)
    return torch.argsort(order_key(t), dim=dim, stable=True)


def sort_numpy(t: torch.Tensor, dim=-1) -> torch.Tensor:
    """A held block sorted along ``dim`` in numpy's order, in its held
    dtype (floats by ``torch.sort``, which puts NaN last as numpy does)."""
    if t.is_complex():
        return torch.gather(t, dim, argsort_numpy(t, dim))
    if t.is_floating_point():
        return torch.sort(t, dim=dim).values
    if t.dtype == torch.bool:
        return torch.sort(t.to(torch.uint8), dim=dim).values.to(torch.bool)
    if t.dtype == torch.uint64:
        return (torch.sort(t.view(torch.int64) ^ INT64_MIN, dim=dim).values ^ INT64_MIN).view(torch.uint64)
    return as_stored(torch.sort(computable(t), dim=dim).values, numpy_dtype(t.dtype))


def search_numpy(a, v, right):
    """numpy's searchsorted of held blocks: both in their common dtype,
    ordered as numpy orders it (``order_key``: NaN last, uint64 unsigned);
    complex data by one lexicographic sort of both, ties broken by side."""
    dt = np.result_type(numpy_dtype(a.dtype), numpy_dtype(v.dtype))
    a, v = cast(a, dt), cast(v, dt)
    if dt.kind != "c":
        return torch.searchsorted(order_key(a).contiguous(), order_key(v), right=right)
    flat = v.reshape(-1)
    both = torch.cat([a, flat])
    is_a = torch.arange(both.numel(), device=a.device) < a.numel()
    tie = (~is_a if right else is_a).to(torch.int8)
    perm = lexsort(complex_keys(both) + [tie])
    a_before = torch.cumsum(is_a[perm], 0)
    out = torch.empty(both.numel(), dtype=torch.int64, device=a.device)
    out[perm] = a_before
    return out[a.numel():].reshape(v.shape)


def dtype_key(dt) -> str:
    """Canonical unique string for a dtype (token keys).  ``dt.str`` is not
    unique: ml_dtypes types share '<V1'/'<V2', and records of one itemsize
    share '|V8'; records key by their field spec, ml_dtypes types by name
    (both parse back with ``np.dtype``)."""
    dt = np.dtype(dt)
    if dt.names is not None:
        return str(dt)
    if is_ml_dtype(dt):
        return dt.name
    return dt.str


def is_float_dtype(dt) -> bool:
    """``np.issubdtype(dt, np.floating)``, ml_dtypes' floats included (they
    stand outside numpy's type hierarchy)."""
    dt = np.dtype(dt)
    if dt.kind == "f":
        return True
    return is_ml_dtype(dt) and "float" in dt.name


def is_integer(x) -> bool:
    return isinstance(x, Integral) or (isinstance(x, float) and x.is_integer())


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def blockdims_from_blockshape(shape, chunkshape):
    """Convert a block shape like (100, 100) into explicit per-axis blockdims."""
    if chunkshape is None:
        raise TypeError("Must supply chunks= keyword argument")
    if shape is None:
        raise TypeError("Must supply shape= keyword argument")
    if np.isnan(sum(shape)) or np.isnan(sum(chunkshape)):
        raise ValueError(f"Array chunk size or shape is unknown. shape: {shape}, chunks: {chunkshape}")
    if not all(map(is_integer, chunkshape)):
        raise ValueError(f"chunks can only contain integers. chunks: {chunkshape}")
    if not all(map(is_integer, shape)):
        raise ValueError(f"shape can only contain integers. shape: {shape}")
    shape = tuple(map(int, shape))
    chunkshape = tuple(map(int, chunkshape))
    return tuple(
        ((bd,) * (d // bd) + ((d % bd,) if d % bd else ()) if d else (0,))
        for d, bd in zip(shape, chunkshape)
    )


def normalize_chunks(chunks, shape=None, limit=None, dtype=None, previous_chunks=None):
    """Normalize a chunks argument to an explicit tuple-of-tuples form.

    Accepts ints, tuples of ints, tuples of tuples of ints, dicts mapping
    axis to chunk size, -1 / None ("one chunk along this axis"), and the
    string "auto" (size blocks toward ``limit`` bytes).
    """
    if dtype and not isinstance(dtype, np.dtype):
        dtype = np.dtype(dtype)
    if chunks is None:
        raise ValueError(CHUNKS_NONE_ERROR_MESSAGE)
    if isinstance(chunks, list):
        chunks = tuple(chunks)
    if isinstance(chunks, (Number, str)):
        chunks = (chunks,) * len(shape)
    if isinstance(chunks, dict):
        chunks = tuple(chunks.get(i, None) for i in range(len(shape)))
    if isinstance(chunks, np.ndarray):
        chunks = chunks.tolist()
    if not chunks and shape and all(s == 0 for s in shape):
        chunks = ((0,),) * len(shape)

    if shape and len(shape) == 1 and len(chunks) > 1 and all(isinstance(c, (Number, str)) for c in chunks):
        if any(isinstance(c, str) for c in chunks):
            raise ValueError(
                f"String values are not supported inside explicit chunk tuples. Got chunks={chunks}"
            )
        chunks = (chunks,)

    if shape and len(chunks) != len(shape):
        raise ValueError(
            "Chunks and shape must be of the same length/dimension. "
            f"Got chunks={chunks}, shape={shape}"
        )
    if -1 in chunks or None in chunks:
        chunks = tuple(s if c in (-1, None) else c for c, s in zip(chunks, shape))

    # byte-size strings ("128 MiB") set the auto limit for their axes
    for c in chunks:
        if isinstance(c, str) and c != "auto":
            chunk_string = c.replace(" ", "")
            if not chunk_string or not chunk_string[-1].isalpha():
                raise ValueError(
                    "String chunk sizes must be 'auto' or byte sizes with a "
                    f"byte unit like 'B', 'MB', or 'MiB'. Got {c!r}"
                )
            parsed = parse_bytes(c)
            if parsed < 0:
                raise ValueError(f"String chunk byte sizes must not be negative. Got {c!r}")
            if limit is None:
                limit = parsed
            elif parsed != limit:
                raise ValueError(
                    f"Only one consistent value of limit or chunk is allowed. Used {parsed} != {limit}"
                )
    chunks = tuple("auto" if isinstance(c, str) and c != "auto" else c for c in chunks)

    if any(c == "auto" for c in chunks):
        chunks = auto_chunks(chunks, shape, limit, dtype, previous_chunks)

    if shape is not None:
        chunks = tuple(c if c not in (None, -1) else s for c, s in zip(chunks, shape))

    out = []
    for i, c in enumerate(chunks):
        if isinstance(c, (tuple, list)):
            for x in c:
                if not (isinstance(x, float) and math.isnan(x)) and int(x) != x:
                    raise ValueError(f"chunks can only contain integers, got {x!r}")
            out.append(tuple(int(x) if not math.isnan(x) else np.nan for x in c))
        elif isinstance(c, Number):
            if shape is None:
                raise ValueError("Must provide shape if chunks are given as block shape ints")
            s = shape[i]
            if isinstance(s, float) and math.isnan(s):
                out.append((np.nan,))
            else:
                if int(c) != c:
                    raise ValueError(f"chunks can only contain integers, got {c!r}")
                c = int(c)
                if c <= 0 and not (c == 0 and s == 0):
                    raise ValueError(f"Chunk sizes must be positive, got {c}")
                out.append(blockdims_from_blockshape((s,), (max(c, 1),))[0])
        else:
            raise ValueError(f"Unrecognized chunk value {c!r}")
    out = tuple(out)

    if shape is not None:
        for c, s in zip(out, shape):
            csum = sum(c)
            if not (isinstance(s, float) and math.isnan(s)) and not math.isnan(csum) and csum != s:
                raise ValueError(
                    f"Chunks do not add up to shape. Got chunks={out}, shape={shape}"
                )
    return out


def auto_chunks(chunks, shape, limit, dtype, previous_chunks=None):
    """Resolve "auto" entries in a chunks specification.

    Sizes "auto" axes so that the resulting block byte-size approaches
    ``limit`` (default: config ``array.chunk-size``), respecting the fixed
    axes and preferring multiples of ``previous_chunks`` when given.
    """
    from dask_array_tpu_torch import config

    if limit is None:
        limit = config.get("array.chunk-size", "128 MiB")
    limit = parse_bytes(limit)
    if dtype is None:
        raise TypeError("dtype must be known for auto-chunking")
    if dtype.hasobject:
        raise NotImplementedError("object dtypes have no fixed itemsize; please provide explicit chunks")
    itemsize = dtype.itemsize

    autos = {i for i, c in enumerate(chunks) if isinstance(c, str) and c == "auto"}
    if not autos:
        return chunks

    fixed_size = 1
    for i, c in enumerate(chunks):
        if i in autos:
            continue
        if isinstance(c, (tuple, list)):
            fixed_size *= max(c) if c else 1
        elif c in (-1, None):
            fixed_size *= shape[i] if shape[i] else 1
        else:
            fixed_size *= c if c else 1

    avail = max(1, limit // (itemsize * max(1, fixed_size)))
    # target edge length per auto axis (even split of the byte budget)
    target = max(1, int(avail ** (1 / len(autos))))

    out = list(chunks)
    for i in sorted(autos):
        s = shape[i]
        if isinstance(s, float) and math.isnan(s):
            raise ValueError(
                "Can not perform automatic rechunking with unknown (nan) chunk sizes."
            )
        if previous_chunks:
            prev = max(previous_chunks[i]) if previous_chunks[i] else 1
            if prev:
                if target >= prev:
                    size = max(prev, (target // prev) * prev)
                else:
                    div = max(1, round(prev / max(1, target)))
                    size = max(1, math.ceil(prev / div))
            else:
                size = target
        else:
            size = target
        out[i] = min(size, s) if s else 0
    return tuple(out)


def _boundaries(chunks):
    out = [0]
    for c in chunks:
        out.append(out[-1] + c)
    return out


def _from_boundaries(bounds):
    return tuple(b - a for a, b in zip(bounds[:-1], bounds[1:]))


def common_blockdim(blockdims):
    """Find the unified blockdim for one axis across several operands.

    Operands that agree trivially unify; a length-1 (unsplit) axis defers to
    the others; otherwise the result is the refinement: the common partition
    whose boundaries are the union of all operand boundaries.
    """
    if not any(blockdims):
        return ()
    non_trivial = {b for b in blockdims if len(b) > 1}
    if len(non_trivial) == 0:
        return max(blockdims, key=len)
    if len(non_trivial) == 1:
        (res,) = non_trivial
        return res
    if any(math.isnan(sum(b)) for b in non_trivial):
        vals = {tuple(b) for b in non_trivial}
        if len(vals) > 1:
            raise ValueError(
                "Arrays' chunk sizes are unknown and differ; call compute_chunk_sizes() first"
            )
        return vals.pop()
    totals = {sum(b) for b in non_trivial}
    if len(totals) > 1:
        raise ValueError(f"Chunks do not align along axis: lengths {sorted(totals)}")
    # refinement: sweep all boundaries (native pairwise fold for long axes)
    nt = sorted(non_trivial, key=len)
    if sum(len(b) for b in nt) > 512:
        from dask_array_tpu_torch import native

        acc = tuple(nt[0])
        for b in nt[1:]:
            acc = native.refine_axis(acc, b)
            if acc is None:
                break
        else:
            return acc
    cuts = set()
    for b in non_trivial:
        cuts.update(_boundaries(b))
    cuts.discard(0)
    return _from_boundaries([0] + sorted(cuts))


@functools.lru_cache(maxsize=4096)
def _cumsum_cached(seq, initial_zero):
    it = np.cumsum([0] + list(seq)) if initial_zero else np.cumsum(list(seq))
    if any(isinstance(x, float) and math.isnan(x) for x in seq):
        return tuple(it.tolist())
    return tuple(int(x) for x in it)


def cached_cumsum(seq, initial_zero=False):
    """Cumulative sum of a chunks tuple (with a leading 0 if requested)."""
    return _cumsum_cached(tuple(seq), bool(initial_zero))


def validate_axis(axis, ndim):
    """Normalize (possibly negative / tuple) axis against ndim."""
    if isinstance(axis, (tuple, list)):
        return tuple(validate_axis(ax, ndim) for ax in axis)
    if not isinstance(axis, Integral):
        raise TypeError(f"Axis value must be an integer, got {axis}")
    if axis < -ndim or axis >= ndim:
        raise np.exceptions.AxisError(axis, ndim)
    if axis < 0:
        axis += ndim
    return int(axis)


def has_unknown_chunks(chunks) -> bool:
    return any(
        any(isinstance(c, float) and math.isnan(c) for c in axis) for axis in chunks
    )


def grid_shape(chunks) -> tuple:
    """Number of blocks along each axis."""
    return tuple(len(c) for c in chunks)


def num_blocks(chunks) -> int:
    return int(np.prod([len(c) for c in chunks])) if chunks else 1


# ---------------------------------------------------------------------------
# cost-aware chunk unification (policy: auto | coarse | refine)
# ---------------------------------------------------------------------------

_MERGE_COST_RATIO = 4  # merge if moved <= ratio * backing


def _nbytes_or_zero(nb) -> float:
    return 0.0 if (isinstance(nb, float) and math.isnan(nb)) else float(nb)


def unify_blockdims(candidates, policy="auto", limit_bytes=None, row_bytes=1.0):
    """Choose the unified blockdim for one axis across operands, cost-aware.

    ``candidates``: list of (chunks_along_axis, operand_nbytes).
    ``row_bytes``: approximate bytes per unit length along this axis.

    - refine: the common refinement (union of boundaries).
    - coarse: the coarsest common coarsening (intersection of boundaries).
    - auto: coarse unless the bytes that would move exceed
      ``_MERGE_COST_RATIO`` x the bytes already laid out coarsely, or the
      merge would manufacture a chunk above ``limit_bytes`` (then refine,
      with a PerformanceWarning).
    """
    real = [(tuple(c), nb) for c, nb in candidates if len(c) > 1 or (c and c[0] != 0)]
    non_trivial = [(c, nb) for c, nb in real if len(c) > 1]
    if not non_trivial:
        if not real:
            return max((tuple(c) for c, _ in candidates), key=len, default=())
        return real[0][0]
    distinct = {c for c, _ in non_trivial}
    if len(distinct) == 1:
        return next(iter(distinct))
    if any(math.isnan(sum(c)) for c in distinct):
        raise ValueError(
            "Arrays' chunk sizes along an axis are unknown and differ; call "
            "compute_chunk_sizes() first"
        )
    totals = {sum(c) for c in distinct}
    if len(totals) > 1:
        raise ValueError(f"Chunks do not align along axis: lengths {sorted(totals)}")

    refined = common_blockdim(list(distinct))
    if policy == "refine":
        return refined

    # coarsest common coarsening: intersection of all boundary sets
    coarse = None
    layouts = sorted(distinct, key=len)
    if sum(map(len, layouts)) > 256:
        from dask_array_tpu_torch import native

        coarse = layouts[0]
        for other in layouts[1:]:
            coarse = native.coarse_axis(coarse, other)
            if coarse is None:
                break
    if coarse is None:
        inter = None
        for c in distinct:
            s = set(_boundaries(c))
            inter = s if inter is None else (inter & s)
        coarse = _from_boundaries(sorted(inter))

    if limit_bytes is not None and coarse and max(coarse) * row_bytes > limit_bytes:
        warnings.warn(
            "unify-chunks merge would manufacture a chunk above "
            "array.unify-chunks-limit; refining instead",
            PerformanceWarning,
            stacklevel=3,
        )
        return refined

    if policy == "coarse":
        return coarse

    # auto: operands already in the coarse layout "back" it; others move
    moved = 0.0
    backing = 0.0
    for c, nb in non_trivial:
        if tuple(c) == coarse:
            backing += _nbytes_or_zero(nb)
        else:
            moved += _nbytes_or_zero(nb)
    if backing > 0 and moved <= _MERGE_COST_RATIO * backing:
        return coarse
    if backing == 0:
        # nobody sits at the coarsest common coarsening: audition every
        # candidate layout as the target; prefer the healthiest grid
        best = None
        best_key = None
        for layout in distinct:
            backing_l = 0.0
            movers_l = 0.0
            for c, nb in non_trivial:
                if tuple(c) == tuple(layout):
                    backing_l += _nbytes_or_zero(nb)
                else:
                    movers_l += _nbytes_or_zero(nb)
            if backing_l <= 0 or movers_l > _MERGE_COST_RATIO * backing_l:
                continue
            key = (len(layout), -min(layout))
            if best_key is None or key < best_key:
                best, best_key = layout, key
        if best is not None:
            return best
    return refined
