"""ctypes bindings for the native plan-algebra library (plankit).

Port of ``dask_array_tpu/native/__init__.py``.  ``plankit.cpp`` is C++ and
backend-neutral; at its first use it is compiled with ``g++`` into
``build/plankit/`` beside the package (gitignored), keyed by the source's
hash, through a temporary file and ``os.replace``: processes that build at
once (test workers) each load a whole library, never a half-written one.

A build-generation handshake fails loudly on version skew.  Every entry
point returns None where it declines (a negative step, say, or no
library) and its caller takes the Python path; a failed build warns, and
the port's tests and ``chip_smoke.py`` assert ``available()``.

Build at once: ``python -m dask_array_tpu_torch.native``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import warnings
from pathlib import Path

import numpy as np

# must match plankit_generation() in plankit.cpp
PLANKIT_GENERATION = 5

SOURCE = Path(__file__).resolve().parent / "plankit.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "plankit"

_lib = None
_load_attempted = False


class StaleNativeBuild(RuntimeError):
    """The compiled plankit library does not match this wrapper's generation."""


def library_path() -> Path:
    """Where the library for this source lives: one file per source hash."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libplankit-g{PLANKIT_GENERATION}-{digest}.so"


def build(force: bool = False) -> Path | None:
    """Compile plankit.cpp unless this source's library exists; returns its
    path, or None (with a warning) when ``g++`` fails."""
    path = library_path()
    if path.exists() and not force:
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(SOURCE), "-o", tmp],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except Exception as e:
        os.unlink(tmp)
        warnings.warn(f"plankit native build failed ({e}); planning takes the Python paths")
        return None
    os.replace(tmp, path)  # atomic: a concurrent build sees all or nothing
    return path


def _load():
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    path = build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        warnings.warn(f"plankit load failed ({e}); planning takes the Python paths")
        return None
    check_generation(lib)
    i64 = ctypes.c_int64
    p64 = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    lib.sliced_blockdim_pos.restype = i64
    lib.sliced_blockdim_pos.argtypes = [p64, i64, i64, i64, i64, p64]
    lib.old_to_new_axis.restype = i64
    lib.old_to_new_axis.argtypes = [p64, i64, p64, i64, p64, p64, p64, p64, i64]
    lib.refine_axis.restype = i64
    lib.refine_axis.argtypes = [p64, i64, p64, i64, p64, i64]
    lib.hash_bytes.restype = ctypes.c_uint64
    lib.hash_bytes.argtypes = [ctypes.c_char_p, i64]
    lib.expand_grid.restype = i64
    lib.expand_grid.argtypes = [p64, i64, p64, i64]
    lib.moved_fraction_axis.restype = ctypes.c_double
    lib.moved_fraction_axis.argtypes = [p64, i64, p64, i64]
    lib.coarse_axis.restype = i64
    lib.coarse_axis.argtypes = [p64, i64, p64, i64, p64, i64]
    lib.stage_degree_axis.restype = i64
    lib.stage_degree_axis.argtypes = [p64, i64, p64, i64]
    pu8 = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
    lib.plan_encode.restype = i64
    lib.plan_encode.argtypes = [p64, i64, pu8, p64, i64, pu8, i64]
    lib.plan_validate.restype = i64
    lib.plan_validate.argtypes = [pu8, i64, p64]
    lib.fingerprint128.restype = None
    lib.fingerprint128.argtypes = [pu8, i64, np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")]
    _lib = lib
    return _lib


def check_generation(lib, expected: int = PLANKIT_GENERATION) -> None:
    """Raise ``StaleNativeBuild`` unless ``lib`` reports ``expected``."""
    lib.plankit_generation.restype = ctypes.c_int64
    gen = lib.plankit_generation()
    if gen != expected:
        raise StaleNativeBuild(
            f"libplankit generation {gen} != wrapper generation {expected}; "
            "rebuild with `python -m dask_array_tpu_torch.native --force`"
        )


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# python-facing wrappers (None on decline -> caller uses the Python path)
# ---------------------------------------------------------------------------


def sliced_blockdim_counts(chunks, start, stop, step):
    """Per-block selected counts for a positive-step normalized slice."""
    lib = _load()
    if lib is None or step <= 0:
        return None
    arr = np.asarray(chunks, dtype=np.int64)
    counts = np.empty(len(arr), dtype=np.int64)
    lib.sliced_blockdim_pos(arr, len(arr), int(start), int(stop), int(step), counts)
    return counts


def old_to_new_axis(old_chunks, new_chunks):
    """(offsets, piece_old, piece_lo, piece_hi) or None to decline."""
    lib = _load()
    if lib is None:
        return None
    oldc = np.asarray(old_chunks, dtype=np.int64)
    newc = np.asarray(new_chunks, dtype=np.int64)
    max_pieces = len(oldc) + 2 * len(newc) + 8
    piece_old = np.empty(max_pieces, dtype=np.int64)
    piece_lo = np.empty(max_pieces, dtype=np.int64)
    piece_hi = np.empty(max_pieces, dtype=np.int64)
    offsets = np.empty(len(newc) + 1, dtype=np.int64)
    n = lib.old_to_new_axis(oldc, len(oldc), newc, len(newc), piece_old, piece_lo, piece_hi, offsets, max_pieces)
    if n < 0:
        return None
    return offsets, piece_old[:n], piece_lo[:n], piece_hi[:n]


def refine_axis(a, b):
    """Common refinement of two blockdims, or None to decline."""
    lib = _load()
    if lib is None:
        return None
    aa = np.asarray(a, dtype=np.int64)
    bb = np.asarray(b, dtype=np.int64)
    max_out = len(aa) + len(bb) + 2
    out = np.empty(max_out, dtype=np.int64)
    n = lib.refine_axis(aa, len(aa), bb, len(bb), out, max_out)
    if n < 0:
        return None
    return tuple(int(x) for x in out[:n])


def hash_bytes(data: bytes):
    """Fast non-cryptographic FNV-1a fingerprint (diagnostics, dedup
    probes); expression tokens use blake2b (``utils/_tokenize.py``)."""
    lib = _load()
    if lib is None:
        return None
    return lib.hash_bytes(data, len(data))


def expand_grid(nblocks):
    """Every block index of a grid, row-major, as an (n, ndim) array."""
    lib = _load()
    if lib is None:
        return None
    nb = np.asarray(nblocks, dtype=np.int64)
    total = int(np.prod(nb)) if len(nb) else 1
    coords = np.empty((total, max(1, len(nb))), dtype=np.int64)
    n = lib.expand_grid(nb, len(nb), coords, total)
    if n < 0:
        return None
    return coords[:, : len(nb)]


def moved_fraction_axis(src, dst):
    """Min-model moved fraction along one axis, or None to decline."""
    lib = _load()
    if lib is None:
        return None
    s = np.asarray(src, dtype=np.int64)
    d = np.asarray(dst, dtype=np.int64)
    out = lib.moved_fraction_axis(s, len(s), d, len(d))
    if out < 0:
        return None
    return float(out)


def coarse_axis(a, b):
    """Coarsest common coarsening of two blockdims, or None to decline."""
    lib = _load()
    if lib is None:
        return None
    aa = np.asarray(a, dtype=np.int64)
    bb = np.asarray(b, dtype=np.int64)
    max_out = min(len(aa), len(bb)) + 1
    out = np.empty(max_out, dtype=np.int64)
    n = lib.coarse_axis(aa, len(aa), bb, len(bb), out, max_out)
    if n < 0:
        return None
    return tuple(int(x) for x in out[:n])


def stage_degree_axis(old_chunks, new_chunks):
    """Max old-blocks-per-new-block fan-in along one axis, or None."""
    lib = _load()
    if lib is None:
        return None
    o = np.asarray(old_chunks, dtype=np.int64)
    n = np.asarray(new_chunks, dtype=np.int64)
    return int(lib.stage_degree_axis(o, len(o), n, len(n)))


def plan_encode(codes, strblob: bytes, stroffs):
    """Encode a plan tape into the versioned binary grammar, or None when
    the library is missing.  A malformed tape raises."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int64)
    offs = np.ascontiguousarray(stroffs, dtype=np.int64)
    blob = np.frombuffer(strblob, dtype=np.uint8) if strblob else np.empty(0, np.uint8)
    blob = np.ascontiguousarray(blob)
    # worst case: every tape int becomes 8 output bytes, plus string table
    cap = 16 + 8 * len(codes) + len(blob) + 8 * len(offs)
    out = np.empty(cap, dtype=np.uint8)
    n = lib.plan_encode(codes, len(codes), blob, offs, len(offs) - 1, out, cap)
    if n == -1:  # pragma: no cover - cap is a proven upper bound
        raise RuntimeError("plan_encode capacity underestimate (bug)")
    if n == -2:
        raise ValueError("malformed plan tape")
    return out[:n].tobytes()


def plan_validate(blob: bytes):
    """Re-parse an encoded plan: an info dict, or None when the library is
    missing.  A malformed blob or an unknown grammar version raises."""
    lib = _load()
    if lib is None:
        return None
    arr = np.frombuffer(blob, dtype=np.uint8) if blob else np.empty(0, np.uint8)
    arr = np.ascontiguousarray(arr)
    info = np.zeros(4, dtype=np.int64)
    n = lib.plan_validate(arr, len(arr), info)
    if n == -2:
        raise ValueError(f"unknown plan grammar version {blob[0] if blob else '?'} (library/wrapper skew)")
    if n < 0:
        raise ValueError("malformed plan blob")
    return {"version": int(info[0]), "n_strings": int(info[1]), "n_nodes": int(info[2]), "n_ops": int(info[3])}


def fingerprint128(data: bytes):
    """128-bit FNV-1a fingerprint as a 32-hex string, or None to decline."""
    lib = _load()
    if lib is None:
        return None
    arr = np.frombuffer(data, dtype=np.uint8) if data else np.empty(0, np.uint8)
    arr = np.ascontiguousarray(arr)
    out = np.zeros(2, dtype=np.uint64)
    lib.fingerprint128(arr, len(arr), out)
    return f"{int(out[0]):016x}{int(out[1]):016x}"
