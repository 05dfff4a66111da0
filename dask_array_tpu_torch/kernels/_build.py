"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  At its first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` beside the
package (gitignored), keyed by the hash of the source and of the headers
in ``csrc/``, and loaded with ``ctypes``; a later process with the same
source reuses the library.  A generated source (the band-stencil programs
of ``kernels/stencil.py``) is written into ``build/kernels/`` under its
hash and built the same way, with ``csrc/`` on the include path.
``Launcher`` binds one entry point and launches it on the current stream;
every kernel wrapper of the port calls through it.
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from dask_array_tpu_torch._spans import COUNTS, call, span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels build at their first CUDA call")


def _digest(source: bytes) -> str:
    """The build key of a source: its bytes and every header in ``csrc/``."""
    h = hashlib.sha256(source)
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str, source: str | None = None) -> Path:
    """Where the build of ``csrc/<name>.cu``'s current source (or of the
    generated ``source``) lives."""
    src = (CSRC / f"{name}.cu").read_bytes() if source is None else source.encode()
    return BUILD_DIR / f"lib{name}-{_digest(src)}.so"


def _write_atomic(path: Path, data: bytes) -> None:
    fd, tmp = tempfile.mkstemp(suffix=path.suffix, dir=path.parent)
    with os.fdopen(fd, "wb") as f:
        f.write(data)
    os.replace(tmp, path)  # atomic: a concurrent reader sees all or nothing


def build_library(name: str, source: str | None = None) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` (or the generated ``source``, written to
    ``build/kernels/<name>-<hash>.cu``) for sm_90a if the build for this
    source hash is missing; returns (library path, compiler output)."""
    lib_path = library_path(name, source)
    if lib_path.exists():
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if source is None:
        src_path = CSRC / f"{name}.cu"
    else:
        src_path = lib_path.with_name(lib_path.name.removeprefix("lib").removesuffix(".so") + ".cu")
        _write_atomic(src_path, source.encode())
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--split-compile=0",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-I", str(CSRC), "-o", tmp, str(src_path),
    ]
    COUNTS["library_builds"] += 1
    with span("kernel_build:" + name):
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src_path.name} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or nothing
    return lib_path, proc.stderr


def build_all(items) -> dict:
    """Build several kernels at once, one ``nvcc`` each, all started
    together.  An item is a ``csrc`` name or a ``(name, generated source)``
    pair (equal items build once); returns {item: (library path, compiler
    output, the build's seconds beside the others)}."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    def one(item):
        t0 = time.perf_counter()
        path, out = build_library(*((item,) if isinstance(item, str) else item))
        return path, out, time.perf_counter() - t0

    items = list(dict.fromkeys(items))
    with ThreadPoolExecutor(max_workers=len(items) or 1) as pool:
        return dict(zip(items, pool.map(one, items)))


def load(path: Path):
    """The kernel library at ``path``, loaded with ``ctypes``."""
    import ctypes

    COUNTS["library_loads"] += 1
    return call("library_load:" + path.name, ctypes.CDLL, str(path))


@functools.lru_cache(maxsize=None)
def load_library(name: str):
    """The loaded ``csrc/<name>.cu`` library (built first if missing)."""
    path, _ = build_library(name)
    return load(path)


class Launcher:
    """One C entry point ``<name>_launch`` of a kernel library (a ``csrc``
    name, or a library already loaded), bound once.

    ``argtypes`` are the entry point's arguments without its last, the
    stream, which every launch appends: the current stream of the tensor's
    device (its index, ``tensor.get_device()``), through torch's raw
    lookup where the build has one (no ``Stream`` object made), and with
    no ``torch.cuda.device`` context unless that device is not the current
    one.  A non-zero return is a ``cudaError_t``; the launch then raises
    with the text of the library's ``<name>_error_string``.
    """

    def __init__(self, library, symbol: str, argtypes, what: str):
        import ctypes

        import torch

        lib = load_library(library) if isinstance(library, str) else library
        self._fn = getattr(lib, symbol)
        self._fn.argtypes = [*argtypes, ctypes.c_void_p]
        self._fn.restype = ctypes.c_int
        self._errstr = getattr(lib, symbol.removesuffix("_launch") + "_error_string")
        self._errstr.argtypes = [ctypes.c_int]
        self._errstr.restype = ctypes.c_char_p
        self._what = what
        self._span = "launch:" + what
        self._current_device = getattr(torch._C, "_cuda_getDevice", torch.cuda.current_device)
        self._stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda index: torch.cuda.current_stream(index).cuda_stream)

    def __call__(self, index: int, *args):
        err = call(self._span, self._launch, index, args)
        if err != 0:
            raise RuntimeError(f"{self._what} kernel launch failed: {self._errstr(err).decode()}")

    def _launch(self, index: int, args) -> int:
        if index == self._current_device():
            return self._fn(*args, self._stream(index))
        import torch

        with torch.cuda.device(index):
            return self._fn(*args, self._stream(index))
