"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  At its first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` beside the
package (gitignored), keyed by the source's hash, and loaded with
``ctypes``; a later process with the same source reuses the library.
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


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu``'s current source lives."""
    src = (CSRC / f"{name}.cu").read_bytes()
    return BUILD_DIR / f"lib{name}-{hashlib.sha256(src).hexdigest()[:16]}.so"


def build_library(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` for sm_90a if the build for this source
    hash is missing; returns (library path, compiler output)."""
    source = CSRC / f"{name}.cu"
    lib_path = library_path(name)
    if lib_path.exists():
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--split-compile=0",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o", tmp, str(source),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {source.name} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or nothing
    return lib_path, proc.stderr


def build_all(names) -> dict:
    """Build several kernels at once, one ``nvcc`` each, all started
    together; returns {name: (library path, compiler output)}."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names) or 1) as pool:
        return dict(zip(names, pool.map(build_library, names)))


@functools.lru_cache(maxsize=None)
def load_library(name: str):
    """The loaded ``csrc/<name>.cu`` library (built first if missing)."""
    import ctypes

    path, _ = build_library(name)
    return ctypes.CDLL(str(path))


class Launcher:
    """One C entry point ``<name>_launch`` of a kernel library, bound once.

    ``argtypes`` are the entry point's arguments without its last, the
    stream, which every launch appends: the current stream of the tensor's
    device (its index, ``tensor.get_device()``), through torch's raw
    lookup where the build has one (no ``Stream`` object made), and with
    no ``torch.cuda.device`` context unless that device is not the current
    one.  A non-zero return is a ``cudaError_t``; the launch then raises
    with the text of the library's ``<name>_error_string``.
    """

    def __init__(self, library: str, symbol: str, argtypes, what: str):
        import ctypes

        import torch

        lib = load_library(library)
        self._fn = getattr(lib, symbol)
        self._fn.argtypes = [*argtypes, ctypes.c_void_p]
        self._fn.restype = ctypes.c_int
        self._errstr = getattr(lib, symbol.removesuffix("_launch") + "_error_string")
        self._errstr.argtypes = [ctypes.c_int]
        self._errstr.restype = ctypes.c_char_p
        self._what = what
        self._current_device = getattr(torch._C, "_cuda_getDevice", torch.cuda.current_device)
        self._stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda index: torch.cuda.current_stream(index).cuda_stream)

    def __call__(self, index: int, *args):
        if index == self._current_device():
            err = self._fn(*args, self._stream(index))
        else:
            import torch

            with torch.cuda.device(index):
                err = self._fn(*args, self._stream(index))
        if err != 0:
            raise RuntimeError(f"{self._what} kernel launch failed: {self._errstr(err).decode()}")
