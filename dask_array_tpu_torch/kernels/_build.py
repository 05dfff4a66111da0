"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  At its first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` beside the
package (gitignored), keyed by the source's hash, and loaded with
``ctypes``; a later process with the same source reuses the library.
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


def build_library(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` for sm_90a if the build for this source
    hash is missing; returns (library path, compiler output)."""
    source = CSRC / f"{name}.cu"
    src = source.read_bytes()
    lib_path = BUILD_DIR / f"lib{name}-{hashlib.sha256(src).hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
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
