"""Multi-statistic reduction kernel: column sums, row means and the std of
one 2-D float32 array in a single read, with its plain PyTorch version.

Counterpart of ``bench/probe_reduction.py::pallas_mstat`` (the Pallas
probe of the ``reduction_tree`` workload: ``x.sum(0)``, ``x.mean(1)`` and
``x.std()``).  It returns exactly the probe's three values:

- ``colsum``  = ``x.sum(0)``, shape (N,);
- ``rowmean`` = ``x.sum(1) / N``, shape (M,);
- ``std``     = ``sqrt(ss / n - (s / n) ** 2)`` with ``s = x.sum()``,
  ``ss = (x * x).sum()`` and ``n = M * N``, all float32, 0-d.

``multi_stat`` runs ``multi_stat_plain`` for a CPU tensor and launches the
CUDA kernel (``csrc/mstat.cu``) for a CUDA tensor, with no fallback
between them.  The probe's ``N % rows == 0`` tiling condition is dropped:
the kernel masks ragged edges.

The ``*_packed`` forms return one buffer ``[colsum | rowmean | std | s |
ss]`` and take an optional 0-d ``shift``: s and ss are then sums of
``x - shift``, the power sums of the port's one-pass shifted variance.
``ops/_multistat.py`` routes the ``reduction_tree`` statistics here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dask_array_tpu_torch.kernels._build import Launcher, load_library

# kernel launches since the last reset; only multi_stat_cuda adds to it
LAUNCHES = 0


def _unpack(packed, M, N):
    return packed[:N], packed[N : N + M], packed[N + M]


def multi_stat_packed_plain(x: torch.Tensor, shift=None) -> torch.Tensor:
    """``[colsum | rowmean | std | s | ss]`` in plain torch ops, the probe's
    formula; with a 0-d ``shift`` tensor, s and ss are sums of ``x - shift``."""
    M, N = x.shape
    n = torch.tensor(M, dtype=x.dtype, device=x.device) * N  # float32(M) * float32(N)
    d = x if shift is None else x - shift
    s, ss = d.sum(), (d * d).sum()
    std = torch.sqrt(ss / n - (s / n) ** 2)
    return torch.cat([x.sum(0), x.sum(1) / N, torch.stack([std, s, ss])])


def multi_stat_packed(x: torch.Tensor, shift=None) -> torch.Tensor:
    """The packed statistics: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return multi_stat_packed_plain(x, shift)
    return multi_stat_packed_cuda(x, shift)


def multi_stat_plain(x: torch.Tensor):
    """(colsum, rowmean, std) in plain torch ops."""
    return _unpack(multi_stat_packed_plain(x), *x.shape)


def multi_stat_cuda(x: torch.Tensor):
    """(colsum, rowmean, std) from the CUDA kernel."""
    return _unpack(multi_stat_packed_cuda(x), *x.shape)


def multi_stat(x: torch.Tensor):
    """The three statistics of one 2-D float32 tensor: the plain version
    for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    return _unpack(multi_stat_packed(x), *x.shape)


def multi_stat_packed_cuda(x: torch.Tensor, shift=None) -> torch.Tensor:
    """Launch the multi-statistic kernel on a 2-D float32 CUDA tensor.

    Raises on anything the kernel does not take: a non-CUDA, non-contiguous,
    non-2-D, non-float32 or empty tensor, or a shift that is not a 0-d
    float32 tensor on the same device.
    """
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"multi_stat_cuda needs a CUDA tensor, got one on {x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("multi_stat_cuda needs a contiguous 2-D tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"multi_stat_cuda takes float32, not {x.dtype}")
    M, N = x.shape
    if M == 0 or N == 0:
        raise ValueError("multi_stat_cuda needs a non-empty tensor")
    if shift is not None and (
        shift.dim() != 0 or shift.dtype != torch.float32 or shift.device != x.device
    ):
        raise ValueError("multi_stat_cuda takes a 0-d float32 shift on the tensor's device")
    launch = _launcher()
    tiles = _tiles_for(M)
    out = torch.empty(N + M + 3, dtype=x.dtype, device=x.device)
    partial = torch.empty((tiles, N), dtype=x.dtype, device=x.device)
    pairs = torch.empty((tiles, 2), dtype=x.dtype, device=x.device)
    launch(x.get_device(), x.data_ptr(), None if shift is None else shift.data_ptr(), out.data_ptr(),
           partial.data_ptr(), pairs.data_ptr(), M, N)
    LAUNCHES += 1
    return out


@functools.lru_cache(maxsize=None)
def _launcher():
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    return Launcher("mstat", "mstat_launch", [p, p, p, p, p, ll, ll], "mstat")


@functools.lru_cache(maxsize=64)
def _tiles_for(M: int) -> int:
    fn = load_library("mstat").mstat_tiles_for
    fn.argtypes = [ctypes.c_longlong]
    fn.restype = ctypes.c_longlong
    return fn(M)
