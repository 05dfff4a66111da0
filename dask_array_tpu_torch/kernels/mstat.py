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
the kernel masks ragged edges.  Its grid is planned here, by
``launch_plan``, a pure function of the shape and the card's SM count: one
wave of resident blocks, each with an equal run of (column strip, row)
units, whatever the shape (10000^2, 1e6 x 128 and 128 x 1e6 alike).

The ``*_packed`` forms return one buffer ``[colsum | rowmean | std | s |
ss]`` and take an optional 0-d ``shift``: s and ss are then sums of
``x - shift``, the power sums of the port's one-pass shifted variance.
``ops/_multistat.py`` routes the ``reduction_tree`` statistics here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from dask_array_tpu_torch.kernels._build import Launcher

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
    index = x.get_device()
    plan = launch_plan(M, N, _sm_count(index))
    out = torch.empty(N + M + 3, dtype=x.dtype, device=x.device)
    scratch = torch.empty(plan.scratch, dtype=x.dtype, device=x.device)
    col, row = scratch.data_ptr(), scratch.data_ptr() + 4 * plan.colpart
    pairs = row + 4 * plan.rowpart
    _launcher()(index, x.data_ptr(), None if shift is None else shift.data_ptr(), out.data_ptr(), col, row,
                pairs, M, N, plan.lanes.bit_length() - 1, plan.across.bit_length() - 1, plan.strips, plan.blocks,
                int(vector_ok(x)))
    LAUNCHES += 1
    return out


# -- the launch plan (csrc/mstat.cu mirrors it) -----------------------------------

THREADS = 256  # threads a block
BLOCKS_PER_SM = 2  # blocks resident on an SM: __launch_bounds__(256, 2)


class Plan(NamedTuple):
    """How the kernel covers an (M, N) array.  ``lanes`` threads share a
    row, 4 columns each; ``across`` warps lie side by side across a strip of
    ``width = 4 * lanes * across`` columns, and the block's other warps go
    down the rows.  The ``units = strips * M`` (strip, row) pairs are laid
    out strip by strip, and a persistent grid of ``blocks`` blocks takes
    equal runs of them, block b units ``[b * units // blocks, (b + 1) *
    units // blocks)``.  ``colpart``, ``rowpart`` and ``pairs`` are the
    scratch floats of the column, row and (s, ss) partials."""

    lanes: int
    across: int
    width: int
    strips: int
    blocks: int
    units: int
    colpart: int
    rowpart: int
    pairs: int

    @property
    def scratch(self) -> int:
        return self.colpart + self.rowpart + self.pairs


def launch_plan(M: int, N: int, sms: int = 132) -> Plan:
    """The kernel's launch plan for an (M, N) array on a card of ``sms``
    SMs: one wave of ``sms * BLOCKS_PER_SM`` blocks, each with the same
    number of (strip, row) units to within one.  A row is read in pieces of
    up to 4 KB (8 warps of 32 lanes side by side); a narrow array gives a
    warp several rows at once."""
    lanes = 1
    while lanes < 32 and 4 * lanes < N:
        lanes *= 2
    across = 1
    while across < THREADS // 32 and 4 * lanes * across < N:
        across *= 2
    width = 4 * lanes * across
    strips = -(-N // width)
    blocks = sms * BLOCKS_PER_SM
    row_strips = strips * across
    return Plan(lanes, across, width, strips, blocks, strips * M, (blocks + strips) * width,
                row_strips * M if row_strips > 1 else 0, 2 * blocks)


def segments(plan: Plan, M: int):
    """``(block, strip, row0, row1)`` for every segment the kernel walks:
    each block's run of units, cut where a strip ends."""
    out = []
    for b in range(plan.blocks):
        u, u1 = b * plan.units // plan.blocks, (b + 1) * plan.units // plan.blocks
        while u < u1:
            s = u // M
            end = min(u1, (s + 1) * M)
            out.append((b, s, u - s * M, end - s * M))
            u = end
    return out


def vector_ok(x: torch.Tensor) -> bool:
    """The 16-byte path: rows a multiple of 16 bytes, and x 16-byte aligned."""
    return x.shape[-1] % 4 == 0 and x.data_ptr() % 16 == 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launcher():
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return Launcher("mstat", "mstat_launch", [p, p, p, p, p, p, ll, ll, i, i, ll, ll, i], "mstat")
