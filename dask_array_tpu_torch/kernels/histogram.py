"""Histogram and bincount counting kernel (K2), with its plain PyTorch
version.

Counterpart of ``dask_array_tpu/kernels/histogram.py::histogram``, the
JAX package's counting step of ``histogram`` and ``bincount``: numpy's
counts of a flat array over sorted edges (half-open bins, the last bin
closed, NaN and values outside the edges dropped), int64 counts or the
float64 (complex128) sums of weights.

- ``histogram_counts(x, edges, weights=None)``: the plain version for a
  CPU tensor, the CUDA kernel (``csrc/histogram.cu``) for a CUDA tensor,
  with no fallback between them.  The kernel guesses each bin where the
  edges lie within a bin of evenly spaced ones (``guess_margin``), and
  reads the edges only where a guess comes near a bin edge; the result is
  the binary search's all the same.
- ``bincount_counts(x, length, weights=None)``: numpy's bincount of int64
  values known to lie in ``[0, length)``; the kernel's direct mode (the
  value is the bin).

Each value is compared in numpy's comparison dtype,
``np.result_type(data, edges)`` (``comparison_dtype``): float16/float32 in
float32, float64 in float64, integers in int64 (uint64 when that is the
result type), complex lexicographically.  The grid is planned here, by
``launch_plan``, a pure function of the sizes, the types and the card's SM
count.  Counts past one copy of the bins a block (65536 bins) are kept in
16-bit shared counters, whose wraps the kernel carries into the int64
output.  Weighted sums repeat their bits from run to run while the
per-warp float64 bins fit in shared memory (``launch_plan(...).copies >
0``); past that (65536-bin weighted bincounts) the kernel adds them with
float64 atomics in global memory, whose last bits may then change from run
to run.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from dask_array_tpu_torch._chunks import cast, numpy_dtype, order_key, search_numpy, to_compute
from dask_array_tpu_torch.kernels._build import Launcher

# kernel launches since the last reset; only the *_cuda functions add to it
LAUNCHES = 0


# -- the plain version --------------------------------------------------------------


def positions(x, edges):
    """numpy's ``searchsorted(edges, x, side="right")`` in the common dtype
    of the held blocks (NaN after every edge; complex in numpy's
    lexicographic order), and where x is the last edge."""
    dt = comparison_dtype(x.dtype, edges.dtype)
    xc, ec = cast(x, dt), cast(edges, dt)
    pos = search_numpy(ec, xc, right=True)
    if dt.kind == "c":
        return pos, (xc.real == ec.real[-1]) & (xc.imag == ec.imag[-1])
    return pos, order_key(xc) == order_key(ec[-1:])


def bin_indices(x, edges):
    """Each value's bin among ``len(edges) - 1``, the last bin closed;
    values outside the edges, and NaN, get the spare bin
    ``len(edges) - 1``."""
    nbins = edges.shape[0] - 1
    pos, on_last = positions(x, edges)
    idx = torch.where(on_last, nbins - 1, pos - 1)
    return torch.where((idx < 0) | (idx >= nbins), nbins, idx)


def _weighted_bincount(idx, weights, length):
    """``bincount`` of float64 weights (complex: each part apart)."""
    if weights.is_complex():
        re = torch.bincount(idx, weights=weights.real.to(torch.float64), minlength=length)
        im = torch.bincount(idx, weights=weights.imag.to(torch.float64), minlength=length)
        return torch.complex(re, im)
    return torch.bincount(idx, weights=weights.to(torch.float64), minlength=length)


def histogram_counts_plain(x, edges, weights=None):
    """numpy's histogram counts of the held block ``x`` (any shape) over
    ``edges`` (a tensor) in torch ops: int64, or the float64 (complex128)
    sums of ``weights``."""
    nbins = edges.shape[0] - 1
    idx = bin_indices(x.reshape(-1), edges)
    if weights is None:
        return torch.bincount(idx, minlength=nbins + 1)[:nbins]
    return _weighted_bincount(idx, weights.reshape(-1), nbins + 1)[:nbins]


def bincount_plain(x, length, weights=None):
    """``bincount`` of int64 values in ``[0, length)`` in torch ops."""
    return torch.bincount(x, weights=weights, minlength=length)


# -- dispatch -------------------------------------------------------------------------


def histogram_counts(x, edges, weights=None):
    """The histogram counts: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return histogram_counts_plain(x, edges, weights)
    return histogram_counts_cuda(x, edges, weights)


def bincount_counts(x, length, weights=None):
    """numpy's bincount of int64 values in ``[0, length)``: the plain
    version for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return bincount_plain(x, length, weights)
    return bincount_cuda(x, length, weights)


# -- types ------------------------------------------------------------------------------

# the data codes and comparison codes of csrc/histogram.cu
DATA_CODES = {
    torch.bool: 0, torch.uint8: 1, torch.int8: 2, torch.int16: 3, torch.uint16: 4, torch.int32: 5,
    torch.uint32: 6, torch.int64: 7, torch.uint64: 8, torch.float16: 9, torch.float32: 10, torch.float64: 11,
    torch.complex64: 12, torch.complex128: 13,
}
COMPARE_CODES = {"float32": 0, "float64": 1, "int64": 2, "uint64": 3, "complex64": 4, "complex128": 5}
# the data codes each comparison type takes (csrc/histogram.cu's by_data
# instantiates exactly these): float32 holds bool, the 8- and 16-bit
# integers and float16/float32 exactly; a complex comparison takes complex
# data (``kernel_data`` casts real data to it)
KERNEL_PAIRS = {
    "float32": {0, 1, 2, 3, 4, 9, 10}, "complex64": {12}, "float64": set(range(12)), "complex128": {12, 13},
    "int64": set(range(8)), "uint64": {0, 1, 4, 6, 8},
}
_COMPARE_TORCH = {"float32": torch.float32, "float64": torch.float64, "int64": torch.int64, "uint64": torch.int64,
                  "complex64": torch.complex64, "complex128": torch.complex128}


@functools.lru_cache(maxsize=None)
def comparison_dtype(data_dtype, edges_dtype) -> np.dtype:
    """numpy's comparison dtype of data against edges: ``np.result_type``
    of the two (torch or numpy dtypes)."""
    def np_of(dt):
        return numpy_dtype(dt) if isinstance(dt, torch.dtype) else np.dtype(dt)

    return np.result_type(np_of(data_dtype), np_of(edges_dtype))


@functools.lru_cache(maxsize=None)
def kernel_compare(rt) -> str:
    """The type the kernel compares a comparison dtype ``rt`` in: float32
    for float16/float32 (exact for both), float64, complex64/complex128
    (lexicographic), uint64, and int64 for every other integer or bool."""
    rt = np.dtype(rt)
    if rt.kind == "f":
        return "float32" if rt.itemsize <= 4 else "float64"
    if rt.kind == "c":
        return rt.name
    return "uint64" if rt == np.uint64 else "int64"


def kernel_data(x, rt) -> torch.Tensor:
    """The values as the kernel reads them: the held block itself, or, for
    real values against complex edges (a comparison the kernel makes only
    between complex numbers), numpy's cast to the complex comparison dtype
    ``rt`` (one pass over the data, this case alone)."""
    return cast(x, rt) if rt.kind == "c" and not x.is_complex() else x


def kernel_edges(edges, rt) -> torch.Tensor:
    """The edges as the kernel reads them: cast to ``rt`` as numpy casts
    them, then held in the kernel's comparison type (uint64 as its int64
    bits), contiguous."""
    ct = kernel_compare(rt)
    e = cast(edges.reshape(-1), rt)
    if ct == "uint64":
        e = e.view(torch.int64)
    elif ct == "int64":
        e = to_compute(e, np.int64)
    else:
        e = e.to(_COMPARE_TORCH[ct])
    return e.contiguous()


def guess_margin(edges, compare="float64") -> float:
    """The kernel's guess margin for ``edges`` (a numpy array, in the
    comparison type ``compare``): how far, in bins, the edges lie from
    evenly spaced ones between the first and the last (complex: their real
    parts), plus what the rounding of the guess ``(x - e0) * nbins / (eN -
    e0)`` in ``compare``'s precision may add.  Under 1 the kernel guesses
    each bin and checks it against the edges, and takes a guess further
    than the margin from a bin edge without reading them; otherwise (edges
    that do not increase end to end, 2^22 bins or more) it does a binary
    search.
    ``csrc/histogram.cu`` computes the same in each block."""
    e = np.asarray(edges)
    k = (e.real if e.dtype.kind == "c" else e).astype(np.float64)
    nb = k.shape[0] - 1
    with np.errstate(all="ignore"):
        span = k[-1] - k[0]
        if not (1 <= nb < 2**22 and 0 < span < 1e308):
            return math.inf
        dev = np.abs(k - (k[0] + span * (np.arange(nb + 1) / nb)))
        dev = math.inf if np.isnan(dev).any() else float(dev.max())
        eps = 2.0**-24 if compare == "float32" else 2.0**-53  # the guess's precision
        return dev * nb / span + 8 * eps * nb * (1 + (abs(k[0]) + abs(k[-1])) / span)


# -- the launch plan (csrc/histogram.cu mirrors it) ----------------------------------

THREADS = 256  # threads a block: four an SM (64 registers a thread)
WIDE_THREADS = 1024  # a wide block: counts where one block fits an SM, as many warps as four
WARPS = THREADS // 32
MAX_BLOCKS_PER_SM = 4
SM_SHARED = 233472  # shared bytes of an SM (228 KB), 1 KB of it reserved a block
BLOCK_SHARED = 232448  # the most one block may take (227 KB), static shared memory included
STATIC_SHARED = 16  # the kernel's static shared memory (the edges' distance from even spacing)
EDGE_BUDGET = 32 * 1024  # edges staged in shared memory up to this many bytes
_COUNT_BYTES = {0: 4, 1: 8, 2: 16}  # a bin's bytes in one copy: counts, float64, complex128 sums
# the counting modes of csrc/histogram.cu
COPIES, HALF, GLOBAL = 0, 1, 2


def _align16(v: int) -> int:
    return (v + 15) // 16 * 16


class Plan(NamedTuple):
    """How the kernel covers ``n`` values of ``itemsize`` bytes.  ``vec``
    values make a 16-byte unit; ``blocks`` blocks of ``threads`` threads
    (``per_sm`` resident on each SM, one wave) take equal runs of the
    ``units`` units, block b units ``[b * units // blocks, (b + 1) * units
    // blocks)``; counts where one block fits an SM take a wide block of
    1024 threads (32 warps, as four blocks of 256 have).  ``mode``: where
    the counts are kept.  COPIES: ``copies`` private copies of the bins a
    block in shared memory (one a warp at most; weighted sums need one a
    warp).  HALF: 16-bit counters, two a
    32-bit word, one copy a block: bin b is half ``b % 2`` of word ``b //
    2`` (``counter``).  GLOBAL: atomics into the output.  ``edges_shared``:
    the edges staged in shared memory.  ``smem``: dynamic shared bytes;
    ``partial``: scratch bytes of the blocks' partials (HALF: their
    words)."""

    vec: int
    units: int
    threads: int
    blocks: int
    per_sm: int
    mode: int
    copies: int
    edges_shared: bool
    smem: int
    partial: int


@functools.lru_cache(maxsize=256)
def launch_plan(n: int, nbins: int, sms: int = 132, itemsize: int = 4, weights: int = 0,
                edge_itemsize: int = 0) -> Plan:
    """The kernel's plan for ``n`` values of ``itemsize`` bytes into
    ``nbins`` bins on a card of ``sms`` SMs; ``weights`` 0 (counts), 1
    (float64) or 2 (complex128); ``edge_itemsize`` the bytes of an edge in
    the comparison type (0: bincount's direct mode, no edges).  The most
    blocks an SM holds (4, 2, then 1) whose shared memory takes copies of
    the bins: every warp's copy where they fit in that share (one copy a
    block at least for counts, in a wide block where one fits an SM;
    weighted sums need a copy for each of their eight warps, and a stage
    of their weights).  Past that, counts go to 16-bit counters in one wide
    block an SM, up to 116216 bins; past those, and weighted sums past a
    copy a warp, to global atomics with four blocks an SM."""
    vec = 16 // itemsize
    units = -(-n // vec)
    edge_bytes = _align16((nbins + 1) * edge_itemsize) if edge_itemsize else 0
    edges_shared = 0 < edge_bytes <= EDGE_BUDGET
    fixed = (edge_bytes if edges_shared else 0) + WARPS * 32 * 8 * weights
    per_copy = nbins * _COUNT_BYTES[weights]
    budget = BLOCK_SHARED - STATIC_SHARED
    mode, threads, per_sm, copies, partial_block = GLOBAL, THREADS, MAX_BLOCKS_PER_SM, 0, 0
    smem = edge_bytes if edges_shared else 0  # GLOBAL: no copies, no weight stage
    for resident in (MAX_BLOCKS_PER_SM, 2, 1):
        room = (min(budget, SM_SHARED // resident - 1024 - STATIC_SHARED) - fixed) // per_copy
        fit = min(WARPS, room) if weights == 0 else (WARPS if room >= WARPS else 0)
        if fit > 0:
            mode, per_sm, copies = COPIES, resident, fit
            smem, partial_block = _align16(fit * per_copy) + fixed, per_copy
            threads = WIDE_THREADS if weights == 0 and resident == 1 else THREADS
            break
    words = -(-nbins // 2) * 4
    if mode == GLOBAL and weights == 0 and _align16(words) + fixed <= budget:
        mode, threads, per_sm, smem, partial_block = HALF, WIDE_THREADS, 1, _align16(words) + fixed, words
    blocks = max(1, min(sms * per_sm, -(-units // threads)))
    return Plan(vec, units, threads, blocks, per_sm, mode, copies, edges_shared, smem, blocks * partial_block)


def counter(b: int):
    """``(word, shift)``: bin ``b``'s 16-bit counter in HALF mode."""
    return b // 2, 16 * (b % 2)


def shares(plan: Plan, n: int):
    """``(first, last)`` element ranges, one a block: the values each block
    reads."""
    out = []
    for b in range(plan.blocks):
        u0, u1 = b * plan.units // plan.blocks, (b + 1) * plan.units // plan.blocks
        out.append((min(u0 * plan.vec, n), min(u1 * plan.vec, n)))
    return out


# -- the kernel -----------------------------------------------------------------------


def _check_weights(x, weights):
    if weights is None:
        return 0, None
    w = weights.reshape(-1)
    if w.dtype not in (torch.float64, torch.complex128):
        raise TypeError(f"the histogram kernel takes float64 or complex128 weights, not {w.dtype}")
    if w.device != x.device or w.shape[0] != x.numel():
        raise ValueError("the histogram kernel needs one weight a value, on the values' device")
    w = w.contiguous()
    return (2 if w.is_complex() else 1), w


def _run(x, ccode, edges_c, nbins, direct, weights):
    global LAUNCHES
    wk, w = _check_weights(x, weights)
    index = x.get_device()
    n = x.numel()
    plan = launch_plan(n, nbins, _sm_count(index), x.element_size(), wk,
                       0 if direct else edges_c.element_size())
    # 16-byte loads of the values, and of the weights
    aligned = x.data_ptr() % 16 == 0 and (w is None or w.data_ptr() % 16 == 0)
    out_dtype = (torch.int64, torch.float64, torch.complex128)[wk]
    make = torch.zeros if plan.mode in (HALF, GLOBAL) else torch.empty
    out = make(nbins, dtype=out_dtype, device=x.device)
    partial = torch.empty(plan.partial, dtype=torch.uint8, device=x.device) if plan.mode != GLOBAL else None
    _launcher()(index, x.data_ptr(), n, DATA_CODES[x.dtype], ccode, None if direct else edges_c.data_ptr(),
                nbins, int(direct), None if w is None else w.data_ptr(), wk, out.data_ptr(),
                None if partial is None else partial.data_ptr(), plan.units, plan.threads, plan.blocks, plan.mode,
                plan.copies, int(plan.edges_shared), int(aligned), plan.smem)
    LAUNCHES += 1
    return out


def histogram_counts_cuda(x, edges, weights=None):
    """Launch the kernel: numpy's histogram counts of the CUDA tensor ``x``
    (any shape, any held dtype) over ``edges`` (at least two, sorted, on
    the same device), with optional float64/complex128 weights of x's
    size.  Raises on anything the kernel does not take."""
    if x.device.type != "cuda" or edges.device != x.device:
        raise ValueError(f"histogram_counts_cuda needs CUDA tensors on one device, got {x.device}, {edges.device}")
    if x.dtype not in DATA_CODES:
        raise TypeError(f"the histogram kernel does not take {x.dtype}")
    nbins = edges.numel() - 1
    if nbins < 1:
        raise ValueError("the histogram kernel needs at least two edges")
    rt = comparison_dtype(x.dtype, edges.dtype)
    ct = kernel_compare(rt)
    x = kernel_data(x, rt)
    if DATA_CODES[x.dtype] not in KERNEL_PAIRS[ct]:
        raise TypeError(f"the histogram kernel does not compare {x.dtype} in {ct}")
    return _run(x.reshape(-1).contiguous(), COMPARE_CODES[ct], kernel_edges(edges, rt), nbins, False, weights)


def bincount_cuda(x, length, weights=None):
    """Launch the kernel's direct mode: the bincount of an int64 CUDA
    tensor whose values lie in ``[0, length)`` (values outside are
    dropped), with optional float64 weights.  A length of 0 launches
    nothing."""
    if x.device.type != "cuda":
        raise ValueError(f"bincount_cuda needs a CUDA tensor, got one on {x.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"bincount_cuda takes int64 values, not {x.dtype}")
    if weights is not None and weights.dtype != torch.float64:
        raise TypeError(f"bincount_cuda takes float64 weights, not {weights.dtype}")
    if length == 0:
        return torch.zeros(0, dtype=torch.int64 if weights is None else torch.float64, device=x.device)
    return _run(x.reshape(-1).contiguous(), 0, None, int(length), True, weights)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launcher():
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return Launcher("histogram", "histogram_launch",
                    [p, ll, i, i, p, ll, i, p, i, p, p, ll, i, ll, i, i, i, i, ll], "histogram")
