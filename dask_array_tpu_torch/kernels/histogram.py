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
- Counts of float16 and bfloat16 data take the pattern route instead
  (``launch_plan(..., patterns=True)``): a 2-byte value's bits are counted
  by an order key (``pattern_key``) inside the window of keys between the
  edges (``key_window``), in 32-bit or 16-bit shared counters
  (``counter_bits``), and each key's count goes to its bin once, found by
  numpy's comparison (``fold_keys``).  No value is looked up.
- Counts of 1-byte data (torch's float8 types, and the narrow types'
  uint8 carriers, ``_narrow``) take the byte route
  (``histogram_bytes_cuda``): each of the 256 patterns is counted, with
  no decode and no comparison, then each pattern's count goes to the bin
  of its value (``byte_values``); ``histogram_bytes_plain`` is its plain
  version.
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

from dask_array_tpu_torch._chunks import (
    cast,
    format_of,
    is_float_dtype,
    numpy_dtype,
    order_key,
    search_numpy,
    to_compute,
    value_of,
)
from dask_array_tpu_torch._narrow import decode_table
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


def histogram_counts_plain(x, edges, weights=None, dtype=None):
    """numpy's histogram counts of the held block ``x`` (any shape) over
    ``edges`` (a tensor) in torch ops: int64, or the float64 (complex128)
    sums of ``weights``.  ``dtype``: x's numpy dtype where x is a narrow
    type's carrier (``_narrow``), whose values are counted.  (The values of
    a 1-byte type are exact in float32 or int32, so any comparison type
    that holds them orders them as numpy's does.)"""
    if dtype is not None:
        comparison_dtype(dtype, edges.dtype)  # numpy's refusal (float8_e4m3 against int64 edges) raises
    x = value_of(x, dtype)
    nbins = edges.shape[0] - 1
    idx = bin_indices(x.reshape(-1), edges)
    if weights is None:
        return torch.bincount(idx, minlength=nbins + 1)[:nbins]
    return _weighted_bincount(idx, weights.reshape(-1), nbins + 1)[:nbins]


def byte_values(dtype) -> torch.Tensor:
    """The value of each of the 256 patterns of a 1-byte type: a narrow
    numpy dtype's decode table (float32 or int32), a torch float8 type's
    values in float32."""
    fmt = format_of(dtype) if not isinstance(dtype, torch.dtype) else None
    if fmt is not None:
        return torch.from_numpy(decode_table(fmt.name))
    return torch.arange(256, dtype=torch.uint8).view(dtype).to(torch.float32)


def histogram_bytes_plain(x, edges, dtype):
    """The byte route's plain version: the bincount of the 256 bit
    patterns of the 1-byte data ``x`` (a narrow carrier of numpy ``dtype``,
    or a torch float8 tensor), then each pattern's count added into the bin
    of its value (``byte_values``), as the kernel's finish does."""
    comparison_dtype(dtype, edges.dtype)  # numpy's refusal raises
    nbins = edges.shape[0] - 1
    per_pattern = torch.bincount(x.reshape(-1).view(torch.uint8).to(torch.int64), minlength=256)
    bins = bin_indices(byte_values(dtype).to(x.device), edges)
    return torch.zeros(nbins + 1, dtype=torch.int64, device=x.device).index_add_(0, bins, per_pattern)[:nbins]


def bincount_plain(x, length, weights=None):
    """``bincount`` of int64 values in ``[0, length)`` in torch ops."""
    return torch.bincount(x, weights=weights, minlength=length)


# -- dispatch -------------------------------------------------------------------------


def histogram_counts(x, edges, weights=None, dtype=None):
    """The histogram counts: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor.  ``dtype`` is x's numpy dtype (it names a
    narrow type's uint8 carrier)."""
    if x.device.type == "cpu":
        return histogram_counts_plain(x, edges, weights, dtype)
    return histogram_counts_cuda(x, edges, weights, dtype)


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
    torch.complex64: 12, torch.complex128: 13, torch.bfloat16: 14, torch.float8_e4m3fn: 15, torch.float8_e5m2: 16,
    torch.float8_e4m3fnuz: 17, torch.float8_e5m2fnuz: 18,
}
COMPARE_CODES = {"float32": 0, "float64": 1, "int64": 2, "uint64": 3, "complex64": 4, "complex128": 5}
# the data codes each comparison type takes (csrc/histogram.cu's by_data
# instantiates exactly these): float32 holds bool, the 8- and 16-bit
# integers and float16/bfloat16/float32 exactly; a complex comparison takes complex
# data (``kernel_data`` casts real data to it)
KERNEL_PAIRS = {
    "float32": {0, 1, 2, 3, 4, 9, 10, 14}, "complex64": {12}, "float64": set(range(12)) | {14}, "complex128": {12, 13},
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
    for float16/bfloat16/float32 (exact for each), float64, complex64/complex128
    (lexicographic), uint64, and int64 for every other integer or bool."""
    rt = np.dtype(rt)
    if is_float_dtype(rt):  # bfloat16 too: float32 holds it exactly
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
# the counting modes of csrc/histogram.cu (BYTES: its histogram_bytes_launch)
COPIES, HALF, GLOBAL, PATTERN, BYTES = 0, 1, 2, 3, 4
# the data codes the pattern routes count: float16 and bfloat16 (PATTERN,
# against float32 or float64 edges) and torch's float8 types (BYTES, as are
# the narrow types' uint8 carriers, against any real comparison type)
PATTERN_DATA = {9, 14, 15, 16, 17, 18}
BYTE_DATA = {15, 16, 17, 18}
PATTERN_CODES = {0, 1}  # float32, float64 comparisons
BYTE_CODES = {0, 1, 2, 3}  # float32, float64, int64, uint64 comparisons
# the byte route (csrc/histogram.cu mirrors these): one block an SM, each
# thread with its own 256 8-bit counters, four a 32-bit word, flushed into
# the block's 32-bit totals every BYTE_FLUSH bytes it counts
BYTE_THREADS = 512
BYTE_SHARED = 64 * 4 * BYTE_THREADS  # the counters: 128 KB a block
BYTE_FLUSH = 240  # 5 rounds of 3 16-byte units: an 8-bit counter stays under 256


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
    2`` (``counter``).  GLOBAL: atomics into the output.  PATTERN:
    2-byte float data counted by order key in one wide block an SM,
    ``keys32`` keys at most in 32-bit counters, more (up to 65536) in
    16-bit ones (``counter_bits``).  BYTES: 1-byte data counted by pattern
    in each thread's 8-bit counters, flushed every ``flush`` bytes a
    thread.  ``edges_shared``: the edges staged in
    shared memory.  ``smem``: dynamic shared bytes; ``partial``: scratch
    bytes of the blocks' partials (HALF: their words; PATTERN: ``smem`` a
    block, its counters)."""

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
    keys32: int = 0
    flush: int = 0


@functools.lru_cache(maxsize=256)
def launch_plan(n: int, nbins: int, sms: int = 132, itemsize: int = 4, weights: int = 0,
                edge_itemsize: int = 0, patterns: bool = False) -> Plan:
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
    copy a warp, to global atomics with four blocks an SM.  ``patterns``:
    the counts of 2-byte float data (``PATTERN``): one wide block an SM
    whose whole share holds the key counters; of 1-byte data (``BYTES``):
    one block of ``BYTE_THREADS`` an SM, 256 8-bit counters a thread."""
    vec = 16 // itemsize
    units = -(-n // vec)
    if patterns and itemsize == 1:
        # the byte route: private counters, one block an SM
        if weights or not edge_itemsize:
            raise ValueError("the byte route counts 1-byte data against edges, unweighted")
        blocks = max(1, min(sms, -(-units // BYTE_THREADS)))
        if -(-units // blocks) >= 2**28:
            raise ValueError(f"the byte route's 32-bit counters cannot take {n} values in {blocks} blocks")
        return Plan(vec, units, BYTE_THREADS, blocks, 1, BYTES, 0, False, BYTE_SHARED, blocks * 256 * 4,
                    flush=BYTE_FLUSH)
    if patterns:
        if weights or itemsize != 2 or not edge_itemsize:
            raise ValueError("the pattern route counts 2-byte float data against edges, unweighted")
        blocks = max(1, min(sms, -(-units // WIDE_THREADS)))
        if -(-units // blocks) * vec >= 2**32:
            raise ValueError(f"the pattern route's 32-bit counters cannot take {n} values in {blocks} blocks")
        smem = BLOCK_SHARED - STATIC_SHARED
        return Plan(vec, units, WIDE_THREADS, blocks, 1, PATTERN, 0, False, smem, blocks * smem, smem // 4)
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


def pattern_route(dtype, ccode: int, weights: int) -> bool:
    """Whether the kernel counts values of ``dtype`` compared in
    comparison code ``ccode`` by 2-byte bit pattern: unweighted float16 or
    bfloat16 data against float32 or float64 edges."""
    return (weights == 0 and DATA_CODES.get(dtype) in PATTERN_DATA - BYTE_DATA and ccode in PATTERN_CODES)


def counter_bits(plan: Plan, span: int) -> int:
    """The width of the pattern route's shared counters for a window of
    ``span`` keys: 32 bits while the window fits the block's share, else
    16 (two a word, their wraps carried as in HALF mode)."""
    return 32 if span <= plan.keys32 else 16


# +inf's bit pattern of the 2-byte floats the pattern route takes
_INF16 = {torch.float16: 0x7C00, torch.bfloat16: 0x7F80}


def pattern_key(p):
    """The order key of 16-bit float patterns ``p`` (numpy integers):
    monotone in the value over the non-NaN patterns, -0 just below +0,
    the NaN patterns beyond -inf and +inf.  ``csrc/histogram.cu``'s."""
    p = np.asarray(p, dtype=np.uint32)
    return p ^ (((p >> 15) * 0x7FFF) | 0x8000)


def pattern_of(k):
    """``pattern_key``'s inverse."""
    k = np.asarray(k, dtype=np.uint32)
    return k ^ ((((k >> 15) ^ 1) * 0x7FFF) | 0x8000)


def key_values(keys, dtype, compare):
    """The values of order ``keys`` of the 2-byte float ``dtype`` (a
    torch dtype) in the comparison type ``compare`` (exact)."""
    bits = torch.from_numpy(pattern_of(keys).astype(np.uint16).view(np.int16))
    return bits.view(dtype).to(_COMPARE_TORCH[compare]).numpy()


def key_window(e0, en, dtype, compare):
    """``(lo, span)``: the keys of the 2-byte values in ``[e0, en]`` (the
    edges in the comparison type) are ``[lo, lo + span)``; span <= 0 for
    none.  The kernel's two binary searches over the keys of -inf .. +inf,
    as searchsorted."""
    kmin, kmax = (int(pattern_key(b)) for b in (_INF16[dtype] | 0x8000, _INF16[dtype]))
    vals = key_values(np.arange(kmin, kmax + 1), dtype, compare)
    real = np.dtype(compare).type
    lo = kmin + int(np.searchsorted(vals, real(e0), "left"))
    return lo, kmin + int(np.searchsorted(vals, real(en), "right")) - lo


def fold_keys(key_counts, lo, edges, dtype, compare):
    """The finish of the pattern route: the counts of keys ``lo ..`` (one
    a key of the window) added into the bins of ``edges`` (numpy, in the
    comparison type), each key's bin by numpy's rule, eN in the last
    bin."""
    nb = len(edges) - 1
    keys = lo + np.arange(len(key_counts))
    v = key_values(keys, dtype, compare)
    b = np.where(v == edges[-1], nb - 1, np.searchsorted(edges, v, "right") - 1)
    return np.bincount(b, weights=key_counts, minlength=nb).astype(np.int64)


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
    patterns = not direct and pattern_route(x.dtype, ccode, wk)
    plan = launch_plan(n, nbins, _sm_count(index), x.element_size(), wk,
                       0 if direct else edges_c.element_size(), patterns)
    # 16-byte loads of the values, and of the weights
    aligned = x.data_ptr() % 16 == 0 and (w is None or w.data_ptr() % 16 == 0)
    out_dtype = (torch.int64, torch.float64, torch.complex128)[wk]
    make = torch.zeros if plan.mode in (HALF, GLOBAL, PATTERN) else torch.empty
    out = make(nbins, dtype=out_dtype, device=x.device)
    partial = torch.empty(plan.partial, dtype=torch.uint8, device=x.device) if plan.mode != GLOBAL else None
    _launcher()(index, x.data_ptr(), n, DATA_CODES[x.dtype], ccode, None if direct else edges_c.data_ptr(),
                nbins, int(direct), None if w is None else w.data_ptr(), wk, out.data_ptr(),
                None if partial is None else partial.data_ptr(), plan.units, plan.threads, plan.blocks, plan.mode,
                plan.copies, int(plan.edges_shared), int(aligned), plan.smem)
    LAUNCHES += 1
    return out


def histogram_counts_cuda(x, edges, weights=None, dtype=None):
    """Launch the kernel: numpy's histogram counts of the CUDA tensor ``x``
    (any shape, any held dtype; ``dtype`` its numpy dtype where it is a
    narrow type's uint8 carrier) over ``edges`` (at least two, sorted, on
    the same device), with optional float64/complex128 weights of x's
    size.  Unweighted counts of 1-byte float data go by the byte route; weighted ones decode
    the values to float32 (int32) first, one pass in torch ops, and take
    the route of those.  Raises on anything the kernel does not take."""
    if x.device.type != "cuda" or edges.device != x.device:
        raise ValueError(f"histogram_counts_cuda needs CUDA tensors on one device, got {x.device}, {edges.device}")
    fmt = format_of(dtype) if dtype is not None else None
    if fmt is None and x.dtype not in DATA_CODES:
        raise TypeError(f"the histogram kernel does not take {x.dtype}")
    nbins = edges.numel() - 1
    if nbins < 1:
        raise ValueError("the histogram kernel needs at least two edges")
    if fmt is not None or DATA_CODES[x.dtype] in BYTE_DATA:
        if weights is not None:
            return histogram_counts_cuda(value_of(x, dtype) if fmt is not None else x.to(torch.float32), edges,
                                         weights)
        return histogram_bytes_cuda(x, edges, dtype if fmt is not None else x.dtype)
    rt = comparison_dtype(x.dtype, edges.dtype)
    ct = kernel_compare(rt)
    x = kernel_data(x, rt)
    if DATA_CODES[x.dtype] not in KERNEL_PAIRS[ct]:
        raise TypeError(f"the histogram kernel does not compare {x.dtype} in {ct}")
    return _run(x.reshape(-1).contiguous(), COMPARE_CODES[ct], kernel_edges(edges, rt), nbins, False, weights)


def histogram_bytes_cuda(x, edges, dtype):
    """Launch the byte route: the counts of 1-byte data ``x`` (a narrow
    carrier of numpy ``dtype``, or a torch float8 tensor, ``dtype`` its
    torch dtype) over ``edges``, each of the 256 patterns counted, then
    binned by its value in numpy's comparison type."""
    global LAUNCHES
    rt = comparison_dtype(dtype, edges.dtype)
    ct = kernel_compare(rt)
    if COMPARE_CODES[ct] not in BYTE_CODES:
        raise TypeError(f"the histogram kernel's byte route does not compare in {ct}")
    edges_c = kernel_edges(edges, rt)
    table = device_byte_values(dtype, ct, x.device)
    x = x.reshape(-1).contiguous().view(torch.uint8)
    index, n, nbins = x.get_device(), x.numel(), edges_c.numel() - 1
    plan = launch_plan(n, nbins, _sm_count(index), 1, 0, edges_c.element_size(), True)
    out = torch.zeros(nbins, dtype=torch.int64, device=x.device)
    partial = torch.empty(plan.partial, dtype=torch.uint8, device=x.device)
    _bytes_launcher()(index, x.data_ptr(), n, COMPARE_CODES[ct], table.data_ptr(), edges_c.data_ptr(),
                      nbins, out.data_ptr(), partial.data_ptr(), plan.units, plan.blocks, int(x.data_ptr() % 16 == 0))
    LAUNCHES += 1
    return out


@functools.lru_cache(maxsize=64)
def device_byte_values(dtype, compare: str, device: torch.device) -> torch.Tensor:
    """``byte_values(dtype)`` in the kernel's comparison type ``compare``
    (int64 for the integer comparisons), on ``device``: made and copied up
    once, so no launch copies the table from pageable host memory."""
    table = byte_values(dtype)
    table = table.to(torch.int64) if compare in ("int64", "uint64") else table.to(_COMPARE_TORCH[compare])
    return table.contiguous().to(device)


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
def _bytes_launcher():
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return Launcher("histogram", "histogram_bytes_launch", [p, ll, i, p, p, ll, p, p, ll, ll, i], "histogram")


@functools.lru_cache(maxsize=None)
def _launcher():
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return Launcher("histogram", "histogram_launch",
                    [p, ll, i, i, p, ll, i, p, i, p, p, ll, i, ll, i, i, i, i, ll], "histogram")
