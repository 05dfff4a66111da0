"""The host side of the histogram kernel (K2, ``kernels/histogram.py`` with
``csrc/histogram.cu``) on the CPU, where the kernel itself cannot run.

- The launch plan: every value is read by exactly one block, the blocks'
  shares of 16-byte units differ by at most one, and the shared memory
  fits the card, for n from 0 to 2**26 + 17 and every element size.
- The comparison type: ``np.result_type`` of data and edges for every pair
  of dtypes the port holds, the kernel's comparison type for it, and the
  kernel instantiating that pair (``KERNEL_PAIRS``, real data cast for a
  complex comparison); the edges converted as numpy converts them.
- The uniform-edge detection (``guess_margin``, which the kernel computes
  in each block): evenly spaced edges get a margin under half a bin,
  uneven ones one bin or more; and a value the guess takes without
  reading the edges is in numpy's bin, for values on and beside every edge
  (the guess's float32 and float64 arithmetic done here in numpy).
- The plain version against numpy and the JAX package (its XLA lane and
  its scan, ``tpu.histogram-kernel: pallas``) for every real dtype.
- The pattern route of float16 and bfloat16 counts, emulated in numpy:
  the order key of every one of the 65536 patterns, the window of keys
  between the edges, the counter width (16-bit counters with their wraps
  and carries, value by value, where the window is too wide for 32-bit
  ones), then the fold of each key's count into its bin; equal to
  ``np.histogram`` of the float32 values and to the plain version for
  float32 and float64 edges, 1 to 65536 bins.  Its launch plan at the
  main path's shapes and around the span where the counters narrow.

Tolerance: exact (counts, bins, plans).  The kernel is held against the
plain version and numpy on the card by ``tests/test_torch_gpu.py``.
"""

import math
import warnings

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
from dask_array_tpu_torch._chunks import torch_dtype
from dask_array_tpu_torch.kernels import histogram as hk

torch.set_num_threads(1)

HELD = ["bool", "uint8", "int8", "int16", "uint16", "int32", "uint32", "int64", "uint64", "float16", "float32",
        "float64", "complex64", "complex128"]


# -- the launch plan ------------------------------------------------------------------

SIZES = list(range(0, 70)) + [255, 256, 257, 1023, 1024, 1025, 4095, 65537, 10**6 + 3, 2**24, 2**26, 2**26 + 17]


def check_plan(n, nbins, itemsize, weights, edge_itemsize, sms=132, patterns=False):
    plan = hk.launch_plan(n, nbins, sms, itemsize, weights, edge_itemsize, patterns)
    assert plan.vec * itemsize == 16 and plan.units == -(-n // plan.vec)
    assert 1 <= plan.blocks <= sms * plan.per_sm and plan.per_sm in (1, 2, 4)
    # a wide block for counts where one block fits an SM, 256 threads otherwise
    assert plan.threads == (hk.WIDE_THREADS if weights == 0 and plan.per_sm == 1 and plan.mode != hk.GLOBAL
                            else hk.THREADS)
    shares = hk.shares(plan, n)
    assert shares[0][0] == 0 and shares[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))  # contiguous: each value read once
    runs = [(b + 1) * plan.units // plan.blocks - b * plan.units // plan.blocks for b in range(plan.blocks)]
    assert sum(runs) == plan.units and max(runs) - min(runs) <= 1
    # no block takes over 227 KB, static shared memory included; per_sm of them fit an SM
    assert plan.smem + hk.STATIC_SHARED <= hk.BLOCK_SHARED
    assert plan.per_sm * (plan.smem + hk.STATIC_SHARED + 1024) <= hk.SM_SHARED
    cb = {0: 4, 1: 8, 2: 16}[weights]
    if plan.mode == hk.COPIES:
        assert 1 <= plan.copies <= hk.WARPS and plan.partial == plan.blocks * nbins * cb
        assert weights == 0 or plan.copies == hk.WARPS  # deterministic sums: a copy a warp
        assert plan.smem >= plan.copies * nbins * cb + hk.WARPS * 32 * 8 * weights  # the copies, the weight stage
    elif plan.mode == hk.PATTERN:
        # one wide block an SM; its whole share holds the key counters, and
        # so does each block's partial: 32-bit counters for keys32 keys,
        # 16-bit ones for every key of a 2-byte float
        assert patterns and weights == 0 and plan.per_sm == 1 and plan.copies == 0 and not plan.edges_shared
        assert plan.keys32 == plan.smem // 4 and plan.partial == plan.blocks * plan.smem
        assert plan.smem >= 65536 // 2 * 4
        assert max(runs) * plan.vec < 2**32  # a block's count of one key fits its 32-bit counter
    elif plan.mode == hk.HALF:
        assert weights == 0 and plan.copies == 0 and plan.per_sm == 1
        words = -(-nbins // 2)
        assert plan.partial == plan.blocks * words * 4 and plan.smem >= words * 4
        # every bin has exactly one 16-bit counter of a block's words
        word, shift = hk.counter(np.arange(nbins))
        assert word.max() < words and set(np.unique(shift)) <= {0, 16}
        assert np.unique(word * 2 + shift // 16).size == nbins
    else:
        assert plan.mode == hk.GLOBAL and plan.partial == 0 and plan.copies == 0
        # global atomics only where no copy a warp (weighted) or 16-bit counters (counts) fit
        assert weights or -(-nbins // 2) * 4 > hk.BLOCK_SHARED - hk.STATIC_SHARED - (plan.smem if plan.edges_shared else 0)
    return plan


@pytest.mark.parametrize("itemsize", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("nbins, weights, edge_itemsize", [(1, 0, 4), (256, 0, 4), (256, 1, 8), (256, 2, 16),
                                                            (4096, 0, 8), (65536, 0, 4), (65536, 0, 0),
                                                            (65536, 1, 0), (1 << 20, 0, 0)])
def test_launch_plan_reads_every_value_once(itemsize, nbins, weights, edge_itemsize):
    for n in SIZES:
        check_plan(n, nbins, itemsize, weights, edge_itemsize)


def test_launch_plan_at_the_main_path_shapes():
    """2**26 float32 values: 256 bins in shared memory, a copy a warp, four
    blocks an SM; 65536 bins and 65536-bin bincounts in 16-bit counters
    (128 KB, one block of 1024 threads an SM); weighted 65536-bin
    bincounts and 2**17 bins in global atomics."""
    p = check_plan(2**26, 256, 4, 0, 4)
    assert (p.blocks, p.threads, p.per_sm, p.mode, p.copies, p.edges_shared) == (528, 256, 4, hk.COPIES, 8, True)
    p = check_plan(2**26, 256, 4, 1, 4)
    assert (p.per_sm, p.mode, p.copies) == (4, hk.COPIES, 8)
    p = check_plan(2**26, 65536, 4, 0, 4)
    assert (p.mode, p.threads, p.blocks, p.smem) == (hk.HALF, 1024, 132, 131072)
    p = check_plan(2**26, 65536, 8, 0, 0)
    assert (p.mode, p.threads, p.blocks, p.partial) == (hk.HALF, 1024, 132, 132 * 131072)
    assert check_plan(2**26, 65536, 8, 1, 0).mode == hk.GLOBAL  # float64 atomics: bits may vary
    p = check_plan(2**26, 2000, 4, 1, 8)
    assert (p.per_sm, p.threads, p.mode, p.copies) == (1, 256, hk.COPIES, 8)
    p = check_plan(2**26, 16384, 4, 0, 4)
    assert (p.per_sm, p.threads, p.mode, p.copies) == (2, 256, hk.COPIES, 1)
    p = check_plan(2**26, 32768, 4, 0, 4)
    assert (p.per_sm, p.threads, p.mode, p.copies) == (1, 1024, hk.COPIES, 1)
    assert check_plan(2**26, 1 << 17, 8, 0, 0).mode == hk.GLOBAL
    assert check_plan(0, 1, 4, 0, 4).blocks == 1


# nb from 1 to 2**20 around every edge of the budget: copies a warp and one
# copy a block, 16-bit counters, global atomics
EDGE_BINS = [1, 2, 3, 255, 256, 1000, 3632, 3633, 7264, 14328, 14329, 29056, 57344, 58107, 58108, 58109, 58112,
             65535, 65536, 65537, 116215, 116216, 116217, 131072, 262144, 2**20 - 1, 2**20]


@pytest.mark.parametrize("weights, edge_itemsize", [(0, 0), (0, 4), (0, 8), (1, 0), (1, 8), (2, 16)])
@pytest.mark.parametrize("nbins", EDGE_BINS)
def test_launch_plan_over_the_shared_memory_budget(weights, edge_itemsize, nbins):
    """No block takes over 227 KB, every bin has one counter, every value is
    read once; counts stay on chip up to 116216 bins (16-bit counters past
    58108), weighted sums while a copy a warp fits."""
    edge_bytes = (nbins + 1) * edge_itemsize
    staged = -(-edge_bytes // 16) * 16 if 0 < edge_bytes <= hk.EDGE_BUDGET else 0
    room = hk.BLOCK_SHARED - hk.STATIC_SHARED - staged
    for n in (0, 1, 1000, 2**26):
        p = check_plan(n, nbins, 4, weights, edge_itemsize)
        if weights == 0:
            assert (p.mode == hk.COPIES) == (nbins * 4 <= room)
            assert (p.mode == hk.HALF) == (nbins * 4 > room >= -(-nbins // 2) * 4)
        else:
            assert (p.mode == hk.COPIES) == (hk.WARPS * (nbins + 32) * 8 * weights <= room)


def half_counts(order, nbins=2):
    """The 16-bit counters of csrc/histogram.cu's half mode emulated on one
    32-bit word (bins 0 and 1: its low and high halves, ``counter``) and
    the int64 output, for counts arriving in ``order`` (a sequence of
    bins)."""
    word, out = 0, np.zeros(nbins, np.int64)
    for b in order:
        sh = hk.counter(b)[1]
        old = word
        word = (word + (1 << sh)) & 0xFFFFFFFF  # atomicAdd: a carry out of the word is lost
        if (old >> sh) & 0xFFFF == 0xFFFF:  # this counter wrapped
            out[b] += 65536
            if sh == 0 and b + 1 < nbins:  # the carry into the high counter, taken back
                out[b + 1] += 65535 if old >> 16 == 0xFFFF else -1
    # the flush: each counter's 16 bits added to the output
    return out + np.array([(word >> (16 * (b & 1))) & 0xFFFF for b in range(nbins)])


@pytest.mark.parametrize("lo, hi", [(200_000, 0), (0, 200_000), (200_000, 131_071), (65_535, 65_536),
                                    (65_536, 65_535), (300_001, 262_145)])
def test_sixteen_bit_counters_hold_the_count_past_65535(lo, hi):
    """The wrap-and-carry holds both counts exactly past 65535, in order,
    reversed, and in random interleavings (a low counter's carry may reach
    the high one while it holds 0xFFFF, before or after its own wraps)."""
    seq = np.array([0] * lo + [1] * hi)
    for order in (seq, seq[::-1], *(np.random.default_rng(s).permutation(seq) for s in range(3))):
        np.testing.assert_array_equal(half_counts(order), [lo, hi])
    # a high counter at 0xFFFF when the low one carries into it, then wraps by its own count
    order = [1] * 65535 + [0] * 65536 + [1] * 3
    np.testing.assert_array_equal(half_counts(order), [65536, 65538])
    # the last bin of an odd count has no high neighbour: its carry is dropped
    np.testing.assert_array_equal(half_counts([0] * 70_000, nbins=1), [70_000])


@pytest.mark.parametrize("nbins, edge_itemsize", [(1, 4), (256, 4), (256, 8), (65536, 4), (1 << 20, 8)])
def test_pattern_plan_reads_every_value_once(nbins, edge_itemsize):
    for n in SIZES:
        for sms in (1, 132):
            p = check_plan(n, nbins, 2, 0, edge_itemsize, sms, patterns=True)
            assert p.mode == hk.PATTERN and p.vec == 8


def test_pattern_plan_at_the_main_path_shapes():
    """2**26 bfloat16 values: 132 blocks of 1024 threads, the 227 KB a
    block may take (58108 32-bit counters); [-4, 4] spans 33026 keys in
    bfloat16 and 34818 in float16 (32-bit counters), -inf .. inf 65282 and
    63490 (16-bit); the counters narrow past 58108 keys.  Weighted and
    other data keep their routes."""
    for edge_itemsize in (4, 8):
        p = check_plan(2**26, 256, 2, 0, edge_itemsize, patterns=True)
        assert (p.blocks, p.threads, p.mode, p.smem, p.keys32, p.partial) == (
            132, 1024, hk.PATTERN, 232432, 58108, 132 * 232432)
        assert hk.launch_plan(2**26, 65536, 132, 2, 0, edge_itemsize, True) == p  # no bin in the plan
    assert (hk.counter_bits(p, 58108), hk.counter_bits(p, 58109), hk.counter_bits(p, 65536)) == (32, 16, 16)
    for dtype, span44, span_all in ((torch.bfloat16, 33026, 65282), (torch.float16, 34818, 63490)):
        for compare in ("float32", "float64"):
            assert hk.key_window(-4.0, 4.0, dtype, compare)[1] == span44
            assert hk.key_window(-np.inf, np.inf, dtype, compare)[1] == span_all
    assert hk.counter_bits(p, 33026) == 32 and hk.counter_bits(p, 65282) == 16
    for dtype in (torch.bfloat16, torch.float16):
        for compare in hk.COMPARE_CODES:
            assert hk.pattern_route(dtype, hk.COMPARE_CODES[compare], 0) is (compare in ("float32", "float64"))
        assert not hk.pattern_route(dtype, 0, 1)
    assert not any(hk.pattern_route(dt, 0, 0) for dt in (torch.float32, torch.float64, torch.int16, torch.uint16))
    with pytest.raises(ValueError):
        hk.launch_plan(2**26, 256, 132, 2, 1, 8, True)
    with pytest.raises(ValueError):  # 2**32 values of one block would wrap a 32-bit counter
        hk.launch_plan(2**33, 256, 1, 2, 0, 8, True)


# -- the comparison type ------------------------------------------------------------


@pytest.mark.parametrize("data", HELD)
def test_comparison_type_of_every_dtype_pair(data):
    for edges in HELD:
        rt = np.result_type(np.dtype(data), np.dtype(edges))
        assert hk.comparison_dtype(torch_dtype(data), torch_dtype(edges)) == rt
        ct = hk.kernel_compare(rt)
        if rt.kind == "f":
            assert ct == ("float32" if rt.itemsize <= 4 else "float64")
        elif rt.kind == "c":
            assert ct == rt.name
        else:
            assert ct == ("uint64" if rt == np.uint64 else "int64")
        held = hk.kernel_data(torch.zeros(2, dtype=torch_dtype(data)), rt)
        assert held.dtype == (torch_dtype(rt) if rt.kind == "c" and np.dtype(data).kind != "c" else torch_dtype(data))
        assert hk.DATA_CODES[held.dtype] in hk.KERNEL_PAIRS[ct], (data, edges, ct)


@pytest.mark.parametrize("data", HELD)
@pytest.mark.parametrize("edges", ["bool", "int8", "uint16", "int64", "uint64", "float16", "float32", "float64",
                                   "complex64"])
def test_kernel_edges_are_numpys_cast(data, edges):
    e = np.array([0, 1, 3, 200, 2**40 + 1, 2**62 + 3]).astype(edges) if edges != "bool" else np.array([False, True])
    rt = np.result_type(np.dtype(data), e.dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = e.astype(rt)
    got = hk.kernel_edges(torch.from_numpy(e), rt)
    ct = hk.kernel_compare(rt)
    if ct == "uint64":
        assert got.dtype == torch.int64 and np.array_equal(got.numpy().view(np.uint64), want)
    else:
        assert got.dtype == hk._COMPARE_TORCH[ct] and np.array_equal(got.numpy(), want.astype(got.numpy().dtype))


# -- the uniform-edge detection --------------------------------------------------------

UNIFORM = [(1, -1.0, 1.0), (7, -3.0, 4.0), (256, -4.0, 4.0), (255, 1e6, 1e6 + 3000.0), (100, -1e4, 1e4),
           (65536, -4.0, 4.0), (3, 0.0, 1e-30)]


@pytest.mark.parametrize("dtype", ["float32", "float64", "int64", "complex128"])
@pytest.mark.parametrize("nbins, lo, hi", UNIFORM)
def test_evenly_spaced_edges_are_detected(dtype, nbins, lo, hi):
    if dtype == "int64" and hi - lo < 2 * nbins:
        lo, hi = lo * 1000, lo * 1000 + 4 * nbins
    edges = np.histogram_bin_edges(np.empty(0, dtype), nbins, (lo, hi))
    compare = hk.kernel_compare(np.result_type(np.dtype(dtype), edges.dtype))
    assert hk.guess_margin(edges, compare) < 0.5


@pytest.mark.parametrize("edges", [
    np.array([-8.0, -1.5, 0.0, 0.0, 2.5, 3.0, 9.0]),  # a repeated edge
    np.geomspace(1, 1e6, 50),
    np.array([0.0, 1.0, 2.0, 100.0]),
    np.array([0.0, 1.0, np.inf]),
    np.array([3.0, 3.0]),
    np.array([np.nan, 1.0, 2.0]),
    np.linspace(0, 1, 2**22 + 1),  # past the float32 guess's 2**22 bins
])
def test_uneven_edges_take_the_binary_search(edges):
    assert hk.guess_margin(edges, "float32") >= 1


def test_edges_within_a_bin_of_even_spacing_check_every_guess():
    """[0, 1, 3]: the guess is within a bin, so it is taken, but only a
    third of a bin or more from a bin edge without reading the edges."""
    assert 0.33 < hk.guess_margin(np.array([0.0, 1.0, 3.0]), "float32") < 0.34


def emulated_guess(v, edges, compare):
    """The kernel's fast path (``bin_of``) in numpy: its bin where it takes
    the guess without reading the edges, else -2 (the search)."""
    real = np.float32 if compare == "float32" else np.float64
    e = edges.real if edges.dtype.kind == "c" else edges
    g0, en = real(e[0]), real(e[-1])
    nb = len(e) - 1
    scale = real(nb) / real(en - g0)
    f = (real(v) - g0) * scale
    if real is np.float32:
        t = (f - np.float32(0.5)) + np.float32(12582912.0)
        gf = t - np.float32(12582912.0)
        g = int(gf)
    else:
        g = nb - 1 if f >= nb else (int(f) if f > 0 else 0)
        gf = real(g)
    r = f - gf
    m = real(hk.guess_margin(edges, compare))
    return g if m < 1 and m < r < 1 - m else -2


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nbins, lo, hi", UNIFORM[:5])
def test_a_guess_taken_without_the_edges_is_numpys_bin(dtype, nbins, lo, hi):
    edges = np.histogram_bin_edges(np.empty(0, dtype), nbins, (lo, hi))
    vals = np.concatenate([edges, np.nextafter(edges, np.inf), np.nextafter(edges, -np.inf),
                           np.linspace(lo, hi, 5001, dtype=dtype)]).astype(dtype)
    vals = vals[(vals >= edges[0]) & (vals < edges[-1])]
    want = np.searchsorted(edges, vals, side="right") - 1
    compare = hk.kernel_compare(np.result_type(vals.dtype, edges.dtype))
    got = np.array([emulated_guess(v, edges, compare) for v in vals])
    taken = got != -2
    assert taken.mean() > 0.5  # the guess does most of the work
    np.testing.assert_array_equal(got[taken], want[taken])


# -- the plain version against numpy and the JAX package --------------------------------


def data(dtype, n=997, seed=5):
    rng = np.random.default_rng(seed)
    a = np.round(rng.standard_normal(n) * 5, 1)
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return a > 0
    if dt.kind == "u":
        a = np.abs(a)
    a = a.astype(dt)
    if dt.kind == "f":
        a[:4] = [np.nan, np.inf, -np.inf, -0.0]
    return a


@pytest.mark.parametrize("dtype", HELD[:12])
@pytest.mark.parametrize("edges", [np.linspace(-6.0, 6.0, 13), np.array([-5, -1, 0, 3, 8]),
                                   np.array([-8.0, -1.5, 0.0, 0.0, 2.5, 3.0, 9.0])], ids=["uniform", "int", "repeat"])
@pytest.mark.parametrize("lane", ["xla", "pallas"])
def test_plain_version_equals_numpy_and_the_jax_package(dtype, edges, lane):
    a = data(dtype)
    with warnings.catch_warnings(), np.errstate(all="ignore"):
        warnings.simplefilter("ignore")
        want = np.histogram(a, bins=edges)[0].astype(np.int64)
        got = hk.histogram_counts_plain(torch.from_numpy(a), torch.from_numpy(edges)).numpy()
        assert np.array_equal(got, want)
        assert np.array_equal(hk.histogram_counts(torch.from_numpy(a), torch.from_numpy(edges)).numpy(), want)
        if dtype == "bool":
            return  # the JAX package subtracts bool data
        with jda.config.set({"tpu.histogram-kernel": lane}):
            ref, _ = jda.histogram(jda.from_array(a, chunks=100), bins=edges)
            ref = ref.compute()
    assert np.array_equal(np.asarray(ref).astype(np.int64), want)


def test_bincount_plain_and_the_dispatch():
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 40, 500))
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(500))
    assert torch.equal(hk.bincount_counts(x, 50), torch.bincount(x, minlength=50))
    assert torch.equal(hk.bincount_counts(x, 50, w), torch.bincount(x, weights=w, minlength=50))
    assert hk.LAUNCHES == 0 or isinstance(hk.LAUNCHES, int)
    assert math.isinf(hk.guess_margin(np.array([1.0]), "float64"))


# -- the pattern route, emulated -------------------------------------------------------

ALL_PATTERNS = np.arange(65536, dtype=np.uint16)


def pattern_counts(bits, edges, dtype, compare, plan):
    """The pattern route on the 16-bit patterns ``bits`` (in the order the
    values arrive) over ``edges`` (numpy, in the comparison type): the
    window, the counter width, the counts (16-bit counters value by value:
    a wrap adds 65536 to its key's bin at once, a low counter's carry into
    the high one is taken back from the high key's bin), then the fold."""
    lo, span = hk.key_window(edges[0], edges[-1], dtype, compare)
    nb = len(edges) - 1
    if span <= 0:
        return np.zeros(nb, np.int64)
    d = hk.pattern_key(bits).astype(np.int64) - lo
    d = d[(d >= 0) & (d < span)]
    if hk.counter_bits(plan, span) == 32:
        return hk.fold_keys(np.bincount(d, minlength=span), lo, edges, dtype, compare)
    words, out = np.zeros((span + 1) // 2, np.int64), np.zeros(nb, np.int64)

    def one(key):  # one count of key, folded into its bin
        c = np.zeros(span, np.int64)
        c[key] = 1
        return hk.fold_keys(c, lo, edges, dtype, compare)

    for k in d:
        sh = 16 * (k & 1)
        old = words[k >> 1]
        words[k >> 1] = (old + (1 << sh)) & 0xFFFFFFFF
        if (old >> sh) & 0xFFFF == 0xFFFF:
            out += 65536 * one(k)
            if sh == 0 and k + 1 < span:
                out += (65535 if old >> 16 == 0xFFFF else -1) * one(k + 1)
    counters = (words[np.arange(span) >> 1] >> (16 * (np.arange(span) & 1))) & 0xFFFF
    return out + hk.fold_keys(counters, lo, edges, dtype, compare)


def two_byte(dtype, bits):
    return torch.from_numpy(bits.view(np.int16)).view(dtype)


PATTERN_EDGES = {
    "uniform": lambda nb: np.linspace(-4.0, 4.0, nb + 1),
    "offset": lambda nb: np.linspace(-0.3, 0.7, nb + 1) + 1e-9,  # no 2-byte float lies on these edges
    "infinite": lambda nb: np.concatenate([[-np.inf], np.linspace(-100.0, 100.0, nb - 1), [np.inf]]) if nb > 1
    else np.array([-np.inf, np.inf]),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("compare", ["float32", "float64"])
@pytest.mark.parametrize("nbins", [1, 7, 256, 4096, 65536])
@pytest.mark.parametrize("edges", sorted(PATTERN_EDGES))
def test_pattern_route_counts_every_pattern_as_numpy(dtype, compare, nbins, edges):
    """Every 2-byte pattern as data (NaN, ±0, ±inf, subnormals, the edges'
    own values where a 2-byte float holds them): the emulated route equals
    numpy's histogram of the float32 values and the plain version."""
    e = PATTERN_EDGES[edges](nbins).astype(compare)
    bits = np.concatenate([ALL_PATTERNS, np.random.default_rng(nbins).permutation(ALL_PATTERNS)])
    x = two_byte(dtype, bits)
    vals = x.float().numpy()
    plan = hk.launch_plan(bits.size, nbins, 132, 2, 0, e.itemsize, True)
    got = pattern_counts(bits, e, dtype, compare, plan)
    with np.errstate(all="ignore"):
        want = np.histogram(vals[~np.isnan(vals)], bins=e)[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, hk.histogram_counts_plain(x, torch.from_numpy(e)).numpy())
    assert got.sum() == ((vals >= e[0]) & (vals <= e[-1])).sum()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("compare", ["float32", "float64"])
def test_pattern_route_sixteen_bit_counters_carry_their_wraps(dtype, compare):
    """A window of every finite and infinite key takes 16-bit counters;
    200001 copies of one value beside 131071 of its high neighbour (a low
    counter that wraps three times into a high one at 0xFFFF), in arrival
    order and shuffled, still count exactly, as numpy does."""
    e = np.array([-np.inf, -1.0, 0.0, 0.5, 1.0, np.inf], dtype=compare)
    plan = hk.launch_plan(10**6, 5, 132, 2, 0, e.itemsize, True)
    lo, span = hk.key_window(e[0], e[-1], dtype, compare)
    assert hk.counter_bits(plan, span) == 16
    k = lo + 2 * 5000  # a low counter; k + 1 its high neighbour
    low, high = (hk.pattern_of(k).astype(np.uint16), hk.pattern_of(k + 1).astype(np.uint16))
    bits = np.concatenate([np.full(131071, high, np.uint16), np.full(200001, low, np.uint16), ALL_PATTERNS])
    for order in (bits, np.random.default_rng(1).permutation(bits)):
        got = pattern_counts(order, e, dtype, compare, plan)
        vals = two_byte(dtype, order).float().numpy()
        np.testing.assert_array_equal(got, np.histogram(vals[~np.isnan(vals)], bins=e)[0])


def test_pattern_keys_follow_the_values():
    """The order key is a bijection of the 65536 patterns, monotone in the
    value over -inf .. inf (-0 below +0), NaN outside; float64 edges a
    2-byte float cannot hold give the window of the values between them."""
    keys = hk.pattern_key(ALL_PATTERNS)
    assert np.array_equal(np.sort(keys), np.arange(65536)) and np.array_equal(hk.pattern_of(keys), ALL_PATTERNS)
    for dtype, inf in ((torch.bfloat16, 0x7F80), (torch.float16, 0x7C00)):
        lo, hi = int(hk.pattern_key(inf | 0x8000)), int(hk.pattern_key(inf))
        v = hk.key_values(np.arange(65536), dtype, "float64")
        assert np.all(np.diff(v[lo:hi + 1]) >= 0) and np.isnan(v[:lo]).all() and np.isnan(v[hi + 1:]).all()
        assert hk.key_values(hk.pattern_key([0x8000, 0]), dtype, "float64").tolist() == [0.0, 0.0]
        assert int(hk.pattern_key(0)) == int(hk.pattern_key(0x8000)) + 1
        lo1, span1 = hk.key_window(0.1, 0.3, dtype, "float64")
        w = hk.key_values(np.arange(lo1 - 1, lo1 + span1 + 1), dtype, "float64")
        assert w[0] < 0.1 <= w[1] and w[-2] <= 0.3 < w[-1]
        assert hk.key_window(np.nan, 1.0, dtype, "float64")[1] <= 0


# -- the byte route: 1-byte data counted by pattern -----------------------------------

BYTE_TYPES = ["int2", "uint2", "int4", "uint4", "float4_e2m1fn", "float8_e3m4", "float8_e4m3", "float8_e4m3b11fnuz",
              "float8_e8m0fnu", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz", "float8_e5m2fnuz"]
TORCH_FLOAT8 = {"float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz", "float8_e5m2fnuz"}


def _byte_data(name, n=20000, seed=0):
    """``n`` bytes drawn over all 256 patterns (NaN and, for the sub-byte
    types, bytes past their bits among them) as the tensor the port holds:
    a torch float8 tensor, or a narrow type's uint8 carrier with its numpy
    dtype."""
    import ml_dtypes

    raw = torch.from_numpy(np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8))
    if name in TORCH_FLOAT8:
        return raw.view(getattr(torch, name)), getattr(torch, name)
    return raw, np.dtype(getattr(ml_dtypes, name))


@pytest.mark.parametrize("nbins, edge_itemsize", [(1, 4), (256, 4), (256, 8), (65536, 8)])
def test_byte_plan_reads_every_value_once(nbins, edge_itemsize):
    """The byte route's plan: 16 values a unit, blocks of 512 threads,
    one an SM at most, equal runs, each value read once, a block's count
    of one pattern within its 32-bit total; one partial of 256 words a
    block."""
    for n in SIZES:
        for sms in (1, 132):
            plan = hk.launch_plan(n, nbins, sms, 1, 0, edge_itemsize, True)
            assert plan.mode == hk.BYTES and plan.vec == 16 and plan.units == -(-n // 16)
            assert plan.threads == hk.BYTE_THREADS and 1 <= plan.blocks <= sms and plan.per_sm == 1
            assert plan.partial == plan.blocks * 256 * 4
            shares = hk.shares(plan, n)
            assert shares[0][0] == 0 and shares[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
            assert max(b - a for a, b in shares) < 2**32
    with pytest.raises(ValueError, match="unweighted"):
        hk.launch_plan(100, 4, 132, 1, 1, 8, True)


def test_byte_plan_at_the_main_path_shapes():
    """2**26 float8 values on 132 SMs: 132 blocks of 512 threads, 31776
    units (508416 values, 993 a thread) a block at most."""
    plan = hk.launch_plan(2**26, 256, 132, 1, 0, 8, True)
    assert (plan.blocks, plan.units, plan.threads) == (132, 2**22, 512)
    assert max(b - a for a, b in hk.shares(plan, 2**26)) == 31776 * 16


@pytest.mark.parametrize("nbins, edge_itemsize", [(1, 4), (256, 8), (65536, 8)])
def test_byte_plan_flushes_before_a_counter_passes_255(nbins, edge_itemsize):
    """Each thread's 256 8-bit counters, four a 32-bit word, laid out
    ``[word][thread]``: their shared bytes a block, with the block's 256
    32-bit totals and the 1 KB the card reserves a block, fit an SM
    (``SM_SHARED``) and one block's limit; a thread flushes them at most
    every 255 bytes it counts (a whole number of rounds of 16-byte units),
    so no counter wraps, even when every byte is one pattern."""
    for n in (1, 4095, 2**20 + 3, 2**26, 2**26 + 17):
        for sms in (1, 132):
            plan = hk.launch_plan(n, nbins, sms, 1, 0, edge_itemsize, True)
            assert plan.smem == 256 * plan.threads == hk.BYTE_SHARED
            assert plan.per_sm * (plan.smem + 256 * 4 + 1024) <= hk.SM_SHARED
            assert plan.smem + 256 * 4 <= hk.BLOCK_SHARED
            assert 0 < plan.flush <= 255 and plan.flush % 16 == 0


def _emulated_byte_counts(x, plan):
    """A numpy emulation of the byte route's counting: each block's run of
    bytes dealt to its threads as the kernel deals them (whole rounds of 3
    16-byte units a thread, then the rest a byte a thread), the thread's
    8-bit counters wrapping as uint8 and flushed into 32-bit totals every
    ``plan.flush`` bytes it counts."""
    x = x.reshape(-1).view(torch.uint8).numpy()
    n, t, unroll = x.size, plan.threads, 3
    rounds = plan.flush // (16 * unroll)
    total = np.zeros(256, np.int64)
    for a, b in hk.shares(plan, n):
        cnt = np.zeros((t, 256), np.uint8)
        base = a // 16
        whole, stop = n // 16, b // 16 if b < n else -(-n // 16)

        def flush():
            nonlocal cnt
            total[:] += cnt.sum(axis=0, dtype=np.int64)
            cnt = np.zeros((t, 256), np.uint8)

        while base + t * unroll <= stop and base + t * unroll <= whole:
            for _ in range(rounds):
                if not (base + t * unroll <= stop and base + t * unroll <= whole):
                    break
                units = x[base * 16:(base + t * unroll) * 16].reshape(unroll, t, 16)
                for k in range(unroll):
                    np.add.at(cnt, (np.repeat(np.arange(t), 16), units[k].reshape(-1)), 1)
                base += t * unroll
            flush()
        end = min(b, n)
        for s in range(base * 16, end, t * plan.flush):
            rest = x[s:min(s + t * plan.flush, end)]
            np.add.at(cnt, (np.arange(rest.size) % t, rest), 1)
            flush()
    return total


@pytest.mark.parametrize("skew", ["one", "sixteen", "all"])
def test_byte_counters_never_wrap_on_skewed_data(skew):
    """The emulated private counters (one pattern everywhere, the worst
    case; 16 patterns; all 256) count every byte: their totals equal a
    bincount, on two SMs so that each thread counts past 255 bytes."""
    n = 2 * 512 * 1000 + 37
    rng = np.random.default_rng(3)
    raw = {"one": np.full(n, 0x38, np.uint8), "sixteen": rng.integers(0, 16, n).astype(np.uint8) * 16 + 7,
           "all": rng.integers(0, 256, n).astype(np.uint8)}[skew]
    x = torch.from_numpy(raw)
    plan = hk.launch_plan(n, 256, 2, 1, 0, 4, True)
    assert max(b - a for a, b in hk.shares(plan, n)) // plan.threads > 255
    np.testing.assert_array_equal(_emulated_byte_counts(x, plan), np.bincount(raw, minlength=256))


@pytest.mark.parametrize("edges", ["f4", "f8", "i8"])
@pytest.mark.parametrize("skew", ["one", "sixteen"])
@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2", "int4"])
def test_byte_route_on_skewed_data_equals_the_jax_package(name, skew, edges):
    """The byte route's plain version, and the plain version of the
    values, on skewed data (every byte one pattern; 16 patterns) equal the
    JAX package's histogram of the decoded values (float64, so every
    1-byte value is exact)."""
    n = 5000
    rng = np.random.default_rng(7)
    if skew == "one":
        raw = np.full(n, 0x35 if name != "int4" else 0x03, np.uint8)
    elif name == "int4":
        raw = rng.integers(0, 16, n).astype(np.uint8)  # every int4 pattern
    else:
        raw = (rng.integers(0, 16, n) + 0x30).astype(np.uint8)  # 16 neighbouring values
    x, dt = _byte_data(name, 1)
    x = torch.from_numpy(raw).view(x.dtype)
    e = {"f4": np.linspace(-4, 4, 17, dtype=np.float32), "f8": np.linspace(-3.3, 5.1, 257),
         "i8": np.arange(-8, 9, 2, dtype=np.int64)}[edges]
    et = torch.from_numpy(e)
    try:
        hk.comparison_dtype(dt, et.dtype)
    except TypeError:  # numpy has no common type (float8_e4m3fn and int64)
        return
    got = hk.histogram_bytes_plain(x, et, dt)
    plain = hk.histogram_counts_plain(x, et, None, None if name in TORCH_FLOAT8 else dt)
    vals = hk.byte_values(dt)[x.view(torch.uint8).to(torch.int64)].double().numpy()
    ref, _ = jda.histogram(jda.from_array(vals, chunks=1000), bins=e.astype(np.float64))
    ref = np.asarray(ref.compute()).astype(np.int64)
    assert ref.sum() > 0 or skew == "one"
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(plain.numpy(), ref)


@pytest.mark.parametrize("name", BYTE_TYPES)
def test_device_byte_table_is_the_patterns_values(name):
    """The byte route's table, made once a (type, comparison type, device)
    and kept: ``byte_values`` in the kernel's comparison type, for every
    1-byte type the route takes and every comparison type it takes; the
    second call hands back the same tensor."""
    _, dt = _byte_data(name, 1)
    for compare, want in (("float32", torch.float32), ("float64", torch.float64), ("int64", torch.int64),
                          ("uint64", torch.int64)):
        got = hk.device_byte_values(dt, compare, torch.device("cpu"))
        assert got.dtype == want and got.is_contiguous() and got.shape == (256,)
        vals = hk.byte_values(dt)
        if want == torch.int64:
            finite = torch.isfinite(vals.double())
            assert torch.equal(got[finite], vals.to(torch.int64)[finite])
        else:
            assert torch.equal(got.view(torch.uint8), vals.to(want).view(torch.uint8))
        assert hk.device_byte_values(dt, compare, torch.device("cpu")) is got


@pytest.mark.parametrize("name", BYTE_TYPES)
def test_byte_values_are_the_patterns_values(name):
    """``byte_values``: each of the 256 patterns' value, as ml_dtypes reads
    it (NaN where it is NaN)."""
    import ml_dtypes

    _, dt = _byte_data(name, 1)
    got = hk.byte_values(dt).numpy()
    want = np.arange(256, dtype=np.uint8).view(getattr(ml_dtypes, name)).astype(got.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("edges", ["f4", "f8", "i8", "wide"])
@pytest.mark.parametrize("name", BYTE_TYPES)
def test_byte_pattern_count_equals_the_plain_version(name, edges):
    """The byte route's plain version (a bincount of the 256 patterns, then
    each pattern's count into its value's bin) equals the plain version on
    the decoded values and numpy's histogram of the float64 values, for
    float32, float64 and int64 edges and edges past every value."""
    x, dt = _byte_data(name)
    e = {"f4": np.linspace(-4, 4, 17, dtype=np.float32), "f8": np.linspace(-3.3, 5.1, 257),
         "i8": np.arange(-8, 9, 2, dtype=np.int64), "wide": np.array([-1e300, -1.0, 0.0, 1.0, 1e300])}[edges]
    et = torch.from_numpy(e)
    try:
        hk.comparison_dtype(dt, et.dtype)
    except TypeError:  # numpy has no common type (float8_e4m3fn and int64): both refuse
        with pytest.raises(TypeError):
            hk.histogram_counts_plain(x, et, None, None if name in TORCH_FLOAT8 else dt)
        return
    got = hk.histogram_bytes_plain(x, et, dt)
    plain = hk.histogram_counts_plain(x, et, None, None if name in TORCH_FLOAT8 else dt)
    vals = hk.byte_values(dt)[x.view(torch.uint8).to(torch.int64)].double().numpy()
    want = np.histogram(vals[~np.isnan(vals)], bins=e.astype(np.float64))[0]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(plain.numpy(), want)
