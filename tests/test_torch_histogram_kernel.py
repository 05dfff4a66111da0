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


def check_plan(n, nbins, itemsize, weights, edge_itemsize, sms=132):
    plan = hk.launch_plan(n, nbins, sms, itemsize, weights, edge_itemsize)
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
