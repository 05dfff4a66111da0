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
    shares = hk.shares(plan, n)
    assert shares[0][0] == 0 and shares[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))  # contiguous: each value once
    runs = [(b + 1) * plan.units // plan.blocks - b * plan.units // plan.blocks for b in range(plan.blocks)]
    assert sum(runs) == plan.units and max(runs) - min(runs) <= 1
    assert plan.smem <= hk.BLOCK_SHARED and plan.per_sm * (plan.smem + 1024) <= hk.SM_SHARED
    if plan.copies:
        assert plan.partial == plan.blocks * nbins * {0: 4, 1: 8, 2: 16}[weights]
        assert weights == 0 or plan.copies == hk.WARPS  # deterministic sums: a copy a warp
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
    blocks an SM; 65536 bins and 65536-bin bincounts in global atomics."""
    p = check_plan(2**26, 256, 4, 0, 4)
    assert (p.blocks, p.per_sm, p.copies, p.edges_shared) == (528, 4, 8, True)
    p = check_plan(2**26, 256, 4, 1, 4)
    assert (p.per_sm, p.copies) == (4, 8)
    assert check_plan(2**26, 65536, 4, 0, 4).copies == 0
    assert check_plan(2**26, 65536, 8, 1, 0).copies == 0  # float64 atomics: bits may vary
    p = check_plan(2**26, 2000, 4, 1, 8)
    assert (p.per_sm, p.copies) == (1, 8)
    assert check_plan(0, 1, 4, 0, 4).blocks == 1


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
