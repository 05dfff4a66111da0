"""``bincount`` and ``histogram``/``histogram2d``/``histogramdd`` through
the port on the CPU, with the counting route that stands in for the JAX
package's K2 (``dask_array_tpu/kernels/histogram.py``).

Each case runs data made from a numpy seed (``from_array``, several
chunkings) through the port, numpy and the JAX package; the JAX package's
histogram on both of its lanes: the default XLA lane and the scan forced
with ``config.set({"tpu.histogram-kernel": "pallas"})``.  Every real
dtype, uniform and non-uniform edges, integer edges up to the int64
maximum, NaN and ±inf.  Tolerance: counts and edges equal numpy's exactly,
dtype included; weighted sums (added in float64, cast to the weights'
dtype as numpy casts) to rtol 1e-12 in float64 and 1e-6 in float32 (numpy
adds float32 weights in float32 blocks); densities to rtol 1e-12.  Where
the JAX package differs from numpy (``KNOWN_REFERENCE_FAULTS``) the port
pins numpy.  Each host sync is held against its count in
``_fancy_indexing.SYNCS``.
"""

import warnings

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.ops import _fancy_indexing
from dask_array_tpu_torch.ops._histogram import histogram_counts

torch.set_num_threads(1)

CHUNKINGS = [7, 1, 100]
REAL = ["bool", "int8", "int32", "int64", "uint8", "uint64", "float16", "float32", "float64"]


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


def data(dtype, n=100, seed=0, specials=True):
    """Values in about [-12, 12] with ties; NaN and ±inf for floats."""
    rng = np.random.default_rng(seed)
    a = np.round(rng.standard_normal(n) * 5, 1)
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return a > 0
    if dt.kind == "u":
        a = np.abs(a)
    a = a.astype(dt)
    if dt.kind == "f" and specials:
        a[:4] = [np.nan, np.inf, -np.inf, -0.0]
    return a


def quiet(fn, *args, **kwargs):
    with warnings.catch_warnings(), np.errstate(all="ignore"):
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


def same(got, want, rtol=0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    if rtol:
        np.testing.assert_allclose(got, want, rtol=rtol, equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want)


def hist_of(mod, a, chunks, **kw):
    """(counts, edges) of ``a`` through a lazy module, as numpy arrays."""
    x = mod.from_array(a, chunks=chunks)
    if "weights" in kw:
        kw["weights"] = mod.from_array(kw["weights"], chunks=chunks)
    h, e = mod.histogram(x, **kw)
    return quiet(h.compute), e.compute()


# name -> (histogram keywords of the data's dtype, dtypes); numpy's data
# need finite values where it derives the range from them
HISTOGRAMS = {
    "uniform_range": (lambda dt: {"bins": 10, "range": (-6, 6)}, REAL),
    "uniform_data_range": (lambda dt: {"bins": 7}, ["int8", "int64", "uint8", "float16", "float32", "float64"]),
    "edges": (lambda dt: {"bins": np.array([-8.0, -1.5, 0.0, 0.0, 2.5, 3.0, 9.0])}, REAL),
    "int_edges": (lambda dt: {"bins": np.array([-5, -1, 0, 3, 8])}, ["int8", "int32", "int64", "uint8", "uint64",
                                                                   "float32"]),
    "weighted": (lambda dt: {"bins": 6, "range": (-3, 9), "weights": data("float64", seed=1, specials=False)},
                 ["float32", "int64", "float64"]),
    "weighted_float32": (lambda dt: {"bins": np.array([-9.0, -2, 0, 1, 4]), "weights": data("float32", seed=2,
                                                                                          specials=False)},
                         ["float64", "int32"]),
    "weighted_int": (lambda dt: {"bins": 5, "range": (0, 10), "weights": np.arange(100) % 7}, ["float64", "int8"]),
    "weighted_complex": (lambda dt: {"bins": 4, "range": (-4, 4), "weights": np.arange(100) * (1 - 0.5j)},
                         ["float32"]),
    "density": (lambda dt: {"bins": 8, "range": (-4, 4), "density": True}, ["float32", "float64", "int32"]),
    "density_edges_weighted": (lambda dt: {"bins": np.array([-9, -3, 0, 2, 9]), "density": True,
                                           "weights": data("float64", seed=3, specials=False)}, ["float64"]),
}

CASES = [(name, dt, ch) for name, (_, dts) in sorted(HISTOGRAMS.items()) for dt in dts for ch in CHUNKINGS]

# the JAX package's histograms that differ from numpy's, the port pinning
# numpy: its edges of a float16/float32 range are float64 where numpy's are
# the data's dtype, and it counts against those edges.  (Its scan lane
# sums weights and computes densities in float32, its XLA lane the
# densities of integer data: those are held to numpy at rtol 1e-4 and 1e-6.)
KNOWN_REFERENCE_FAULTS = {
    ("uniform_range", "float16"), ("uniform_range", "float32"), ("uniform_data_range", "float16"),
    ("uniform_data_range", "float32"), ("density", "float32"),
    ("weighted_complex", "float32"),  # its scan lane drops complex weights' imaginary parts
}


def _numpy_data(name, a):
    """numpy refuses a range derived from NaN or inf data: those cases run
    on the finite values (the port's refusal has its own test)."""
    return np.nan_to_num(a, nan=0.5, posinf=11, neginf=-11) if name == "uniform_data_range" and a.dtype.kind == "f" \
        else a


@pytest.mark.parametrize("name, dtype, chunks", CASES)
def test_histogram(name, dtype, chunks):
    kw_of, _ = HISTOGRAMS[name]
    a = _numpy_data(name, data(dtype))
    kw = kw_of(np.dtype(dtype))
    want_h, want_e = quiet(np.histogram, a, **kw)
    got_h, got_e = hist_of(tda, a, chunks, **dict(kw))
    rtol = 1e-12 if want_h.dtype == np.float64 else (1e-6 if want_h.dtype == np.float32 else 0)
    same(got_h, want_h, rtol)
    same(got_e, want_e)
    if chunks != CHUNKINGS[0] or (name, dtype) in KNOWN_REFERENCE_FAULTS:
        return
    for lane in ("xla", "pallas"):
        with jda.config.set({"tpu.histogram-kernel": lane}):
            ref_h, ref_e = hist_of(jda, a, chunks, **dict(kw))
        ref_rtol = 1e-6 if kw.get("density") else rtol or 1e-6  # integer data's densities in float32
        if lane == "pallas" and ("weights" in kw or kw.get("density")):
            ref_rtol = 1e-4  # the scan sums weights and densities in float32
        np.testing.assert_allclose(ref_h, want_h, rtol=ref_rtol, equal_nan=True)
        np.testing.assert_allclose(ref_e, want_e, rtol=1e-12)


@pytest.mark.parametrize("name, dtype", sorted(KNOWN_REFERENCE_FAULTS))
def test_known_reference_faults_are_real(name, dtype):
    kw = HISTOGRAMS[name][0](np.dtype(dtype))
    a = _numpy_data(name, data(dtype))
    want_h, want_e = quiet(np.histogram, a, **kw)
    differs = []
    for lane in ("xla", "pallas"):
        with jda.config.set({"tpu.histogram-kernel": lane}):
            ref_h, ref_e = hist_of(jda, a, 7, **dict(kw))
        differs.append(ref_e.dtype != want_e.dtype or not np.array_equal(ref_h, want_h))
    assert any(differs)


@pytest.mark.parametrize("dtype", ["float16", "float32", "float64", "int32", "int64", "uint64"])
@pytest.mark.parametrize("lane", ["xla", "pallas"])
def test_k2_route_equals_the_jax_package_on_both_lanes(dtype, lane):
    """The counting route on its own (``histogram_counts``) against the
    JAX package's histogram of the same data and float64 edges."""
    a = data(dtype, n=1000, seed=4)
    edges = np.linspace(-10, 10, 33)
    got = histogram_counts(torch.from_numpy(a), torch.from_numpy(edges)).numpy()
    same(got, quiet(np.histogram, a, bins=edges)[0].astype(np.int64))
    with jda.config.set({"tpu.histogram-kernel": lane}):
        ref, _ = jda.histogram(jda.from_array(a, chunks=100), bins=edges)
        ref = quiet(ref.compute)
    same(got, ref.astype(np.int64))


@pytest.mark.parametrize("dtype", ["int64", "uint64"])
def test_integer_edges_up_to_the_int64_maximum(dtype):
    """The last edge at INT64_MAX: a closed last bin with no ``e_last + 1``
    (the JAX package's scan declines this corner to its XLA lane)."""
    top = np.iinfo(np.int64).max
    a = np.array([top, top - 1, 0, 5, -3 if dtype == "int64" else 3, top, 2**62], dtype=dtype)
    edges = np.array([0, 4, 2**62, top], dtype=np.int64)
    want_h, want_e = np.histogram(a, bins=edges)
    got_h, got_e = hist_of(tda, a, 3, bins=edges)
    same(got_h, want_h)
    same(got_e, want_e)
    if dtype == "int64":
        with jda.config.set({"tpu.histogram-kernel": "pallas"}):
            ref_h, _ = hist_of(jda, a, 3, bins=edges)
        same(ref_h, want_h)


def test_int64_against_float_edges_compares_in_float64():
    a = np.array([2**53 + 1, 2**53, 2**53 - 1, -(2**60)], dtype=np.int64)
    edges = np.array([-1.0e19, 2.0**53, 2.0**53 + 2, 1e19])
    same(hist_of(tda, a, 2, bins=edges)[0], np.histogram(a, bins=edges)[0])


def test_lazy_edges_and_range():
    a = data("float64", specials=False)
    x = tda.from_array(a, chunks=7)
    edges = tda.from_array(np.array([-9.0, -1.0, 0.0, 4.0, 9.0]), chunks=2)
    h, e = tda.histogram(x, bins=edges)
    same(h.compute(), np.histogram(a, bins=[-9.0, -1.0, 0.0, 4.0, 9.0])[0])
    assert e is edges
    lo, hi = tda.from_array(np.array(-5.0)), tda.from_array(np.array(6.0))
    _fancy_indexing.SYNCS = 0
    h, e = tda.histogram(x, bins=11, range=(lo, hi))
    got_h, got_e = tda.compute(h, e)
    assert _fancy_indexing.SYNCS == 1  # the two endpoints come up once
    want_h, want_e = np.histogram(a, bins=11, range=(-5.0, 6.0))
    same(got_h, want_h)
    same(got_e, want_e)
    _fancy_indexing.SYNCS = 0
    h, _ = tda.histogram(x, bins=11, range=(-5, 6))
    h.compute()
    assert _fancy_indexing.SYNCS == 0  # numpy's edges, made on the host


def test_data_range_with_nan_raises_numpys_error():
    x = tda.from_array(data("float32"), chunks=7)
    with pytest.raises(ValueError, match="autodetected range of"):
        tda.histogram(x, bins=4)[0].compute()
    with pytest.raises(ValueError, match="autodetected range of"):
        np.histogram(data("float32"), bins=4)
    same(tda.histogram(tda.from_array(np.full(5, 3.0)), bins=2)[1].compute(), np.histogram(np.full(5, 3.0), bins=2)[1])


def test_histogram_refusals():
    x = tda.from_array(np.arange(10.0), chunks=3)
    with pytest.raises(ValueError, match="bins"):
        tda.histogram(x)
    with pytest.raises(ValueError, match="increase monotonically"):
        tda.histogram(x, bins=[0, 3, 1])
    with pytest.raises(ValueError, match="same shape"):
        tda.histogram(x, bins=3, range=(0, 9), weights=tda.ones(4, chunks=2))
    with pytest.raises(ValueError, match="max must be larger"):
        tda.histogram(x, bins=3, range=(5, 1))


HIST2D = [
    ("int_bins", {"bins": 4}),
    ("pair", {"bins": (3, 5), "range": [(-4, 4), (-2, 6)]}),
    ("edges", {"bins": [np.array([-9.0, 0, 1, 9]), np.array([-3.0, 3.0])]}),
    ("weights_density", {"bins": 3, "range": [(-4, 4), (-4, 4)], "density": True, "weights": True}),
]


@pytest.mark.parametrize("name, kw", HIST2D)
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_histogram2d(name, kw, dtype):
    x, y = data(dtype, specials=False), data(dtype, seed=5, specials=False)
    kw = dict(kw)
    w = data("float64", seed=6, specials=False) if kw.pop("weights", False) else None
    want = np.histogram2d(x, y, weights=w, **kw)
    got = tda.histogram2d(tda.from_array(x, chunks=7), tda.from_array(y, chunks=7),
                          weights=None if w is None else tda.from_array(w, chunks=7), **kw)
    for g, wnt in zip(got, want):
        same(g.compute(), wnt, 1e-12 if wnt.dtype.kind == "f" else 0)
    if dtype == "float32":
        return  # the JAX package bins float32 coordinates against float64 edges (counts differ)
    ref = jda.histogram2d(jda.from_array(x, chunks=7), jda.from_array(y, chunks=7),
                          weights=None if w is None else jda.from_array(w, chunks=7), **kw)
    np.testing.assert_allclose(ref[0].compute(), want[0], rtol=1e-12)


@pytest.mark.parametrize("as_array", [True, False])
def test_histogramdd(as_array):
    rng = np.random.default_rng(7)
    s = np.round(rng.standard_normal((60, 3)) * 3, 1)
    s[:2] = [[np.inf, 0, 0], [-1.0, np.nan, 2.0]]
    bins = [3, np.array([-4.0, -1.0, 1.0, 4.0]), 5]
    rng_ = [(-5, 5), None, (-2, 2)]
    want_h, want_e = np.histogramdd(s, bins=bins, range=rng_)
    sample = tda.from_array(s, chunks=(7, 3)) if as_array else [tda.from_array(s[:, i], chunks=9) for i in range(3)]
    got_h, got_e = tda.histogramdd(sample, bins=bins, range=rng_)
    same(got_h.compute(), want_h)
    for g, w in zip(got_e, want_e):
        same(g.compute(), w)
    finite = np.nan_to_num(s, posinf=8)
    want_h, want_e = np.histogramdd(finite, bins=4)
    got_h, got_e = tda.histogramdd(tda.from_array(finite, chunks=(7, 3)), bins=4)
    same(got_h.compute(), want_h)
    for g, w in zip(got_e, want_e):
        same(g.compute(), w)
    ref_h, _ = jda.histogramdd(jda.from_array(finite, chunks=(7, 3)), bins=4)
    np.testing.assert_allclose(ref_h.compute(), want_h)


BINCOUNT = [("int8", None, 0), ("int32", None, 30), ("int64", "float64", 0), ("uint8", "float32", 5),
            ("int64", "int32", 0), ("bool", None, 0), ("int16", "float16", 40)]


@pytest.mark.parametrize("dtype, wdtype, minlength", BINCOUNT)
@pytest.mark.parametrize("chunks", [7, 1, 100])
def test_bincount(dtype, wdtype, minlength, chunks):
    rng = np.random.default_rng(8)
    a = rng.integers(0, 25, 100).astype(dtype)
    w = None if wdtype is None else (rng.standard_normal(100) * 10).astype(wdtype)
    want = np.bincount(a, weights=w, minlength=minlength)
    x = tda.from_array(a, chunks=chunks)
    out = tda.bincount(x, weights=None if w is None else tda.from_array(w, chunks=chunks), minlength=minlength)
    assert np.isnan(out.shape[0])
    _fancy_indexing.SYNCS = 0
    same(out.compute(), want, 1e-12 if wdtype else 0)
    assert _fancy_indexing.SYNCS == 1
    if dtype != "bool" and wdtype != "float16" and chunks == 7:
        # (the JAX package adds float16 weights in float16; numpy in float64)
        ref = jda.bincount(jda.from_array(a, chunks=chunks),
                           weights=None if w is None else jda.from_array(w, chunks=chunks), minlength=minlength)
        np.testing.assert_allclose(ref.compute(), want, rtol=1e-6)


def test_bincount_refusals():
    with pytest.raises(ValueError, match="negative"):
        tda.bincount(tda.from_array(np.array([1, -2, 3]), chunks=2)).compute()
    with pytest.raises(TypeError):
        tda.bincount(tda.from_array(np.array([1.0, 2.0])))
    with pytest.raises(TypeError):
        tda.bincount(tda.from_array(np.array([1, 2], np.uint64)))
    with pytest.raises(ValueError):
        tda.bincount(tda.from_array(np.ones((2, 2), int)))
    same(tda.bincount(tda.from_array(np.array([], np.int64))).compute(), np.bincount(np.array([], np.int64)))
    same(tda.bincount(tda.from_array(np.array([], np.int64)), minlength=3).compute(),
         np.bincount(np.array([], np.int64), minlength=3))


# -- complex data: numpy's lexicographic order ----------------------------------

def complex_data(dtype="complex128", n=200, seed=13):
    """Integers and tenths on both parts; values on an edge with a negative
    and a positive imaginary part; NaN real and imaginary parts."""
    rng = np.random.default_rng(seed)
    z = np.round(rng.standard_normal(n) * 2, 0) + 1j * np.round(rng.standard_normal(n), 1)
    z[:8] = [1 - 0.5j, 1 + 0j, 1 + 0.5j, 3 + 0.5j, 3 - 0.5j, complex(np.nan, 1), complex(1, np.nan), -3 - 1j]
    return z.astype(dtype)


COMPLEX_HISTOGRAMS = {
    "range": {"bins": 3, "range": (0, 3)},
    "range_wide": {"bins": 6, "range": (-3, 3)},
    "real_edges": {"bins": np.array([-3.0, -1.0, 1.0, 1.5, 3.0])},
    "complex_edges": {"bins": np.array([-3, -1 + 0.5j, 1, 1 + 0.25j, 3 + 1j])},
    "weighted": {"bins": 4, "range": (-2, 2), "weights": np.arange(200.0) % 7 - 3},
    "weighted_complex": {"bins": np.array([-3.0, 0.0, 1.0, 3.0]), "weights": (np.arange(200.0) % 5) * (1 - 2j)},
    "density": {"bins": 5, "range": (-2.5, 2.5), "density": True},
}


@pytest.mark.parametrize("name", sorted(COMPLEX_HISTOGRAMS))
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
@pytest.mark.parametrize("chunks", CHUNKINGS)
def test_histogram_of_complex_data(name, dtype, chunks):
    """Counts, sums and edges equal numpy's; a NaN part drops the value.
    The JAX package counts complex data another way on both lanes
    (``test_complex_reference_faults_are_real``)."""
    z = complex_data(dtype)
    kw = COMPLEX_HISTOGRAMS[name]
    want_h, want_e = quiet(np.histogram, z, **kw)
    got_h, got_e = hist_of(tda, z, chunks, **dict(kw))
    same(got_h, want_h, 1e-12 if want_h.dtype.kind in "fc" else 0)
    same(got_e, want_e)
    zt, et = torch.from_numpy(z), torch.from_numpy(np.asarray(want_e))
    w = kw.get("weights")
    plain = histogram_counts(zt, et, None if w is None else torch.from_numpy(w.astype(np.result_type(w, np.float64))))
    if not kw.get("density"):
        same(plain.numpy().astype(want_h.dtype), want_h, 1e-12 if want_h.dtype.kind in "fc" else 0)


@pytest.mark.parametrize("name", ["range", "real_edges", "complex_edges", "weighted"])
def test_complex_reference_faults_are_real(name):
    z = complex_data()
    kw = COMPLEX_HISTOGRAMS[name]
    want_h, _ = quiet(np.histogram, z, **kw)
    for lane in ("xla", "pallas"):
        with jda.config.set({"tpu.histogram-kernel": lane}):
            ref_h, _ = hist_of(jda, z, 7, **dict(kw))
        assert not np.allclose(ref_h, want_h, rtol=1e-12)
