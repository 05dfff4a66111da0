"""The quantiles through the port on the CPU: ``median``, ``nanmedian``,
``quantile``, ``nanquantile`` (every numpy method), ``percentile`` and
``nanpercentile`` (with dask's approximate ``internal_method``), and
numpy's dispatch to them.

Each case runs data made from a numpy seed (``from_array``, several
chunkings) with ties, NaN and ±inf through the port, numpy and the JAX
package.  Tolerance: the discrete methods (``lower``, ``higher``,
``nearest``, ``inverted_cdf``, ``closest_observation``) and medians of odd
counts equal numpy's exactly; the interpolating methods, which the port
computes with numpy's own host tables and numpy's ``_lerp`` in numpy's
dtype, to rtol 1e-12 in float64 and 1e-6 in float32/float16 data (numpy's
float16 nanmedian of a short axis adds in float16, the port in float32).
The result's dtype is numpy's, which for a list of q and float32 data is
float64.  The JAX package is held to numpy's values at rtol 1e-6 (its
dtype is not numpy's for a list of q); where its values differ
(``KNOWN_REFERENCE_FAULTS``) the port pins numpy.  ``ApproxPercentile``
is held to the JAX package, not to numpy, at rtol 1e-6.
"""

import warnings

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.ops import _fancy_indexing

torch.set_num_threads(1)

SHAPE = (9, 12)
CHUNKINGS = [(4, 5), (1, 12), (9, 1)]
METHODS = ["inverted_cdf", "averaged_inverted_cdf", "closest_observation", "interpolated_inverted_cdf", "hazen",
           "weibull", "linear", "median_unbiased", "normal_unbiased", "lower", "higher", "midpoint", "nearest"]
DISCRETE = {"inverted_cdf", "closest_observation", "lower", "higher", "nearest"}


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


def base(dtype="float64", seed=0, shape=SHAPE, nan=True):
    rng = np.random.default_rng(seed)
    a = np.round(rng.standard_normal(shape) * 8, 1)
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return a > 0
    if dt.kind == "u":
        a = np.abs(a)
    if dt.kind in "fc" and nan:
        a.ravel()[[0, 13, 30, 31]] = [np.nan, np.inf, -np.inf, np.nan]
    a = a.astype(dt)
    if dt.kind == "c":
        a = a + 1j * np.round(rng.standard_normal(shape), 1).astype(dt)
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


def tolerance(dtype, method="median"):
    if method in DISCRETE:
        return 0
    return 1e-12 if np.dtype(dtype) in (np.float64, np.complex128) or np.dtype(dtype).kind in "biu" else 1e-6


def run(fn_name, mod, a, chunks, *args, **kwargs):
    x = a if mod is np else mod.from_array(a, chunks=chunks)
    out = quiet(getattr(mod, fn_name), x, *args, **kwargs)
    return out if mod is np else quiet(out.compute)


MEDIANS = [(kind, dtype, axis, keepdims) for kind, dtypes in (
    ("median", ["bool", "int8", "int32", "int64", "uint8", "uint64", "float16", "float32", "float64", "complex64"]),
    ("nanmedian", ["int32", "float16", "float32", "float64"]))
    for dtype in dtypes for axis, keepdims in ((None, False), (0, False), (1, True), ((0, 1), False), (-1, False))]


@pytest.mark.parametrize("kind, dtype, axis, keepdims", MEDIANS)
@pytest.mark.parametrize("chunks", CHUNKINGS)
def test_median(kind, dtype, axis, keepdims, chunks):
    a = base(dtype)
    want = run(kind, np, a, chunks, axis=axis, keepdims=keepdims)
    got = run(kind, tda, a, chunks, axis=axis, keepdims=keepdims)
    rtol = 1e-3 if dtype == "float16" else tolerance(dtype)
    same(got, want, rtol)
    if chunks == CHUNKINGS[0] and (kind, None, dtype) not in KNOWN_REFERENCE_FAULTS:
        ref = run(kind, jda, a, chunks, axis=axis, keepdims=keepdims)
        np.testing.assert_allclose(ref, want, rtol=rtol or 1e-6, equal_nan=True)


QUANTILES = [(kind, method, dtype, q) for kind, dtypes in (
    ("quantile", ["int8", "int64", "uint8", "uint64", "float16", "float32", "float64"]),
    ("nanquantile", ["int32", "float32", "float64"]))
    for method in METHODS for dtype in dtypes for q in (0.3, [0.0, 0.25, 0.5, 1.0])]


@pytest.mark.parametrize("kind, method, dtype, q", QUANTILES)
def test_quantile(kind, method, dtype, q):
    a = base(dtype)
    chunks = CHUNKINGS[(METHODS.index(method) + len(dtype)) % len(CHUNKINGS)]
    for axis in (1, None):
        want = run(kind, np, a, chunks, q, axis=axis, method=method)
        got = run(kind, tda, a, chunks, q, axis=axis, method=method)
        same(got, want, tolerance(dtype, method))
    if (kind, method, dtype) not in KNOWN_REFERENCE_FAULTS:
        ref = run(kind, jda, a, (4, 5), q, axis=1, method=method)
        want = run(kind, np, a, (4, 5), q, axis=1, method=method)
        np.testing.assert_allclose(ref, want, rtol=1e-6, equal_nan=True)


# the JAX package's quantiles that differ from numpy's values (beyond rtol
# 1e-6, for one q or both), the port pinning numpy: it refuses a complex
# median; it takes q in float64 where numpy takes a Python q in the data's
# float dtype (float16/float32 steps), and jnp's quantile formulas for the
# linear family and midpoint; its nan-kind discrete methods and midpoint
# land on other order statistics than numpy's (±inf where numpy gives NaN)
KNOWN_REFERENCE_FAULTS = {("median", None, "complex64")} | {
    ("quantile", m, "float16") for m in ("averaged_inverted_cdf", "weibull", "interpolated_inverted_cdf", "linear",
                                         "median_unbiased", "hazen", "midpoint", "normal_unbiased")} | {
    ("quantile", "linear", "float32"), ("quantile", "hazen", "float32"), ("quantile", "midpoint", "float32"),
    ("quantile", "midpoint", "float64")} | {
    ("nanquantile", m, dt) for m in ("closest_observation", "inverted_cdf", "midpoint", "nearest")
    for dt in ("float32", "float64")} | {("nanquantile", "linear", "float32"), ("nanquantile", "hazen", "float32")}


@pytest.mark.parametrize("kind, method, dtype", sorted(KNOWN_REFERENCE_FAULTS, key=str))
def test_known_reference_faults_are_real(kind, method, dtype):
    a = base(dtype)
    try:
        refs = [run(kind, jda, a, (4, 5), *([] if method is None else [q]), axis=1,
                    **({} if method is None else {"method": method})) for q in (0.3, [0.0, 0.25, 0.5, 1.0])]
    except ValueError:
        return  # refused
    wants = [run(kind, np, a, (4, 5), *([] if method is None else [q]), axis=1,
                 **({} if method is None else {"method": method})) for q in (0.3, [0.0, 0.25, 0.5, 1.0])]
    with pytest.raises(AssertionError):
        for r, w in zip(refs, wants):
            np.testing.assert_allclose(r, w, rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("q", [0.5, [0.1, 0.9]])
@pytest.mark.parametrize("axis, keepdims", [((0, 1), True), (-2, False), (None, True)])
def test_quantile_axes_and_keepdims(q, axis, keepdims):
    a = base("float64", shape=(5, 6, 4))
    for kind in ("quantile", "nanquantile"):
        want = run(kind, np, a, (2, 3, 4), q, axis=axis, keepdims=keepdims)
        same(run(kind, tda, a, (2, 3, 4), q, axis=axis, keepdims=keepdims), want, 1e-12)


def test_q_takes_numpys_dtype():
    a = base("float32", nan=False)
    x = tda.from_array(a, chunks=4)
    for q in (0.3, np.float64(0.3), [0.3], np.float32(0.3), np.array([0.2, 0.7])):
        assert tda.quantile(x, q, axis=0).dtype == np.quantile(a, q, axis=0).dtype
        same(tda.quantile(x, q, axis=0).compute(), np.quantile(a, q, axis=0), 1e-6)
    same(tda.quantile(tda.from_array(np.array([-128, 127], np.int8)), 0.5).compute(),
         np.quantile(np.array([-128, 127], np.int8), 0.5))  # numpy's difference wraps in int8


def test_nan_kind_takes_one_sync_and_all_nan_rows_give_nan():
    a = base("float64")
    a[2] = np.nan
    x = tda.from_array(a, chunks=(4, 5))
    _fancy_indexing.SYNCS = 0
    got = quiet(tda.nanquantile(x, [0.2, 0.8], axis=1).compute)
    assert _fancy_indexing.SYNCS == 1  # the counts of non-NaN values come up once
    same(got, quiet(np.nanquantile, a, [0.2, 0.8], axis=1), 1e-12)
    _fancy_indexing.SYNCS = 0
    same(quiet(tda.median(x, axis=0).compute), quiet(np.median, a, axis=0), 1e-12)
    same(quiet(tda.nanmedian(x, axis=1).compute), quiet(np.nanmedian, a, axis=1), 1e-12)
    assert _fancy_indexing.SYNCS == 1


def test_quantile_never_calls_torch_quantile(monkeypatch):
    """torch.quantile refuses more than 2**24 values: the port sorts and
    gathers instead."""
    def refuse(*args, **kwargs):
        raise AssertionError("torch.quantile called")

    monkeypatch.setattr(torch, "quantile", refuse)
    monkeypatch.setattr(torch, "nanquantile", refuse)
    monkeypatch.setattr(torch, "median", refuse)
    monkeypatch.setattr(torch, "nanmedian", refuse)
    a = base("float32")
    x = tda.from_array(a, chunks=4)
    for fn, args in ((tda.quantile, (0.4,)), (tda.nanquantile, ([0.1, 0.9],)), (tda.median, ()), (tda.nanmedian, ()),
                     (tda.percentile, (30,)), (tda.nanpercentile, (30,))):
        quiet(fn(x.ravel(), *args).compute)


def test_quantile_refusals():
    x = tda.from_array(base("float64"), chunks=4)
    with pytest.raises(ValueError, match="range"):
        tda.quantile(x, 1.5)
    with pytest.raises(ValueError, match="not a valid method"):
        tda.quantile(x, 0.5, method="nope")
    with pytest.raises(TypeError, match="real numbers"):
        tda.quantile(tda.from_array(base("complex64")), 0.5)
    with pytest.raises(TypeError):
        tda.quantile(tda.from_array(base("bool")), 0.5)
    with pytest.raises(NotImplementedError):
        tda.quantile(x, 0.5, weights=np.ones(12))
    with pytest.raises(ValueError, match="Percentiles"):
        tda.percentile(x[0], 150)


@pytest.mark.parametrize("dtype", ["float32", "float64", "int64"])
@pytest.mark.parametrize("q", [30, [5, 50, 95]])
def test_percentile(dtype, q):
    a = base(dtype, nan=False)
    flat = a.ravel()
    got = tda.percentile(tda.from_array(flat, chunks=13), q).compute()
    same(got, np.atleast_1d(np.percentile(flat, q)), tolerance(dtype))  # dask's 1-D result
    ref = jda.percentile(jda.from_array(flat, chunks=13), q).compute()
    np.testing.assert_allclose(ref, np.atleast_1d(np.percentile(flat, q)), rtol=1e-6)
    same(tda.percentile(tda.from_array(a, chunks=4), q, method="lower").compute(),
         np.percentile(a, q, method="lower"))
    b = base(dtype)
    same(quiet(tda.nanpercentile(tda.from_array(b, chunks=4), q, axis=0).compute),
         quiet(np.nanpercentile, b, q, axis=0), tolerance(dtype))
    if dtype != "int64":
        same(quiet(tda.nanpercentile(tda.from_array(b.ravel(), chunks=13), q).compute),
             quiet(np.nanpercentile, b.ravel(), q), tolerance(dtype))


@pytest.mark.parametrize("internal_method", ["dask", "tdigest"])
@pytest.mark.parametrize("method", ["linear", "lower", "higher", "midpoint", "nearest"])
@pytest.mark.parametrize("dtype", ["float64", "int32"])
def test_approx_percentile_is_the_jax_packages(internal_method, method, dtype):
    a = base(dtype, shape=(200,), nan=False)
    q = [0, 10, 50, 90, 100]
    got = tda.percentile(tda.from_array(a, chunks=30), q, method=method, internal_method=internal_method)
    ref = jda.percentile(jda.from_array(a, chunks=30), q, method=method, internal_method=internal_method)
    np.testing.assert_allclose(got.compute(), ref.compute(), rtol=1e-6)
    assert got.dtype == ref.dtype


def test_numpy_dispatch_reaches_the_quantiles():
    a = base("float64")
    x = tda.from_array(a, chunks=4)
    for fn, args, kw in ((np.median, (), {"axis": 1}), (np.nanmedian, (), {}), (np.quantile, (0.3,), {"axis": 0}),
                         (np.nanquantile, ([0.2, 0.4],), {"axis": 1}), (np.percentile, (20,), {"axis": 0}),
                         (np.nanpercentile, ([10, 90],), {})):
        out = fn(x, *args, **kw)
        assert isinstance(out, tda.Array), fn
        same(quiet(out.compute), quiet(fn, a, *args, **kw), 1e-12)
