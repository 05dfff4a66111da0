"""The second half of the routines through the port on the CPU: index math
(``ravel_multi_index``, ``unravel_index``), sorting and searching
(``searchsorted``, ``digitize``, ``isin``, ``unique``, ``union1d``,
``topk``/``argtopk``), statistics (``cov``, ``corrcoef``, ``gradient``),
``coarsen``/``aligned_coarsen_chunks``, ``apply_along_axis``/
``apply_over_axes``, and numpy's dispatch to them.

Each program runs on arrays made from a numpy seed (through ``from_array``)
over several chunkings, chunks of 1 and ragged last chunks among them,
through the port, the JAX package and numpy.  Callables are written once
per backend.  Tolerance: index, count, order and integer results equal
numpy's exactly, dtype and shape included (``unique``, ``searchsorted``,
``digitize``, ``isin``, ``topk``, the index math); ``cov``/``corrcoef``/
``gradient`` of float64 to rtol 1e-12, of float32 inputs (taken in
float64 by numpy) to rtol 1e-12 too, ``coarsen`` means of float32 to rtol
1e-6, float16 ``gradient`` to rtol 1e-3.  The JAX package is held to numpy
to rtol 1e-12 (1e-6 in float32) where numpy's result is a float; where it
differs from numpy (``KNOWN_REFERENCE_FAULTS``) the port pins numpy.
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

SHAPE = (9, 11)
CHUNKINGS = [(4, 5), (1, 3), (9, 11)]


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


def base(dtype="float64", seed=0, shape=SHAPE):
    """Data with ties (rounded), and NaN, ±inf and -0.0 in float dtypes."""
    rng = np.random.default_rng(seed)
    a = np.round(rng.standard_normal(shape) * 6, 1)
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return a > 0
    if dt.kind in "fc":
        a.ravel()[:5] = [np.nan, np.inf, -0.0, 2.5, -np.inf]
        if dt.kind == "c":
            a = a + 1j * np.round(rng.standard_normal(shape) * 3)
            a.ravel()[5] = complex(1.0, np.nan)
    if dt.kind == "u":
        a = np.abs(a)
    return a.astype(dt)


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


def value(out):
    if isinstance(out, (tuple, list)):
        return type(out)(value(o) for o in out)
    return out.compute() if hasattr(out, "compute") else out


class _Numpy:
    """numpy, with ``topk`` (which numpy lacks) from its sort: the k
    largest, largest first; for k < 0 the smallest, smallest first."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def topk(a, k, axis=-1):
        srt = np.sort(a, axis=axis)
        n = a.shape[axis]
        if k < 0:
            return np.take(srt, range(-k), axis=axis)
        return np.flip(np.take(srt, range(n - k, n), axis=axis), axis=axis)


NP = _Numpy()


def lazy(mod, a, chunks=4):
    return np.asarray(a) if mod is NP else mod.from_array(np.asarray(a), chunks=chunks)


def run(prog, mod, a, chunks):
    x = a if mod is NP else mod.from_array(a, chunks=chunks)
    return value(quiet(prog, x, mod, a))


def ints(a):
    return np.nan_to_num(a, posinf=0, neginf=0)


def sorted_edges(a):
    return np.sort(a.ravel())[::5]


# name -> (program of (x, module, the numpy data), dtypes, rtol)
PROGRAMS = {
    "searchsorted_left": (lambda x, m, a: m.searchsorted(lazy(m, sorted_edges(a)), x),
                          ["float32", "float64", "int8", "int64", "uint8", "uint64", "bool", "complex64"], 0),
    "searchsorted_right": (lambda x, m, a: m.searchsorted(lazy(m, sorted_edges(a)), x, side="right"),
                           ["float16", "float64", "int32", "uint64", "complex64"], 0),
    "searchsorted_sorter": (lambda x, m, a: m.searchsorted(lazy(m, a.ravel()[:20]), x, sorter=lazy(
        m, np.argsort(a.ravel()[:20], kind="stable"))), ["float64", "int32"], 0),
    "digitize": (lambda x, m, a: m.digitize(x, [-5, -1, 0, 0.5, 3]), ["float32", "float64", "int8", "int64",
                                                                     "uint8", "bool"], 0),
    "digitize_right": (lambda x, m, a: m.digitize(x, [-5, -1, 0, 0.5, 3], right=True), ["float64", "int32"], 0),
    "digitize_decreasing": (lambda x, m, a: m.digitize(x, [3, 0.5, 0, -5]), ["float64", "int32"], 0),
    "digitize_decreasing_right": (lambda x, m, a: m.digitize(x, [3, 0, 0, -5], right=True), ["float32"], 0),
    "isin": (lambda x, m, a: m.isin(x, [0, 2.5, -0.0, np.nan, np.inf, 3]),
             ["float16", "float32", "float64", "int8", "int64", "uint8", "uint64", "bool", "complex64"], 0),
    "isin_invert": (lambda x, m, a: m.isin(x, [0, 1, 2], invert=True), ["float64", "int32"], 0),
    "isin_lazy": (lambda x, m, a: m.isin(x, lazy(m, a.ravel()[::9])), ["float64", "int32", "uint64", "complex64"], 0),
    "unique": (lambda x, m, a: m.unique(x), ["float16", "float32", "float64", "int8", "int32", "int64", "uint8",
                                            "uint64", "bool", "complex64"], 0),
    "unique_all": (lambda x, m, a: m.unique(x, return_index=True, return_inverse=True, return_counts=True),
                   ["float64", "int8", "uint64", "bool"], 0),
    "union1d": (lambda x, m, a: m.union1d(x, x[:3] * 2), ["float64", "int32", "uint8"], 0),
    "topk": (lambda x, m, a: m.topk(x, 3, axis=1), ["float16", "float32", "float64", "int8", "int64", "uint8",
                                                     "uint64", "bool"], 0),
    "topk_axis0": (lambda x, m, a: m.topk(x, 4, axis=0), ["float32", "int32"], 0),
    "topk_negative": (lambda x, m, a: m.topk(x, -3, axis=1), ["float32", "float64", "int8", "int64", "uint8",
                                                               "uint64"], 0),
    "topk_method": (lambda x, m, a: (m.topk if m is NP else type(x).topk)(x, 2, axis=-1), ["float64"], 0),
    "ravel_multi_index": (lambda x, m, a: m.ravel_multi_index(
        (lazy(m, (np.abs(ints(a[:, :4])) % 3).astype(np.int64)), lazy(m, (np.abs(ints(a[:, 4:8])) % 5).astype(np.int64))),
        (3, 5)), ["float64"], 0),
    "ravel_multi_index_F": (lambda x, m, a: m.ravel_multi_index(
        (lazy(m, (np.abs(ints(a[:, :4])) % 3).astype(np.int32)), lazy(m, (np.abs(ints(a[:, 4:8])) % 5).astype(np.int32))),
        (3, 5), order="F"), ["float64"], 0),
    "ravel_multi_index_wrap": (lambda x, m, a: m.ravel_multi_index(
        (lazy(m, ints(a[:, :4]).astype(np.int64)), lazy(m, ints(a[:, 4:8]).astype(np.int64))), (3, 5), mode="wrap"),
        ["float64"], 0),
    "ravel_multi_index_clip_F": (lambda x, m, a: m.ravel_multi_index(
        (lazy(m, ints(a[:, :4]).astype(np.int64)), lazy(m, ints(a[:, 4:8]).astype(np.int64))), (3, 5), mode="clip",
        order="F"), ["float64"], 0),
    "unravel_index": (lambda x, m, a: m.unravel_index(lazy(m, (np.abs(ints(a)) * 7).astype(np.int64) % 60), (3, 4, 5)),
                      ["float64"], 0),
    "unravel_index_F": (lambda x, m, a: m.unravel_index(lazy(m, (np.abs(ints(a)) * 7).astype(np.int32) % 60), (4, 15),
                                                        order="F"), ["float64"], 0),
    "cov": (lambda x, m, a: m.cov(x), ["float32", "float64", "int32", "complex64"], 1e-12),
    "cov_rowvar_bias": (lambda x, m, a: m.cov(x, rowvar=False, bias=True), ["float64"], 1e-12),
    "cov_ddof_y": (lambda x, m, a: m.cov(x[:4], x[4:8], ddof=2), ["float64"], 1e-12),
    "cov_fweights": (lambda x, m, a: m.cov(x, fweights=np.arange(11) % 3 + 1), ["float64"], 1e-12),
    "cov_aweights": (lambda x, m, a: m.cov(x, aweights=np.linspace(0.5, 2, 11)), ["float64", "float32"], 1e-12),
    "cov_both_weights": (lambda x, m, a: m.cov(x, fweights=np.arange(11) % 2 + 1, aweights=np.linspace(0.5, 2, 11),
                                               ddof=1), ["float64"], 1e-12),
    "cov_1d": (lambda x, m, a: m.cov(x[0]), ["float64"], 1e-12),
    "corrcoef": (lambda x, m, a: m.corrcoef(x), ["float32", "float64"], 1e-12),
    "corrcoef_y": (lambda x, m, a: m.corrcoef(x[:3], x[3:5], rowvar=True), ["float64"], 1e-12),
    "gradient": (lambda x, m, a: m.gradient(x), ["float32", "float64", "int8", "int64", "uint8", "complex64"],
                 1e-12),
    "gradient_float16": (lambda x, m, a: m.gradient(x, axis=1), ["float16"], 1e-3),
    "gradient_spacing": (lambda x, m, a: m.gradient(x, 0.5, 2.0), ["float32", "float64"], 1e-12),
    "gradient_edge2": (lambda x, m, a: m.gradient(x, axis=1, edge_order=2), ["float32", "float64", "int32"], 1e-12),
    "gradient_coords": (lambda x, m, a: m.gradient(x, np.cumsum(np.arange(1.0, 12.0) ** 0.5), axis=1), ["float64"],
                        1e-12),
    "gradient_coords_edge2": (lambda x, m, a: m.gradient(x, np.array([0, 1, 3, 4, 7, 8, 9, 13, 15]), axis=0,
                                                         edge_order=2), ["float64", "float32"], 1e-12),
}

CASES = [(name, dt, ch) for name, (_, dts, _) in sorted(PROGRAMS.items()) for dt in dts for ch in CHUNKINGS]

# the JAX package's results that differ from numpy's, the port pinning
# numpy: cov/corrcoef of float32 and complex64 in the input's precision
# where numpy takes float64/complex128, cov of a 1-D array not squeezed to
# 0-d; topk with k < 0 negates (wrong for unsigned data); complex gradient
# through jnp's complex division (numpy's spoils both parts of a value with
# a NaN part); float32 gradient on coordinates taken in float32 (numpy:
# float64 coefficients); searchsorted of complex values with a NaN part out
# of numpy's order
KNOWN_REFERENCE_FAULTS = {
    "cov": {"float32", "complex64"}, "corrcoef": {"float32"}, "cov_1d": {"float64"},
    "topk_negative": {"uint8", "uint64"},
    "gradient": {"complex64"}, "gradient_coords_edge2": {"float32"},
    "searchsorted_left": {"complex64"}, "searchsorted_right": {"complex64"},
}


def _reference_ok(name, dtype):
    return dtype not in KNOWN_REFERENCE_FAULTS.get(name, ())


@pytest.mark.parametrize("name, dtype, chunks", CASES)
def test_routine(name, dtype, chunks):
    prog, _, rtol = PROGRAMS[name]
    a = base(dtype)
    want = run(prog, NP, a, chunks)
    got = run(prog, tda, a, chunks)
    pairs = zip(got, want) if isinstance(want, (tuple, list)) else [(got, want)]
    for g, w in pairs:
        same(np.ravel(g) if name == "unique_all" else g, np.ravel(w) if name == "unique_all" else w, rtol)
    if chunks != CHUNKINGS[0] or not _reference_ok(name, dtype):
        return
    ref = run(prog, jda, a, chunks)
    pairs = zip(ref, want) if isinstance(want, (tuple, list)) else [(ref, want)]
    for r, w in pairs:
        w = np.ravel(w) if name == "unique_all" else w
        tol = rtol or (1e-12 if np.asarray(w).dtype.kind in "fc" else 0)
        same(np.ravel(r) if name == "unique_all" else r, w, 1e-6 if tol and dtype == "float32" else tol)


@pytest.mark.parametrize("name, dtype", sorted((n, d) for n, dts in KNOWN_REFERENCE_FAULTS.items() for d in dts))
def test_known_reference_faults_are_real(name, dtype):
    """Each listed case does differ from numpy in the JAX package (the
    list stays true)."""
    prog, _, rtol = PROGRAMS[name]
    a = base(dtype)
    want = run(prog, NP, a, CHUNKINGS[0])
    ref = run(prog, jda, a, CHUNKINGS[0])
    with pytest.raises(AssertionError):
        for r, w in zip(ref, want) if isinstance(want, (tuple, list)) else [(ref, want)]:
            same(r, w, 1e-6 if rtol and dtype == "float32" else rtol)


@pytest.mark.parametrize("k, axis", [(3, 1), (-4, 0), (11, 1), (-1, 1)])
@pytest.mark.parametrize("dtype", ["float32", "int64", "uint64"])
def test_argtopk_selects_numpys_values(k, axis, dtype):
    """Ties have no fixed order: the values at the returned indices must be
    numpy's sorted values; distinct values give numpy's indices."""
    a = base(dtype)
    idx = tda.argtopk(tda.from_array(a, chunks=(4, 5)), k, axis=axis).compute()
    assert idx.dtype == np.intp
    srt = np.sort(a, axis=axis)
    want = np.flip(np.take(srt, range(a.shape[axis] - k, a.shape[axis]), axis=axis), axis=axis) if k > 0 else \
        np.take(srt, range(-k), axis=axis)
    same(np.take_along_axis(a, idx, axis=axis), want)
    distinct = np.random.default_rng(3).permutation(99).reshape(SHAPE).astype(dtype)
    idx = tda.from_array(distinct, chunks=(1, 3)).argtopk(k, axis=axis).compute()
    order = np.argsort(distinct, axis=axis)
    want = np.flip(np.take(order, range(a.shape[axis] - k, a.shape[axis]), axis=axis), axis=axis) if k > 0 else \
        np.take(order, range(-k), axis=axis)
    same(idx, want)
    ref = jda.argtopk(jda.from_array(distinct, chunks=(4, 5)), k, axis=axis).compute()
    if k > 0 or dtype != "uint64":
        same(ref, want)


@pytest.mark.parametrize("data, k, want", [
    (np.array([5, 0, 7, 2, 9], np.uint32), -2, [0, 2]),
    (np.array([-128, 5, -3, 127], np.int8), -2, [-128, -3]),
    (np.array([1.0, np.nan, -1.0, 3.0]), 2, [np.nan, 3.0]),
    (np.array([1.0, np.nan, -1.0, 3.0]), -2, [-1.0, 1.0]),
    (np.array([2**64 - 1, 2**63, 1, 0], np.uint64), -3, [0, 1, 2**63]),
])
def test_topk_keeps_numpys_order(data, k, want):
    """k < 0 is the smallest values, never a negation; NaN is the largest."""
    got = tda.topk(tda.from_array(data, chunks=2), k).compute()
    same(got, np.array(want, dtype=data.dtype))


@pytest.mark.parametrize("chunks", [1, 3, 50])
def test_unique_of_nans_and_zeros_and_its_sync(chunks):
    a = np.array([np.nan, 1.0, -0.0, np.nan, 0.0, 2.0, 1.0, np.nan] * 6 + [np.inf, -np.inf])
    x = tda.from_array(a, chunks=chunks)
    outs = tda.unique(x, return_index=True, return_inverse=True, return_counts=True)
    assert all(np.isnan(o.shape[0]) for i, o in enumerate(outs) if i != 2) and outs[2].shape == (50,)
    _fancy_indexing.SYNCS = 0
    got = tda.compute(*outs)
    assert _fancy_indexing.SYNCS == 1  # the outputs share one sort and one sync
    want = np.unique(a, return_index=True, return_inverse=True, return_counts=True)
    for g, w in zip(got, want):
        same(np.ravel(g), np.ravel(w))
    assert np.isnan(np.unique(a)[-1]) and len(got[0]) == 6


def test_unique_of_complex_is_numpys_order():
    a = np.array([1 + 2j, complex(np.nan, 1), 1 + 1j, complex(1, np.nan), 0 + 5j, 1 + 1j,
                  complex(np.nan, np.nan), complex(2, np.nan)], np.complex128)
    got = tda.unique(tda.from_array(a, chunks=3), return_counts=True)
    want = np.unique(a, return_counts=True)
    for g, w in zip(got, want):
        same(value(g), w)


def test_searchsorted_sorter_is_checked_before_the_gather():
    x = tda.from_array(np.arange(5.0), chunks=2)
    bad = tda.from_array(np.array([0, 1, 2, 3, 7]), chunks=2)
    with pytest.raises(ValueError, match="Sorter index out of range"):
        tda.searchsorted(x, tda.from_array(np.array([1.5])), sorter=bad).compute()
    with pytest.raises(ValueError, match="1-D"):
        tda.searchsorted(tda.ones((2, 2), chunks=1), x)


def test_digitize_refuses_as_numpy_does():
    x = tda.from_array(np.arange(5.0), chunks=2)
    with pytest.raises(ValueError, match="monotonically"):
        tda.digitize(x, [0, 3, 1])
    with pytest.raises(TypeError):
        tda.digitize(tda.from_array(np.ones(3, complex)), [0, 1])


def test_ravel_multi_index_raise_checks_on_the_device_then_computes():
    coords = (tda.from_array(np.array([0, 2, 3]), chunks=2), tda.from_array(np.array([1, 1, 0]), chunks=2))
    _fancy_indexing.SYNCS = 0
    with pytest.raises(ValueError, match="invalid entry in coordinates array"):
        tda.ravel_multi_index(coords, (3, 4)).compute()
    assert _fancy_indexing.SYNCS == 1
    ok = (tda.from_array(np.array([0, 2, 1]), chunks=2), coords[1])
    same(tda.ravel_multi_index(ok, (3, 4)).compute(), np.ravel_multi_index(([0, 2, 1], [1, 1, 0]), (3, 4)))
    with pytest.raises(TypeError, match="only int indices"):
        tda.ravel_multi_index((tda.from_array(np.ones(3)),), (3,))
    stacked = tda.from_array(np.array([[0, 2, 1], [1, 1, 0]]), chunks=1)
    same(tda.ravel_multi_index(stacked, (3, 4)).compute(), np.ravel_multi_index(([0, 2, 1], [1, 1, 0]), (3, 4)))


def test_unravel_index_raises_numpys_error():
    with pytest.raises(ValueError, match="out of bounds"):
        tda.unravel_index(tda.from_array(np.array([3, 12]), chunks=1), (3, 4))[0].compute()
    _fancy_indexing.SYNCS = 0
    tda.compute(*tda.unravel_index(tda.from_array(np.array([3, 11]), chunks=1), (3, 4)))
    assert _fancy_indexing.SYNCS == 1  # the coordinates share one check
    assert tda.unravel_index(tda.from_array(np.array([], np.int64)), (3, 4))[0].compute().shape == (0,)
    same(tda.unravel_index(tda.from_array(np.array(7)), (3, 4))[1].compute(), np.unravel_index(7, (3, 4))[1])


def test_bincount_and_unique_take_one_sync_each():
    x = tda.from_array(np.array([3, 1, 4, 1, 5]), chunks=2)
    _fancy_indexing.SYNCS = 0
    tda.bincount(x).compute()
    assert _fancy_indexing.SYNCS == 1
    _fancy_indexing.SYNCS = 0
    tda.unique(x).compute()
    assert _fancy_indexing.SYNCS == 1


@pytest.mark.parametrize("chunks, multiple", [((4, 4, 4), 2), ((5, 7, 3), 4), ((10,), 3), ((1, 1, 1, 9), 2),
                                              ((6, 6, 6, 6), 6)])
def test_aligned_coarsen_chunks(chunks, multiple):
    got = tda.aligned_coarsen_chunks(chunks, multiple)
    assert got == jda.aligned_coarsen_chunks(chunks, multiple)
    assert sum(got) == sum(chunks)
    assert all(c % multiple == 0 for c in got[:-1])


COARSEN = [
    ("mean", np.mean, "float32", 1e-6), ("mean", np.mean, "float64", 1e-12), ("sum", np.sum, "int8", 0),
    ("sum", np.sum, "uint8", 0), ("max", np.max, "float64", 0), ("min", np.min, "int32", 0),
    ("amax", np.amax, "uint64", 0), ("nanmean", np.nanmean, "float64", 1e-12), ("prod", np.prod, "int16", 0),
    ("any", np.any, "bool", 0), ("nanmax", np.nanmax, "float32", 0), ("sum", np.sum, "bool", 0),
]


@pytest.mark.parametrize("name, fn, dtype, rtol", COARSEN)
@pytest.mark.parametrize("chunks", [(4, 5), (2, 12), (1, 3)])
def test_coarsen(name, fn, dtype, rtol, chunks):
    a = base(dtype, shape=(8, 12))
    want = quiet(fn, a.reshape(4, 2, 3, 4), axis=(1, 3))
    got = quiet(tda.coarsen(fn, tda.from_array(a, chunks=chunks), {0: 2, 1: 4}).compute)
    same(got, want, rtol)
    if chunks == (4, 5) and dtype not in ("uint64", "int16", "bool"):
        ref = quiet(jda.coarsen(fn, jda.from_array(a, chunks=chunks), {0: 2, 1: 4}).compute)
        same(ref, want, rtol or (1e-6 if dtype == "float32" else 0))


def test_coarsen_trim_excess_and_refusals():
    a = base("float64", shape=(9, 11))
    got = tda.coarsen(np.sum, tda.from_array(a, chunks=4), {0: 2, 1: 3}, trim_excess=True).compute()
    same(got, a[:8, :9].reshape(4, 2, 3, 3).sum(axis=(1, 3)), 1e-12)
    with pytest.raises(ValueError, match="does not divide"):
        tda.coarsen(np.sum, tda.from_array(a, chunks=4), {0: 2})
    with pytest.raises(NotImplementedError):
        tda.coarsen(np.median, tda.from_array(a, chunks=4), {0: 3})
    got = tda.coarsen(tda.sum, tda.from_array(a, chunks=4), {0: 3}, dtype=np.float32).compute()
    same(got, a.reshape(3, 3, 11).sum(axis=1, dtype=np.float32), 1e-6)


# apply_along_axis: (name, torch, jnp, numpy functions of a 1-D slice, dtypes)
APPLY = [
    ("sum", lambda r: torch.sum(r), lambda r: r.sum(), np.sum, ["float64", "int32"]),
    ("range", lambda r: r.max() - r.min(), lambda r: r.max() - r.min(), lambda r: r.max() - r.min(), ["float32"]),
    ("head", lambda r: r[:3] * 2, lambda r: r[:3] * 2, lambda r: r[:3] * 2, ["float64", "int64"]),
    ("outer", lambda r: torch.outer(r[:2], r[:3]), None, lambda r: np.outer(r[:2], r[:3]), ["float64"]),
]


@pytest.mark.parametrize("name, tfn, jfn, nfn, dtypes", APPLY)
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_apply_along_axis(name, tfn, jfn, nfn, dtypes, axis):
    import jax.numpy as jnp

    for dtype in dtypes:
        a = np.nan_to_num(base(dtype), posinf=9, neginf=-9)
        want = np.apply_along_axis(nfn, axis, a)
        got = tda.apply_along_axis(tfn, axis, tda.from_array(a, chunks=(4, 5))).compute()
        same(got, want, 1e-12 if want.dtype.kind == "f" else 0)
        if jfn is not None:
            ref = jda.apply_along_axis(jfn, axis, jda.from_array(a, chunks=(4, 5))).compute()
            np.testing.assert_allclose(ref, want, rtol=1e-6)
        assert jnp is not None


# apply_along_axis of numpy's unsigned integers: (name, torch, numpy function
# of a 1-D slice, which the JAX package also runs)
APPLY_UNSIGNED = [
    ("double", lambda r: r * 2, lambda r: r * 2),
    ("add", lambda r: r + r[0], lambda r: r + r[0]),
    ("range", lambda r: r.amax() - r.amin(), lambda r: r.max() - r.min()),
    ("sum", lambda r: r.sum(), np.sum),
    ("cumsum", lambda r: r.cumsum(0), np.cumsum),
    ("mean", lambda r: r.double().mean(), lambda r: r.astype(np.float64).mean()),
]


@pytest.mark.parametrize("name, tfn, nfn", APPLY_UNSIGNED)
@pytest.mark.parametrize("dtype", ["uint16", "uint32", "uint64"])
def test_apply_along_axis_of_unsigned_integers(name, tfn, nfn, dtype):
    """numpy's result dtype: an unsigned operand stays unsigned (its sums
    uint64), values past the signed range included."""
    rng = np.random.default_rng(12)
    a = rng.integers(0, np.iinfo(dtype).max // 16, (9, 11), dtype=np.uint64, endpoint=True).astype(dtype)
    want = np.apply_along_axis(nfn, 1, a)
    got = tda.apply_along_axis(tfn, 1, tda.from_array(a, chunks=(4, 5))).compute()
    same(got, want, 1e-12 if want.dtype.kind == "f" else 0)
    ref = jda.apply_along_axis(nfn, 1, jda.from_array(a, chunks=(4, 5))).compute()  # numpy's functions take jnp
    same(np.asarray(ref), want, 1e-12 if want.dtype.kind == "f" else 0)


def test_apply_along_axis_loops_where_vmap_refuses():
    """``.item()`` cannot run under vmap: the rows are looped on the same
    device."""
    a = base("float64", shape=(5, 4))
    got = tda.apply_along_axis(lambda r: torch.tensor(float(r[0].item()) * 2, dtype=r.dtype), 1,
                               tda.from_array(a, chunks=2), dtype=np.float64, shape=()).compute()
    same(got, a[:, 0] * 2)


@pytest.mark.parametrize("axes", [0, [0, 1], (1,)])
def test_apply_over_axes(axes):
    a = base("float64")
    x = tda.from_array(a, chunks=(4, 5))
    same(tda.apply_over_axes(tda.sum, x, axes).compute(), np.apply_over_axes(np.sum, a, axes), 1e-12)
    ref = jda.apply_over_axes(jda.sum, jda.from_array(a, chunks=(4, 5)), axes).compute()
    same(ref, np.apply_over_axes(np.sum, a, axes), 1e-12)


def test_gradient_refusals():
    x = tda.from_array(base("float64"), chunks=4)
    with pytest.raises(TypeError):
        tda.gradient(tda.from_array(np.ones(4, bool)))
    with pytest.raises(ValueError, match="too small"):
        tda.gradient(x[:2], axis=0, edge_order=2)
    with pytest.raises(TypeError, match="invalid number of arguments"):
        tda.gradient(x, 1.0, 2.0, 3.0)
    with pytest.raises(ValueError, match="match the length"):
        tda.gradient(x, np.arange(3.0), axis=0)


def test_cov_refusals_and_weights_checks():
    x = tda.from_array(base("float64"), chunks=4)
    with pytest.raises(ValueError, match="more than 2"):
        tda.cov(tda.ones((2, 2, 2), chunks=1))
    with pytest.raises(TypeError, match="fweights must be integer"):
        tda.cov(x, fweights=np.full(11, 0.5))
    with pytest.raises(ValueError, match="aweights cannot be negative"):
        tda.cov(x, aweights=-np.ones(11))
    with pytest.raises(RuntimeError, match="incompatible"):
        tda.cov(x, fweights=np.ones(3, int))
    lazy_w = tda.from_array(np.arange(11) % 3 + 1, chunks=4)
    same(tda.cov(x, fweights=lazy_w).compute(), np.cov(base("float64"), fweights=np.arange(11) % 3 + 1), 1e-12)


def test_numpy_dispatch_reaches_the_second_half():
    a = base("float32")
    x = tda.from_array(a, chunks=(4, 5))
    for fn, args, kwargs in ((np.unique, (x,), {}), (np.median, (x,), {"axis": 0}), (np.isin, (x, [0, 2.5]), {}),
                             (np.cov, (x,), {}), (np.corrcoef, (x,), {}), (np.digitize, (x, [0, 1]), {}),
                             (np.quantile, (x, 0.25), {}), (np.nanmedian, (x,), {}),
                             (np.searchsorted, (tda.from_array(np.arange(5.0)), x), {})):
        out = fn(*args, **kwargs)
        assert isinstance(out, tda.Array), fn
        np_args = [np.arange(5.0) if isinstance(v, tda.Array) and v is not x else (a if v is x else v) for v in args]
        same(value(out), quiet(fn, *np_args, **kwargs), 1e-6 if value(out).dtype.kind == "f" else 0)
    for g, w in zip(np.gradient(x), np.gradient(a)):
        same(value(g), w, 1e-6)
    same(value(np.bincount(tda.from_array(np.array([0, 3, 3])))), np.bincount([0, 3, 3]))
    same(value(np.apply_along_axis(lambda r: r.sum(), 0, x)), np.apply_along_axis(np.sum, 0, a), 1e-5)
    same(value(np.unravel_index(tda.from_array(np.array([5, 7])), (3, 4))[0]), np.unravel_index([5, 7], (3, 4))[0])


NINTH_SLICE = ("aligned_coarsen_chunks apply_along_axis apply_gufunc apply_over_axes argtopk as_gufunc bincount "
               "coarsen corrcoef cov digitize gradient gufunc histogram histogram2d histogramdd isin median nanmedian "
               "nanpercentile nanquantile percentile quantile ravel_multi_index searchsorted shuffle topk union1d "
               "unique unravel_index").split()


def test_the_slices_names_exist_and_22_are_left():
    import types

    for name in NINTH_SLICE:
        assert name in tda.__all__ and callable(getattr(tda, name)), name
    public = [n for n in dir(jda) if not n.startswith("_") and not isinstance(getattr(jda, n), types.ModuleType)]
    missing = sorted(n for n in public if not hasattr(tda, n))
    # svd_compressed, then the IO names and barrier, then the diagnostics
    # and register_chunk_type have since been ported: none is left
    assert missing == []
    from dask_array_tpu_torch import chunk, routines

    assert routines.unique is tda.unique and chunk.topk is not None


def test_uint64_above_2_63_sorts_unsigned():
    """uint64 blocks are int64 bits: sort, search, unique and quantiles
    compare them unsigned."""
    a = np.array([2**64 - 1, 3, 2**63, 2**63 + 7, 0, 3, 2**63, 12], np.uint64)
    x = tda.from_array(a, chunks=3)
    for got, want in ((tda.unique(x, return_counts=True), np.unique(a, return_counts=True)),
                      (tda.searchsorted(tda.from_array(np.sort(a), chunks=4), x, side="right"),
                       np.searchsorted(np.sort(a), a, side="right")),
                      (tda.median(x), np.median(a)), (tda.quantile(x, [0.25, 0.9], method="lower"),
                                                      np.quantile(a, [0.25, 0.9], method="lower")),
                      (tda.isin(x, np.array([2**63, 5], np.uint64)), np.isin(a, np.array([2**63, 5], np.uint64)))):
        for g, w in zip(got, want) if isinstance(want, tuple) else [(got, want)]:
            same(value(g), w)
