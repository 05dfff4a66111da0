"""The port's reductions against the JAX package and numpy.

The same inputs, made from a numpy seed, go through ``dask_array_tpu`` and
``dask_array_tpu_torch`` on a ragged 37x53 grid with chunks (10, 16);
numpy is the tie-breaker.  Every typed kind x {float32, float64, int32,
bool} x axis {None, 0, 1, (0, 1)} x keepdims; the moments with ddof 0 and
1; the arg and cumulative reductions and their dtypes; the generic
``reduction()`` tree with user functions; ``split_every`` changing nothing.

Tolerances: float64 rtol 1e-12; float32 rtol 1e-5 for elementwise-sized
results and 1e-4 for moments, each with an atol of 2^-20 times the sum of
|x| along the reduced axes (f32 sums taken in different orders differ by
about n * eps * sum|x| at worst).  Integers and bools are exact.
"""

import functools
import warnings

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu_torch import config as tconfig

torch.set_num_threads(1)

SHAPE = (37, 53)
CHUNKS = (10, 16)
DTYPES = ["float32", "float64", "int32", "bool"]
AXES = [None, 0, 1, (0, 1)]
KINDS = ["sum", "prod", "min", "max", "any", "all", "mean",
         "nansum", "nanprod", "nanmin", "nanmax", "nanmean"]


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


@functools.lru_cache(maxsize=None)
def data(dtype, kind="sum", nan=False):
    """The seeded input for one dtype (values near 1 for products, small
    integers with few 2s so int64 products stay exact)."""
    rng = np.random.default_rng(sum(map(ord, dtype + kind)))
    if dtype == "bool":
        return rng.random(SHAPE) < 0.9
    if dtype == "int32":
        if "prod" in kind:
            return rng.choice(np.array([1, -1, 1, 2], dtype="i4"), size=SHAPE, p=[0.6, 0.39, 0.005, 0.005])
        return rng.integers(-5, 6, size=SHAPE).astype("i4")
    x = rng.standard_normal(SHAPE)
    if "prod" in kind:
        x = 1 + 0.01 * x
    x = x.astype(dtype)
    if nan:
        x[rng.random(SHAPE) < 0.1] = np.nan
        x[:, 3] = np.nan  # an all-NaN column
    return x


def tol(dtype, x, axis, moment=False):
    """The tolerance for a result of ``dtype`` reduced from ``x``."""
    if np.dtype(dtype).kind not in "fc":
        return dict(rtol=0, atol=0)
    if np.dtype(dtype) == np.float64:
        return dict(rtol=1e-12, atol=1e-12 * float(np.nansum(np.abs(x.astype("f8")))))
    scale = np.nansum(np.abs(x.astype("f8")), axis=axis)
    return dict(rtol=1e-4 if moment else 1e-5, atol=2.0**-20 * float(np.max(scale)))


def numpy_ref(fn, x, **kw):
    with warnings.catch_warnings(), np.errstate(all="ignore"):
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.asarray(fn(x, **kw))


def close(got, want, **tolerance):
    assert got.shape == want.shape
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got.astype("f8"), want.astype("f8"), equal_nan=True, **tolerance)


@functools.lru_cache(maxsize=None)
def jax_results(kind, dtype):
    """The JAX package's results for every axis x keepdims, computed in
    one program (numpy arrays)."""
    x = data(dtype, kind, kind.startswith("nan"))
    a = jda.from_array(x, chunks=CHUNKS)
    outs = [getattr(jda, kind)(a, axis=ax, keepdims=kd) for ax in AXES for kd in (False, True)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        vals = jda.compute(*outs)
    return {(str(ax), kd): np.asarray(v) for (ax, kd), v in zip(
        [(ax, kd) for ax in AXES for kd in (False, True)], vals)}


# ---------------------------------------------------------------------------
# typed reductions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("axis", AXES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_typed_reduction(kind, dtype, axis, keepdims):
    x = data(dtype, kind, kind.startswith("nan"))
    want = numpy_ref(getattr(np, kind), x, axis=axis, keepdims=keepdims)
    got_arr = getattr(tda, kind)(tda.from_array(x, chunks=CHUNKS), axis=axis, keepdims=keepdims)
    assert got_arr.dtype == want.dtype
    assert got_arr.shape == want.shape
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = np.asarray(got_arr.compute())
    assert got.dtype == want.dtype
    t = tol(want.dtype, x, axis)
    close(got, want, **t)
    close(got, jax_results(kind, dtype)[(str(axis), keepdims)].astype(want.dtype), **t)


def test_result_dtypes_follow_numpy():
    i = tda.from_array(np.arange(12, dtype="i4").reshape(3, 4), chunks=2)
    b = tda.from_array(np.ones((3, 4), bool), chunks=2)
    assert i.mean().dtype == np.float64 and i.mean().compute().dtype == np.float64
    assert i.sum().dtype == np.int64 and b.sum().dtype == np.int64 and b.prod().dtype == np.int64
    assert tda.nansum(i).dtype == np.int64
    assert tda.nanmax(i).dtype == np.int32 and tda.nanmean(i).dtype == np.float64
    assert i.cumsum(axis=1).dtype == np.int64 and i.cumsum(axis=1).compute().dtype == np.int64
    assert i.sum(dtype="i2").compute().dtype == np.int16
    np.testing.assert_array_equal(i.mean(axis=0, dtype="i4").compute(), np.mean(np.arange(12).reshape(3, 4), axis=0, dtype="i4"))
    h = tda.from_array(np.full((64, 64), 256.0, dtype="f2"), chunks=16)
    # float16 sums accumulate in float32: 64*64*256 = 2^20 is exact there
    assert h.sum().dtype == np.float16
    assert float(h.sum(axis=0).compute()[0]) == 64 * 256.0


def test_empty_reductions():
    e = tda.from_array(np.zeros((0, 4), "f4"), chunks=2)
    np.testing.assert_array_equal(e.sum(axis=0).compute(), np.zeros(4, "f4"))
    np.testing.assert_array_equal(e.prod(axis=0).compute(), np.ones(4, "f4"))
    for kind in ("min", "max", "nanmin", "nanmax"):
        with pytest.raises(ValueError):
            getattr(tda, kind)(e, axis=0).compute()
    with pytest.raises(ValueError):
        e.argmax(axis=0).compute()
    assert e.any().compute() == np.False_ and e.all().compute() == np.True_


def test_split_every_is_canonical_and_changes_nothing():
    x = data("float32")
    a = tda.from_array(x, chunks=CHUNKS)
    want = a.sum(axis=(0, 1)).compute()
    for se in (None, 2, 4, {0: 2, 1: 3}):
        assert a.sum(axis=(0, 1), split_every=se).compute() == want
    assert a.sum(split_every=4).name == a.sum(split_every={0: 2, 1: 2}).name
    assert a.sum(split_every=4).name != a.sum().name


def test_reduction_slice_pushdown():
    x = data("float64")
    a = tda.from_array(x, chunks=CHUNKS)
    r = a.sum(axis=0)[5:20]
    plan = r.optimize().expr.tree_repr()
    assert "Slice" not in plan.split("\n")[0]
    np.testing.assert_allclose(r.compute(), x.sum(axis=0)[5:20], rtol=1e-12)
    np.testing.assert_allclose(a.mean(axis=1)[7].compute(), x.mean(axis=1)[7], rtol=1e-12)


# ---------------------------------------------------------------------------
# moments: the one-pass shifted power sums
# ---------------------------------------------------------------------------


MOMENT_KINDS = ["var", "std", "nanvar", "nanstd"]


@functools.lru_cache(maxsize=None)
def moment_data(dtype, kind):
    x = data(dtype, kind, kind.startswith("nan"))
    if dtype in ("float32", "float64"):
        x = x + 100  # a large mean: the shift keeps the cancellation benign
    return x


@functools.lru_cache(maxsize=None)
def jax_moments(kind, dtype):
    """The JAX package's moments for every axis x ddof, in one program."""
    a = jda.from_array(moment_data(dtype, kind), chunks=CHUNKS)
    keys = [(ax, ddof) for ax in AXES for ddof in (0, 1)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        vals = jda.compute(*[getattr(jda, kind)(a, axis=ax, ddof=ddof) for ax, ddof in keys])
    return {(str(ax), ddof): np.asarray(v) for (ax, ddof), v in zip(keys, vals)}


@pytest.mark.parametrize("ddof", [0, 1])
@pytest.mark.parametrize("axis", AXES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", MOMENT_KINDS)
def test_moments(kind, dtype, axis, ddof):
    x = moment_data(dtype, kind)
    want = numpy_ref(getattr(np, kind), x, axis=axis, ddof=ddof)
    got_arr = getattr(tda, kind)(tda.from_array(x, chunks=CHUNKS), axis=axis, ddof=ddof)
    assert got_arr.dtype == want.dtype
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = np.asarray(got_arr.compute())
    ref = jax_moments(kind, dtype)[(str(axis), ddof)]
    assert got.dtype == want.dtype
    t = dict(rtol=1e-4, atol=1e-6) if dtype != "float64" else dict(rtol=1e-10, atol=1e-12)
    close(got, want, **t)
    close(got, ref.astype(want.dtype), **t)


def test_var_of_a_constant_is_exactly_zero():
    a = tda.from_array(np.full((30, 20), 1234.5678, "f4"), chunks=7)
    assert a.var().compute() == 0.0
    np.testing.assert_array_equal(a.std(axis=0).compute(), np.zeros(20, "f4"))


def test_var_keepdims_dtype_and_complex():
    x = data("float64")
    a = tda.from_array(x, chunks=CHUNKS)
    np.testing.assert_allclose(a.var(axis=1, keepdims=True).compute(), x.var(axis=1, keepdims=True), rtol=1e-10)
    got = tda.var(a, dtype="f4")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got.compute(), x.var(dtype="f4"), rtol=1e-4)
    z = x + 1j * data("float64", "std")
    az = tda.from_array(z, chunks=CHUNKS)
    for kw in ({}, {"dtype": "f8"}, {"axis": 0}):
        want = np.var(z, **kw)
        out = tda.var(az, **kw)
        assert out.dtype == want.dtype
        np.testing.assert_allclose(out.compute(), want, rtol=1e-10)
    # an explicit integer dtype rounds the float variance to the nearest
    # integer, as the reference does (numpy truncates its integer mean first)
    xi = data("int32")
    got = tda.var(tda.from_array(xi, chunks=CHUNKS), dtype="i8")
    assert got.dtype == np.int64
    assert got.compute() == np.asarray(jda.var(jda.from_array(xi, chunks=CHUNKS), dtype="i8").compute())
    assert got.compute() == np.rint(np.var(xi.astype("f8")))


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_moment_matches_jax(order):
    x = data("float64")
    got = tda.moment(tda.from_array(x, chunks=CHUNKS), order, axis=0)
    want = jda.moment(jda.from_array(x, chunks=CHUNKS), order, axis=0)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got.compute(), np.asarray(want.compute()), rtol=1e-10, atol=1e-12)
    if order == 2:
        np.testing.assert_allclose(got.compute(), x.var(axis=0), rtol=1e-10)


def test_count_is_a_numpy_scalar():
    from dask_array_tpu_torch.ops.reductions import _count

    a = tda.from_array(data("float32"), chunks=CHUNKS)
    n = _count(a, axis=1, keepdims=False, split_every=None, dtype="f4")
    assert type(n) is np.float32 and n == 53
    assert (a.sum(axis=1) / n).dtype == np.float32
    assert (a.sum(axis=1) / _count(a, 1, False, None)).dtype == np.float64


# ---------------------------------------------------------------------------
# arg reductions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("axis", [None, 0, 1], ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["argmin", "argmax", "nanargmin", "nanargmax"])
def test_arg_reductions(kind, dtype, axis, keepdims):
    x = data(dtype, "arg")
    want = getattr(np, kind)(x, axis=axis, keepdims=keepdims)
    got = getattr(tda, kind)(tda.from_array(x, chunks=CHUNKS), axis=axis, keepdims=keepdims)
    ref = getattr(jda, kind)(jda.from_array(x, chunks=CHUNKS), axis=axis, keepdims=keepdims)
    assert got.dtype == want.dtype == np.intp
    out = np.asarray(got.compute())
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, np.asarray(ref.compute()))


@pytest.mark.parametrize("axis", [None, 0, 1], ids=str)
def test_argmax_with_nan_gives_the_first_nan(axis):
    x = data("float64", "nanarg").copy()
    x[3, 7] = x[12, 40] = x[30, 7] = np.nan
    a = tda.from_array(x, chunks=CHUNKS)
    for kind in ("argmax", "argmin", "nanargmax", "nanargmin"):
        want = getattr(np, kind)(x, axis=axis)
        np.testing.assert_array_equal(getattr(tda, kind)(a, axis=axis).compute(), want)
        np.testing.assert_array_equal(
            np.asarray(getattr(jda, kind)(jda.from_array(x, chunks=CHUNKS), axis=axis).compute()), want)


def test_nanargmax_all_nan_slice_raises():
    x = data("float64", "allnan").copy()
    x[:, 5] = np.nan
    a = tda.from_array(x, chunks=CHUNKS)
    with pytest.raises(ValueError, match="All-NaN"):
        tda.nanargmax(a, axis=0).compute()
    with pytest.raises(ValueError):
        np.nanargmax(x, axis=0)
    tda.nanargmax(a, axis=1).compute()  # no all-NaN row


def test_argreduce_rejects_tuple_axis():
    a = tda.from_array(data("float64"), chunks=CHUNKS)
    with pytest.raises(TypeError, match="axis"):
        a.argmax(axis=(0, 1))


# ---------------------------------------------------------------------------
# cumulative reductions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["sequential", "blelloch"])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["cumsum", "cumprod", "nancumsum", "nancumprod"])
def test_cumulative(kind, dtype, axis, method):
    x = data(dtype, "prod" if "prod" in kind else kind, kind.startswith("nan"))
    want = getattr(np, kind)(x, axis=axis)
    got = getattr(tda, kind)(tda.from_array(x, chunks=CHUNKS), axis=axis, method=method)
    ref = getattr(jda, kind)(jda.from_array(x, chunks=CHUNKS), axis=axis, method=method)
    assert got.dtype == want.dtype
    assert got.chunks == ref.chunks
    out = got.compute()
    t = tol(want.dtype, x, None)
    close(out, want, **t)
    close(out, np.asarray(ref.compute()).astype(want.dtype), **t)


@pytest.mark.parametrize("shape", [(10,), (6, 7), (3, 4, 5)], ids=str)
@pytest.mark.parametrize("kind", ["cumsum", "cumprod"])
def test_cumulative_axis_none_flattens(kind, shape):
    """axis=None scans the array in C order (through ravel on n-d arrays)."""
    x = np.random.default_rng(len(shape)).uniform(0.5, 1.5, size=shape)
    v = np.arange(int(np.prod(shape)), dtype="i4").reshape(shape) % 7
    for a, exact in ((x, False), (v, True)):
        got = getattr(tda, kind)(tda.from_array(a, chunks=3))
        ref = getattr(jda, kind)(jda.from_array(a, chunks=3))
        want = getattr(np, kind)(a)
        assert got.shape == want.shape and got.dtype == want.dtype and got.chunks == ref.chunks
        if exact:
            np.testing.assert_array_equal(got.compute(), want)
        else:
            np.testing.assert_allclose(got.compute(), want, rtol=1e-12)
            np.testing.assert_allclose(got.compute(), np.asarray(ref.compute()), rtol=1e-12)


def _cummax(b, axis):
    return torch.cummax(b, dim=axis).values


def _amax(b, axis, keepdims):
    return torch.amax(b, dim=axis, keepdim=keepdims)


@pytest.mark.parametrize("method", ["sequential", "blelloch"])
def test_cumreduction_user_functions(method):
    x = data("float64", "cummax")
    got = tda.cumreduction(_cummax, torch.maximum, -np.inf, tda.from_array(x, chunks=CHUNKS),
                           axis=1, method=method, preop=_amax)
    want = np.maximum.accumulate(x, axis=1)
    ref = jda.cumreduction(lambda b, axis=None: np.maximum.accumulate(b, axis=axis), np.maximum,
                           -np.inf, jda.from_array(x, chunks=CHUNKS), axis=1, method=method, preop=np.max)
    np.testing.assert_array_equal(got.compute(), want)
    np.testing.assert_array_equal(got.compute(), np.asarray(ref.compute()))
    with pytest.raises(TypeError, match="preop"):
        tda.cumreduction(_cummax, torch.maximum, -np.inf, tda.from_array(x, chunks=CHUNKS),
                         axis=0, method="blelloch")
    with pytest.raises(ValueError, match="method"):
        tda.cumreduction(_cummax, torch.maximum, -np.inf, tda.from_array(x, chunks=CHUNKS),
                         axis=0, method="bogus")


def test_trace():
    x = data("int32")
    for kw in ({}, {"offset": 3}, {"offset": -5}, {"dtype": "f8"}):
        got = tda.trace(tda.from_array(x, chunks=CHUNKS), **kw)
        want = np.trace(x, **kw)
        assert got.dtype == want.dtype
        assert got.compute() == want
        assert got.compute() == np.asarray(jda.trace(jda.from_array(x, chunks=CHUNKS), **kw).compute())
    assert tda.from_array(x, chunks=CHUNKS).trace().compute() == np.trace(x)


# ---------------------------------------------------------------------------
# the generic reduction() tree: user functions see real blocks (tensors)
# ---------------------------------------------------------------------------


def t_sum(b, axis=None, keepdims=False, dtype=None):
    return torch.sum(b, dim=axis, keepdim=keepdims, dtype=dtype)


def t_mean_chunk(x, axis=None, keepdims=True, dtype=None):
    assert isinstance(x, torch.Tensor)
    total = torch.sum(x, dim=axis, keepdim=True, dtype=dtype)
    n = torch.full_like(total, float(np.prod([x.shape[a] for a in axis])))
    return {"n": n, "total": total}


def _cat(pairs, field, axis):
    from dask_array_tpu_torch.ops.reductions import _concatenate2

    def deep(p):
        return [deep(q) for q in p] if isinstance(p, list) else p[field]

    return _concatenate2(deep(pairs if isinstance(pairs, list) else [pairs]), axes=sorted(axis))


def t_mean_combine(pairs, axis=None, keepdims=True, dtype=None):
    return {f: _cat(pairs, f, axis).sum(dim=axis, keepdim=True) for f in ("n", "total")}


def t_mean_agg(pairs, axis=None, keepdims=False, dtype=None):
    n = _cat(pairs, "n", axis).sum(dim=axis, keepdim=keepdims)
    return _cat(pairs, "total", axis).sum(dim=axis, keepdim=keepdims) / n


def np_mean_chunk(x, axis=None, keepdims=True, dtype="f8", **kw):
    total = np.sum(x, axis=axis, keepdims=True, dtype=dtype)
    return {"n": np.full_like(total, np.prod([x.shape[a] for a in axis])), "total": total}


def np_mean_combine(pairs, axis=None, keepdims=True, dtype="f8", **kw):
    from dask_array_tpu.ops.reductions import _concatenate2

    def deep(p, f):
        return [deep(q, f) for q in p] if isinstance(p, list) else p[f]

    pairs = pairs if isinstance(pairs, list) else [pairs]
    return {f: _concatenate2(deep(pairs, f), axes=sorted(axis)).sum(axis=axis, keepdims=True)
            for f in ("n", "total")}


def np_mean_agg(pairs, axis=None, keepdims=False, dtype="f8", **kw):
    c = np_mean_combine(pairs, axis=axis)
    return (c["total"] / c["n"]).sum(axis=axis, keepdims=keepdims)


@pytest.mark.parametrize("split_every", [None, 2, 3])
@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1)], ids=str)
def test_reduction_user_sum(axis, split_every):
    x = data("float64")
    got = tda.reduction(tda.from_array(x, chunks=CHUNKS), t_sum, t_sum, axis=axis, dtype="f8",
                        split_every=split_every)
    ref = jda.reduction(jda.from_array(x, chunks=CHUNKS), np.sum, np.sum, axis=axis, dtype="f8",
                        split_every=split_every)
    assert got.shape == ref.shape and got.chunks == ref.chunks
    np.testing.assert_allclose(got.compute(), x.sum(axis=axis), rtol=1e-12)
    np.testing.assert_allclose(got.compute(), np.asarray(ref.compute()), rtol=1e-12)


@pytest.mark.parametrize("axis", [None, 0, 1], ids=str)
def test_reduction_dict_protocol(axis):
    x = data("float64")
    got = tda.reduction(tda.from_array(x, chunks=CHUNKS), t_mean_chunk, t_mean_agg,
                        combine=t_mean_combine, axis=axis, dtype="f8", concatenate=False, split_every=2)
    ref = jda.reduction(jda.from_array(x, chunks=CHUNKS), np_mean_chunk, np_mean_agg,
                        combine=np_mean_combine, axis=axis, dtype="f8", concatenate=False, split_every=2)
    np.testing.assert_allclose(got.compute(), x.mean(axis=axis), rtol=1e-12)
    np.testing.assert_allclose(got.compute(), np.asarray(ref.compute()), rtol=1e-12)


def test_reduction_weights_output_size_and_errors():
    x = data("float64")
    w = np.random.default_rng(5).uniform(0.5, 2.0, size=SHAPE[1])

    def wsum(b, weights, axis=None, keepdims=True):
        return torch.sum(b * weights, dim=axis, keepdim=keepdims)

    a = tda.from_array(x, chunks=CHUNKS)
    np.testing.assert_allclose(tda.reduction(a, wsum, t_sum, dtype="f8", weights=w).compute(),
                               (x * w).sum(), rtol=1e-12)
    with pytest.raises(ValueError, match="broadcastable"):
        tda.reduction(a, wsum, t_sum, dtype="f8", weights=np.ones((3, 2)))
    with pytest.raises(ValueError, match="dtype"):
        tda.reduction(a, t_sum, t_sum)

    def minmax(b, axis=None, keepdims=True):
        return torch.stack([b.min(), b.max()])

    def agg_minmax(w_, axis=None, keepdims=False):
        w_ = w_.reshape(-1, 2)
        return torch.stack([w_[:, 0].min(), w_[:, 1].max()])

    v = x[0]
    out = tda.reduction(tda.from_array(v, chunks=16), minmax, agg_minmax, axis=0, dtype="f8",
                        keepdims=True, output_size=2)
    assert out.shape == (2,)
    np.testing.assert_array_equal(out.compute(), [v.min(), v.max()])


# the reference's structured-array arg protocol, host-side numpy
def _arg_combine_impl(data_, axis, argfunc, keepdims=False):
    axis = None if len(axis) == data_.ndim or data_.ndim == 1 else axis[0]
    vals, arg = data_["vals"], data_["arg"]
    if axis is None:
        local = argfunc(vals, axis=axis, keepdims=keepdims)
        return arg.ravel()[local], vals.ravel()[local]
    local = argfunc(vals, axis=axis)
    inds = list(np.ogrid[tuple(map(slice, local.shape))])
    inds.insert(axis, local)
    vals, arg = vals[tuple(inds)], arg[tuple(inds)]
    if keepdims:
        vals, arg = np.expand_dims(vals, axis), np.expand_dims(arg, axis)
    return arg, vals


def arg_chunk(func, argfunc, x, axis, offset_info):
    arg_axis = None if len(axis) == x.ndim or x.ndim == 1 else axis[0]
    vals = func(x, axis=arg_axis, keepdims=True)
    arg = argfunc(x, axis=arg_axis, keepdims=True)
    if arg_axis is None:
        offset, total_shape = offset_info
        ind = np.unravel_index(arg.ravel()[0], x.shape)
        arg = np.full_like(arg, np.ravel_multi_index(tuple(o + i for o, i in zip(offset, ind)), total_shape))
    else:
        arg = arg + offset_info
    out = np.empty(vals.shape, dtype=[("vals", vals.dtype), ("arg", arg.dtype)])
    out["vals"], out["arg"] = vals, arg
    return out


def arg_combine(argfunc, data_, axis=None, **kw):
    arg, vals = _arg_combine_impl(data_, axis, argfunc, keepdims=True)
    out = np.empty(vals.shape, dtype=[("vals", vals.dtype), ("arg", arg.dtype)])
    out["vals"], out["arg"] = vals, arg
    return out


def arg_agg(argfunc, data_, axis=None, keepdims=False, **kw):
    return _arg_combine_impl(data_, axis, argfunc, keepdims=keepdims)[0]


@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("axis", [None, 0, 1], ids=str)
def test_generic_arg_reduction(axis, keepdims):
    x = data("float64", "genarg")
    fns = (functools.partial(arg_chunk, np.max, np.argmax), functools.partial(arg_combine, np.argmax),
           functools.partial(arg_agg, np.argmax))
    got = tda.arg_reduction(tda.from_array(x, chunks=CHUNKS), *fns, axis=axis, keepdims=keepdims, split_every=2)
    ref = jda.arg_reduction(jda.from_array(x, chunks=CHUNKS), *fns, axis=axis, keepdims=keepdims, split_every=2)
    want = np.argmax(x, axis=axis, keepdims=keepdims)
    np.testing.assert_array_equal(got.compute(), want)
    np.testing.assert_array_equal(got.compute(), np.asarray(ref.compute()))


# ---------------------------------------------------------------------------
# blockwise with contracted labels
# ---------------------------------------------------------------------------


def test_blockwise_contraction_concatenates_or_lists():
    x = data("float64")
    y = data("float64", "rhs")[:, :20].T.copy()  # (20, 37)
    a, b = tda.from_array(y, chunks=(8, 10)), tda.from_array(x, chunks=CHUNKS)
    # concatenate=True: the contracted axis arrives whole, one tensor
    got = tda.blockwise(lambda p, q: p @ q, "ik", a, "ij", b, "jk", dtype="f8", concatenate=True)
    assert got.chunks == ((8, 8, 4), b.chunks[1])
    np.testing.assert_allclose(got.compute(), y @ x, rtol=1e-12)

    # concatenate=None (dask's default): nested lists of blocks
    def listed(ps, qs):
        assert isinstance(ps, list) and isinstance(qs, list)
        return sum(p @ q for p, q in zip(ps, qs))

    got2 = tda.blockwise(listed, "ik", a, "ij", b, "jk", dtype="f8")
    ref = jda.blockwise(lambda ps, qs: sum(p @ q for p, q in zip(ps, qs)), "ik",
                        jda.from_array(y, chunks=(8, 10)), "ij", jda.from_array(x, chunks=CHUNKS), "jk", dtype="f8")
    assert got2.chunks == ref.chunks
    np.testing.assert_allclose(got2.compute(), y @ x, rtol=1e-12)
    np.testing.assert_allclose(got2.compute(), np.asarray(ref.compute()), rtol=1e-12)


def test_out_replaces_the_targets_expression():
    x = data("float64")
    a = tda.from_array(x, chunks=CHUNKS)
    out = tda.zeros(SHAPE[1], dtype="f4", chunks=16)
    res = tda.sum(a, axis=0, out=out)
    assert res is out and out.dtype == np.float32
    np.testing.assert_allclose(out.compute(), x.sum(axis=0).astype("f4"), rtol=1e-6)
    with pytest.raises(ValueError, match="Mismatched shapes"):
        a.mean(axis=1, out=out)
    with pytest.raises(NotImplementedError):
        a.max(out=np.zeros(()))


def test_tree_reduce_of_prechunked_partials():
    from dask_array_tpu_torch.ops.reductions import _tree_reduce

    x = data("float64")[:32]
    partials = tda.from_array(x, chunks=(8, 53)).map_blocks(
        lambda b: torch.sum(b, dim=0, keepdim=True), chunks=((1,) * 4, (53,)))
    out = _tree_reduce(partials, t_sum, axis=(0,), keepdims=False, dtype="f8", split_every=2)
    np.testing.assert_allclose(out.compute(), x.sum(axis=0), rtol=1e-12)


# -- float16 scans round after every step, as numpy's do ----------------------

# (kind, axis) cases where the JAX package differs from numpy (checked
# below), the port pinning numpy: a scan of the raveled float16 array
HALF_SCAN_REFERENCE_FAULTS = {("cumsum", None), ("nancumsum", None), ("cumprod", None), ("nancumprod", None)}


def half_scan_data(kind):
    """The (12, 10) x 10 float16 case; cumprod on values near 1 (no
    overflow), a NaN for the nan-scans."""
    x = np.random.default_rng(0).random((12, 10)) * 10
    if kind.endswith("cumprod"):
        x = 0.9 + x / 50
    x = x.astype(np.float16)
    if kind.startswith("nan"):
        x[2, 3] = np.nan
    return x


@pytest.mark.parametrize("axis", [0, 1, None])
@pytest.mark.parametrize("kind", ["cumsum", "nancumsum", "cumprod", "nancumprod"])
@pytest.mark.parametrize("chunks", [5, (12, 3), 1])
def test_float16_scans_round_every_step_like_numpy(kind, axis, chunks):
    """Bit for bit against numpy (float32 accumulation differs in 46-48 of
    the 120 values, by up to 2.3 %)."""
    x = half_scan_data(kind)
    want = getattr(np, kind)(x, axis=axis)
    got = getattr(tda, kind)(tda.from_array(x, chunks=chunks), axis=axis).compute()
    assert got.dtype == want.dtype == np.float16
    assert got.tobytes() == want.tobytes()
    if (kind, axis) not in HALF_SCAN_REFERENCE_FAULTS and chunks == 5:
        ref = np.asarray(getattr(jda, kind)(jda.from_array(x, chunks=chunks), axis=axis).compute())
        assert ref.tobytes() == want.tobytes()


@pytest.mark.parametrize("kind, axis", sorted(HALF_SCAN_REFERENCE_FAULTS, key=str))
def test_float16_scan_reference_faults_are_real(kind, axis):
    x = half_scan_data(kind)
    ref = np.asarray(getattr(jda, kind)(jda.from_array(x, chunks=5), axis=axis).compute())
    assert ref.tobytes() != getattr(np, kind)(x, axis=axis).tobytes()
