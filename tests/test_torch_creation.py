"""The rest of creation in the PyTorch port: the ``*_like`` functions,
``linspace``, ``eye``, ``diag``/``diagonal``, ``tri``, ``pad``, ``tile``,
``repeat``, ``meshgrid``, ``indices`` and ``fromfunction``.

The cases of tests/test_creation_battery.py and
tests/test_creation_parity3.py that the port covers: the same numpy inputs
go through the JAX package and the port, and both are held against numpy.
``pad``'s index-map and constant modes run ``halo_pad``'s plain version on
a CPU tensor; its other modes are torch ops.  Tolerances: layouts and
integer results equal; float results rtol 1e-12 in float64 (1e-5 where the
JAX tests take it for float32 or for linspace's last element).
"""

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.ops.creation import Arange, Linspace, Pad

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


@pytest.fixture
def rng():
    return np.random.default_rng(31)


def check(got, want, jax_got=None, rtol=1e-12, check_chunks=True):
    out = got.compute()
    want = np.asarray(want)
    assert out.shape == want.shape and out.dtype == want.dtype == got.dtype
    if check_chunks:
        assert tuple(sum(c) for c in got.chunks) == out.shape
    if out.dtype.kind in "fc":
        np.testing.assert_allclose(out, want, rtol=rtol, equal_nan=True)
    else:
        np.testing.assert_array_equal(out, want)
    if jax_got is not None:
        assert got.chunks == jax_got.chunks
        np.testing.assert_allclose(out, np.asarray(jax_got.compute()), rtol=rtol, equal_nan=True)


# ---------------------------------------------------------------------------
# *_like
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("funcname", ["empty_like", "ones_like", "zeros_like", "full_like"])
@pytest.mark.parametrize("cast_shape", [tuple, list, np.asarray])
@pytest.mark.parametrize("name", [None, "my-name"])
def test_arr_like(funcname, cast_shape, name, rng):
    a = rng.integers(0, 10, (10, 10)).astype("i4")
    kw = {"fill_value": 5} if funcname == "full_like" else {}
    np_r = getattr(np, funcname)(a, **kw)
    da_r = getattr(tda, funcname)(a, chunks=(4, 4), name=name, **kw)
    assert np_r.shape == da_r.shape and np_r.dtype == da_r.dtype
    assert da_r.chunks == getattr(jda, funcname)(a, chunks=(4, 4), **kw).chunks
    if funcname != "empty_like":
        check(da_r, np_r)
    assert (da_r.name == name) if name else funcname.split("_")[0] in da_r.name
    # like a collection: its chunks carry over
    d = tda.from_array(a, chunks=(3, 7))
    assert getattr(tda, funcname)(d, **kw).chunks == d.chunks


@pytest.mark.parametrize("funcname, kwargs",
                         [("empty_like", {}), ("ones_like", {}), ("zeros_like", {}), ("full_like", {"fill_value": 5})])
@pytest.mark.parametrize("shape, chunks, out_shape", [
    ((10, 10), (4, 4), None),
    ((10, 10), (4, 4), (20, 3)),
    ((10, 10), (4), (20)),
    ((10, 10, 10), (4, 2), (5, 5)),
    ((2, 3, 5, 7), None, (3, 5, 7)),
    ((2, 3, 5, 7), (2, 5, 3), (3, 5, 7)),
    ((2, 3, 5, 7), "auto", (3, 5, 7)),
])
def test_arr_like_shape(rng, funcname, kwargs, shape, chunks, out_shape):
    a = rng.integers(0, 10, shape).astype("i4")
    np_r = getattr(np, funcname)(a, shape=out_shape, **kwargs)
    da_r = getattr(tda, funcname)(a, chunks=chunks, shape=out_shape, **kwargs)
    assert np_r.shape == da_r.shape and np_r.dtype == da_r.dtype
    assert da_r.chunks == getattr(jda, funcname)(a, chunks=chunks, shape=out_shape, **kwargs).chunks
    if funcname != "empty_like":
        check(da_r, np_r)


def test_like_family_order_kwarg():
    d = tda.ones((4, 5), chunks=2)
    for fn in (tda.ones_like, tda.zeros_like, tda.empty_like):
        assert fn(d, order="K").shape == (4, 5)
        with pytest.raises(NotImplementedError):
            fn(d, order="F")
    assert tda.full_like(d, 7, order="C").compute().max() == 7
    assert tda.full_like(d, 2.5, dtype="f4").dtype == np.float32


# ---------------------------------------------------------------------------
# linspace
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("endpoint", [True, False])
def test_linspace_matrix(endpoint):
    for args, kw in [((6, 49), {"chunks": 5}), ((1.4, 4.9), {"chunks": 5, "num": 13}),
                     ((6, 49), {"chunks": 5, "dtype": float}), ((1.4, 4.9), {"chunks": 5, "num": 13, "dtype": int})]:
        np_kw = {k: v for k, v in kw.items() if k != "chunks"}
        check(tda.linspace(*args, endpoint=endpoint, **kw), np.linspace(*args, endpoint=endpoint, **np_kw),
              jda.linspace(*args, endpoint=endpoint, **kw), rtol=1e-12)
    darr, dstep = tda.linspace(6, 49, endpoint=endpoint, chunks=5, retstep=True)
    _, npstep = np.linspace(6, 49, endpoint=endpoint, retstep=True)
    assert np.isclose(dstep, npstep)
    assert tda.linspace(1.4, 4.9, num=13).expr._name == tda.linspace(1.4, 4.9, num=13).expr._name
    for args in [(0, 0, 0), (1, 1, 0), (1, 5, 0), (0, 0, 1), (1, 1, 1), (1, 5, 1)]:
        check(tda.linspace(*args, endpoint=endpoint), np.linspace(*args, endpoint=endpoint))


PUSHDOWN_INDEXES = [slice(0, 30), slice(5, 45), slice(None, None, 7), slice(0, None, 100),
                    slice(None, None, -1), slice(950, 10, -3), slice(20, 20), slice(-5, None), slice(3, 500, 13)]


@pytest.mark.parametrize("index", PUSHDOWN_INDEXES)
@pytest.mark.parametrize("endpoint", [True, False])
def test_linspace_slice_pushdown(endpoint, index):
    y = tda.linspace(2.5, 97.5, 1000, endpoint=endpoint, chunks=100)[index]
    assert isinstance(y.expr.simplify(), (Arange, Linspace))
    check(y, np.linspace(2.5, 97.5, 1000, endpoint=endpoint)[index], rtol=1e-13, check_chunks=False)


def test_linspace_rechunk_stays_a_leaf():
    y = tda.linspace(0, 1, 100, chunks=10).rechunk(25)
    assert isinstance(y.expr.simplify(), Linspace)
    check(y, np.linspace(0, 1, 100))


def test_linspace_dask_scalar_bounds():
    x = tda.from_array(np.array([0.2, 6.4, 3.0, 1.6]), chunks=2)
    check(tda.linspace(tda.argmin(x), tda.argmax(x) + 1, 8), np.linspace(0, 2, 8))


# ---------------------------------------------------------------------------
# eye / diag / diagonal / tri
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N, M, k", [(5, None, 0), (6, 4, 1), (4, 7, -2), (5, 5, 9)])
@pytest.mark.parametrize("dtype", [float, "i4", bool])
def test_eye(N, M, k, dtype):
    check(tda.eye(N, chunks=3, M=M, k=k, dtype=dtype), np.eye(N, M, k, dtype=dtype),
          jda.eye(N, chunks=3, M=M, k=k, dtype=dtype))


@pytest.mark.parametrize("k", [0, 3, -3, 8])
def test_diag_2d_array_creation(k):
    v = np.arange(11)
    check(tda.diag(v, k), np.diag(v, k), jda.diag(v, k))
    d = tda.arange(11, chunks=3)
    check(tda.diag(d, k), np.diag(np.arange(11), k), jda.diag(jda.arange(11, chunks=3), k))
    assert tda.diag(d, k).expr._name == tda.diag(d, k).expr._name
    check(tda.diag(d + d + 3, k), np.diag(np.arange(11) * 2 + 3, k))


@pytest.mark.parametrize("k", [0, 3, -3, 8])
def test_diag_extraction_chunked(k):
    x = np.arange(64).reshape((8, 8))
    check(tda.diag(tda.from_array(x, chunks=(4, 4)), k), np.diag(x, k),
          jda.diag(jda.from_array(x, chunks=(4, 4)), k))


@pytest.mark.parametrize("offset, axis1, axis2", [(0, 0, 1), (2, 0, 1), (-1, 1, 0), (1, 0, 2), (0, -1, 1)])
def test_diagonal(offset, axis1, axis2):
    x = np.arange(4 * 5 * 6).reshape(4, 5, 6)
    got = tda.diagonal(tda.from_array(x, chunks=(2, 3, 4)), offset, axis1, axis2)
    want = jda.diagonal(jda.from_array(x, chunks=(2, 3, 4)), offset, axis1, axis2)
    check(got, np.diagonal(x, offset, axis1, axis2), want)


def test_diag_and_diagonal_errors():
    with pytest.raises(ValueError, match="1d or 2d"):
        tda.diag(np.arange(24).reshape(2, 3, 4))
    with pytest.raises(ValueError, match="1d or 2d"):
        tda.diag(tda.arange(24, chunks=6).reshape((2, 3, 4)))
    with pytest.raises(ValueError, match="at least two"):
        tda.diagonal(tda.arange(5, chunks=2))
    with pytest.raises(ValueError, match="cannot be the same"):
        tda.diagonal(tda.ones((3, 3), chunks=2), axis1=1, axis2=1)


def test_diagonal_zero_chunks():
    d = tda.diagonal(tda.ones((8, 8), chunks=(4, 4)))
    check(d, np.ones(8))
    check(d + tda.ones((8, 8), chunks=(4, 4)), np.full((8, 8), 2.0))


@pytest.mark.parametrize("N, M, k", [(5, None, 0), (4, 6, 1), (6, 3, -2)])
def test_tri(N, M, k):
    check(tda.tri(N, M, k, chunks=2), np.tri(N, M, k), jda.tri(N, M, k, chunks=2))
    check(tda.tri(N, M, k, dtype="i4", chunks=3), np.tri(N, M, k, dtype="i4"))


# ---------------------------------------------------------------------------
# pad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape, chunks, pad_width, mode, kwargs", [
    ((10,), (3,), 1, "constant", {}),
    ((10,), (3,), 2, "constant", {"constant_values": -1}),
    ((10,), (3,), 2, "constant", {"constant_values": np.array(-1)}),
    ((10,), (3,), (2, 3), "constant", {"constant_values": (-1, -2)}),
    ((10, 11), (4, 5), ((1, 4), (2, 3)), "constant", {"constant_values": ((-1, -2), (2, 1))}),
    ((10,), (3,), 3, "edge", {}),
    ((10,), (3,), 3, "linear_ramp", {}),
    ((10,), (3,), 3, "linear_ramp", {"end_values": 0}),
    ((10, 11), (4, 5), ((1, 4), (2, 3)), "linear_ramp", {"end_values": ((-1, -2), (4, 3))}),
    ((10, 11), (4, 5), ((1, 4), (2, 3)), "reflect", {}),
    ((10, 11), (4, 5), ((1, 4), (2, 3)), "symmetric", {}),
    ((10, 11), (4, 5), ((1, 4), (2, 3)), "wrap", {}),
    ((10,), (3,), (2, 3), "maximum", {"stat_length": (1, 2)}),
    ((10, 11), (4, 5), ((1, 4), (2, 3)), "mean", {"stat_length": ((3, 4), (2, 1))}),
    ((10,), (3,), (2, 3), "minimum", {"stat_length": (2, 3)}),
    ((10, 11), (4, 5), ((3, 2), (1, 4)), "median", {}),
    ((10, 11), (4, 5), ((3, 2), (1, 4)), "median", {"stat_length": 3}),
    ((10, 11), (4, 5), ((3, 2), (1, 4)), "maximum", {}),
])
def test_pad_grid(rng, shape, chunks, pad_width, mode, kwargs):
    a = rng.random(shape)
    got = tda.pad(tda.from_array(a, chunks=chunks), pad_width, mode, **kwargs)
    want = jda.pad(jda.from_array(a, chunks=chunks), pad_width, mode, **kwargs)
    assert isinstance(got.expr, Pad)
    check(got, np.pad(a, pad_width, mode, **kwargs), want)


@pytest.mark.parametrize("mode", ["reflect", "symmetric"])
@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("width", [(0, 1), (3, 2), (7, 9)])
def test_pad_odd_reflection(mode, n, width):
    a = np.random.default_rng(n).random((n, 4))
    got = tda.pad(tda.from_array(a, chunks=2), (width, (1, 2)), mode, reflect_type="odd")
    check(got, np.pad(a, (width, (1, 2)), mode, reflect_type="odd"))


@pytest.mark.parametrize("mode", ["constant", "edge", "reflect", "symmetric", "wrap"])
def test_pad_widths_past_the_axis(mode):
    a = np.arange(12.0).reshape(3, 4)
    pw = ((7, 5), (9, 2))
    check(tda.pad(tda.from_array(a, chunks=2), pw, mode), np.pad(a, pw, mode),
          jda.pad(jda.from_array(a, chunks=2), pw, mode))


def test_pad_3d_data(rng):
    a = rng.random((6, 7, 8))
    for mode in ["constant", "edge", "reflect", "symmetric", "wrap"]:
        check(tda.pad(tda.from_array(a, chunks=(2, 3, 4)), ((1, 2), (0, 1), (2, 0)), mode),
              np.pad(a, ((1, 2), (0, 1), (2, 0)), mode),
              jda.pad(jda.from_array(a, chunks=(2, 3, 4)), ((1, 2), (0, 1), (2, 0)), mode))


@pytest.mark.parametrize("mode, kwargs", [
    ("constant", {"constant_values": 2}), ("edge", {}), ("linear_ramp", {"end_values": 2}),
    ("reflect", {}), ("symmetric", {}), ("wrap", {}), ("empty", {}),
])
def test_pad_0_width_is_identity(rng, mode, kwargs):
    a = rng.random((10, 11))
    d = tda.from_array(a, chunks=(4, 5))
    assert tda.pad(d, 0, mode, **kwargs) is d
    check(tda.pad(d, 0, mode, **kwargs), np.pad(a, 0, mode, **kwargs))


def test_pad_empty_mode_has_the_shape():
    got = tda.pad(tda.from_array(np.ones((4, 5)), chunks=2), ((1, 2), (3, 0)), "empty")
    assert got.compute().shape == np.pad(np.ones((4, 5)), ((1, 2), (3, 0)), "empty").shape


@pytest.mark.parametrize("shape, chunks, pad_width, kwargs", [
    ((0,), (0,), (2, 3), {}),
    ((0,), (0,), (2, 3), {"constant_values": 5}),
    ((5, 0), (5, 0), ((1, 2), (2, 3)), {}),
    ((0, 5), (0, 5), ((2, 3), (1, 1)), {"constant_values": 7}),
    ((0, 0), (0, 0), ((2, 3), (1, 4)), {}),
    ((6, 0), (2, 0), ((0, 0), (2, 3)), {}),
])
def test_pad_empty_array(shape, chunks, pad_width, kwargs):
    a = np.ones(shape)
    check(tda.pad(tda.from_array(a, chunks=chunks), pad_width, mode="constant", **kwargs),
          np.pad(a, pad_width, mode="constant", **kwargs))


@pytest.mark.parametrize("np_a, pad_value", [
    (np.arange(4, dtype="int64"), np.int64(1)),
    (np.arange(4, dtype="float64"), np.float64(0)),
    (np.array([True, False, True, True]), np.bool_(False)),
    (np.arange(4, dtype="int64"), np.array(1, dtype="int64")),
    (np.arange(4, dtype="float64"), np.array(0, dtype="float64")),
    (np.arange(4, dtype="int32"), 0.5),
])
def test_pad_constant_values_typed(np_a, pad_value):
    got = tda.pad(tda.from_array(np_a, chunks=2), 1, mode="constant", constant_values=pad_value)
    want = jda.pad(jda.from_array(np_a, chunks=2), 1, mode="constant", constant_values=pad_value)
    check(got, np.pad(np_a, 1, mode="constant", constant_values=pad_value), want)


@pytest.mark.parametrize("mode, kwargs", [("mean", {}), ("median", {"stat_length": 2}), ("linear_ramp", {"end_values": 7})])
def test_pad_integer_statistics_round_like_numpy(mode, kwargs):
    a = np.arange(12, dtype=np.int64).reshape(3, 4) * 3 + 1
    check(tda.pad(tda.from_array(a, chunks=2), 2, mode, **kwargs), np.pad(a, 2, mode, **kwargs))


def test_pad_constant_chunksizes():
    # padding must not glue the pad band onto a data chunk
    result = tda.pad(tda.ones((10, 10), chunks=(1, 1)), ((0, 6), (0, 0)), mode="constant", constant_values=0)
    assert tuple(map(max, result.chunks)) == (1, 1)
    assert result.chunks == jda.pad(jda.ones((10, 10), chunks=(1, 1)), ((0, 6), (0, 0))).chunks
    check(result, np.pad(np.ones((10, 10)), ((0, 6), (0, 0))))


# -- pad's step modes off the float dtypes, against numpy ----------------------

PAD_DTYPES = ["bool", "int8", "int32", "int64", "uint8", "uint16", "uint32", "uint64", "float16", "float32", "float64",
              "complex64", "complex128"]
PAD_MODES = {
    "maximum": ("maximum", {}), "minimum": ("minimum", {}), "maximum_stat": ("maximum", {"stat_length": 2}),
    "minimum_stat": ("minimum", {"stat_length": (1, 3)}), "mean": ("mean", {}), "mean_stat": ("mean", {"stat_length": 3}),
    "median": ("median", {}), "median_stat": ("median", {"stat_length": 2}), "linear_ramp": ("linear_ramp", {}),
    "linear_ramp_ends": ("linear_ramp", {"end_values": (5, 2)}),
    "reflect_odd": ("reflect", {"reflect_type": "odd"}), "symmetric_odd": ("symmetric", {"reflect_type": "odd"}),
}
PAD_WIDTH = ((2, 3), (1, 4))


def pad_data(dtype, shape=(5, 7), seed=11):
    """Seeded values over the dtype's range: uint64 mostly at or above
    2**63, the signed types both signs, a NaN (a NaN part) in the floats."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return rng.random(shape) > 0.6
    if dt == np.uint64:
        return rng.integers(2**62, 2**64 - 1, shape, dtype=np.uint64, endpoint=True)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        return rng.integers(info.min // 2, info.max // 2, shape, endpoint=True).astype(dt)
    a = rng.standard_normal(shape) * 10
    if dt.kind == "c":
        a = a + 1j * rng.standard_normal(shape)
    a = a.astype(dt)
    a.flat[3] = complex(np.nan, 1) if dt.kind == "c" else np.nan
    return a


# the JAX package's pads that differ from numpy's (each checked to differ
# below), the port pinning numpy: the means, medians and ramps of int32 and
# wider integers, a float16 ramp with end values, complex maximum, minimum
# and median (refused), and the odd reflection of bool (refused).  The
# uint64 means are the case both packages missed before the port took
# numpy's conversion and order of summation
PAD_REFERENCE_FAULTS = {
    ("reflect_odd", "bool"), ("symmetric_odd", "bool"), ("linear_ramp_ends", "float16"),
    *((name, dt) for dt in ("int32", "int64", "uint32", "uint64") for name in ("linear_ramp", "linear_ramp_ends",
                                                                               "mean", "mean_stat")),
    *((name, dt) for dt in ("int32", "uint32") for name in ("median", "median_stat")),
    *((name, dt) for dt in ("complex64", "complex128") for name in ("maximum", "maximum_stat", "minimum", "median",
                                                                   "median_stat")),
}


def _pad_same(got, want, dtype, rtol=0.0):
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    if rtol and want.dtype.kind in "fc":
        np.testing.assert_allclose(got, want, rtol=rtol, equal_nan=True)
    else:
        assert np.array_equal(got, want, equal_nan=want.dtype.kind in "fc")


@pytest.mark.parametrize("name", sorted(PAD_MODES))
@pytest.mark.parametrize("dtype", PAD_DTYPES)
def test_pad_steps_every_dtype(name, dtype):
    """numpy's step modes in every dtype, values and dtype equal to
    numpy's: maximum/minimum of unsigned and complex, the odd reflection
    of unsigned, ramps of complex and uint64, means and medians of bool and
    uint64, medians with NaN."""
    mode, kw = PAD_MODES[name]
    a = pad_data(dtype)
    want = np.pad(a, PAD_WIDTH, mode, **kw)
    got = tda.pad(tda.from_array(a, chunks=3), PAD_WIDTH, mode, **kw)
    assert got.dtype == want.dtype
    _pad_same(got.compute(), want, dtype)
    if (name, dtype) in PAD_REFERENCE_FAULTS:
        return
    ref = np.asarray(jda.pad(jda.from_array(a, chunks=3), PAD_WIDTH, mode, **kw).compute())
    _pad_same(ref, want, dtype, rtol=1e-3 if dtype in ("float16", "complex64") else 1e-6)


@pytest.mark.parametrize("name, dtype", sorted(PAD_REFERENCE_FAULTS))
def test_pad_reference_faults_are_real(name, dtype):
    mode, kw = PAD_MODES[name]
    a = pad_data(dtype)
    want = np.pad(a, PAD_WIDTH, mode, **kw)
    with pytest.raises((AssertionError, TypeError, ValueError)):
        ref = np.asarray(jda.pad(jda.from_array(a, chunks=3), PAD_WIDTH, mode, **kw).compute())
        _pad_same(ref, want, dtype, rtol=1e-3 if dtype in ("float16", "complex64") else 1e-6)


@pytest.mark.parametrize("dtype", ["bool", "uint16", "uint64", "float32", "complex128"])
@pytest.mark.parametrize("shape, pad_width", [((9,), (4, 2)), ((3, 4, 5), ((1, 2), (0, 3), (2, 1))),
                                              ((12, 40), ((3, 1), (2, 9)))])
def test_pad_steps_shapes(dtype, shape, pad_width):
    """The step modes on 1-D, 3-D and longer (pairwise-summed) axes."""
    a = pad_data(dtype, shape, seed=len(shape))
    for mode, kw in PAD_MODES.values():
        want = np.pad(a, pad_width, mode, **kw)
        _pad_same(tda.pad(tda.from_array(a, chunks=4), pad_width, mode, **kw).compute(), want, dtype)


@pytest.mark.parametrize("chunks, pad_width", [
    ((4, 5), ((1, 9), (11, 2))), (((3, 7), (2, 9)), ((4, 4), (0, 5))), ((10, 11), ((3, 3), (12, 1))),
])
def test_pad_chunk_plan_is_the_jax_packages(chunks, pad_width):
    a = np.zeros((10, 11))
    assert tda.pad(tda.from_array(a, chunks=chunks), pad_width).chunks == \
        jda.pad(jda.from_array(a, chunks=chunks), pad_width).chunks


@pytest.mark.parametrize("kwargs", [{}, {"scaler": 2}])
def test_pad_udf(rng, kwargs):
    def udf_pad(vector, pad_width, iaxis, inner_kwargs):
        assert kwargs == inner_kwargs
        scaler = inner_kwargs.get("scaler", 1)
        vector[: pad_width[0]] = -scaler * pad_width[0]
        vector[-pad_width[1]:] = scaler * pad_width[1]
        return vector

    a = rng.random((10, 11))
    check(tda.pad(tda.from_array(a, chunks=(4, 5)), ((1, 2), (2, 3)), udf_pad, **kwargs),
          np.pad(a, ((1, 2), (2, 3)), udf_pad, **kwargs))


def test_pad_errors():
    d = tda.from_array(np.ones((4, 5)), chunks=2)
    with pytest.raises(ValueError, match="not supported"):
        tda.pad(d, 1, "bogus")
    with pytest.raises(ValueError, match="unsupported keyword"):
        tda.pad(d, 1, "edge", constant_values=3)
    with pytest.raises(ValueError, match="ndim"):
        tda.pad(d, ((1, 1), (1, 1), (1, 1)))


# ---------------------------------------------------------------------------
# tile / repeat / meshgrid / indices / fromfunction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape, reps", [
    ((), 2), ((), (2, 3)), ((2, 3), 2), ((2, 3), (2, 1)), ((2, 3), (2, 2)), ((4, 3, 2), (2, 1, 2)), ((3,), (2, 1, 2)),
])
def test_tile_np_kroncompare_examples(shape, reps):
    x = np.random.default_rng(0).random(shape)
    check(tda.tile(tda.asarray(x), reps), np.tile(x, reps), check_chunks=False)


@pytest.mark.parametrize("shape, chunks", [((10,), (1,)), ((10, 11, 13), (4, 5, 3))])
@pytest.mark.parametrize("reps", [2, (2, 3), (3, 2, 5), 0, (0,), (2, 0), (0, 3, 0, 4)])
def test_tile_chunks_and_zero_reps(rng, shape, chunks, reps):
    x = rng.random(shape)
    got = tda.tile(tda.from_array(x, chunks=chunks), reps)
    check(got, np.tile(x, reps), jda.tile(jda.from_array(x, chunks=chunks), reps))


@pytest.mark.parametrize("reps", [-1, -5])
def test_tile_neg_reps(rng, reps):
    with pytest.raises(ValueError):
        tda.tile(tda.from_array(rng.random(10), chunks=2), reps)


@pytest.mark.parametrize("shape, chunks", [((1, 1, 0), (1, 1, 0)), ((2, 0), (1, 0))])
@pytest.mark.parametrize("reps", [2, (3, 2, 5)])
def test_tile_empty_array(shape, chunks, reps):
    x = np.empty(shape)
    check(tda.tile(tda.from_array(x, chunks=chunks), reps), np.tile(x, reps))


@pytest.mark.parametrize("repeats, axis", [(2, 0), (3, 1), (1, -1), (4, None), (0, 0)])
def test_repeat(rng, repeats, axis):
    x = rng.integers(0, 9, (5, 6))
    got = tda.repeat(tda.from_array(x, chunks=(2, 4)), repeats, axis=axis)
    want = jda.repeat(jda.from_array(x, chunks=(2, 4)), repeats, axis=axis)
    check(got, np.repeat(x, repeats, axis=axis), want)


@pytest.mark.parametrize("counts, axis, chunks", [
    ([1, 2, 0, 3, 1], 0, (2, 4)),  # counts that cross the chunk borders
    ([0, 0, 0, 0, 0], 0, (2, 4)),
    ([3, 0, 1, 0, 2, 5], 1, (5, 1)),
    (np.arange(30) % 4, None, (2, 4)),
    ([2], 1, (3, 2)),  # one count for every element
    (np.array([1, 1, 2, 0, 1], np.uint8), -2, (1, 6)),
])
def test_repeat_per_element_counts(rng, counts, axis, chunks):
    x = rng.integers(0, 9, (5, 6))
    got = tda.repeat(tda.from_array(x, chunks=chunks), counts, axis=axis)
    want = jda.repeat(jda.from_array(x, chunks=chunks), counts, axis=axis)
    check(got, np.repeat(x, counts, axis=axis), want)
    check(tda.from_array(x, chunks=chunks).repeat(counts, axis=axis), np.repeat(x, counts, axis=axis))


def test_repeat_counts_are_checked_as_numpy_checks_them():
    x = tda.arange(4, chunks=2)
    with pytest.raises(ValueError, match="negative"):
        tda.repeat(x, [1, -1, 0, 2])
    with pytest.raises(ValueError, match="broadcast"):
        tda.repeat(x, [1, 2, 3])
    with pytest.raises(ValueError, match="negative"):
        tda.repeat(x, -2)


@pytest.mark.parametrize("indexing", ["ij", "xy"])
@pytest.mark.parametrize("sparse", [False, True])
def test_meshgrid(indexing, sparse):
    a = np.arange(3)
    b = np.linspace(0, 1, 4)
    c = np.array([7, 8])
    got = tda.meshgrid(tda.from_array(a, chunks=2), b, c, indexing=indexing, sparse=sparse)
    want = np.meshgrid(a, b, c, indexing=indexing, sparse=sparse)
    for g, w in zip(got, want):
        check(g, w, check_chunks=False)
    x_d, y_d = tda.meshgrid([1, 2, 3], np.array([4, 5, 6, 7]), indexing="ij")
    x, y = np.meshgrid([1, 2, 3], np.array([4, 5, 6, 7]), indexing="ij")
    check(x_d * y_d, x * y)
    with pytest.raises(ValueError, match="indexing"):
        tda.meshgrid(a, indexing="ab")


def test_indices():
    chunks = ((1, 4, 2, 3), (5, 5))
    darr = tda.indices((10, 10), chunks=chunks)
    assert darr.chunks == ((1, 1),) + chunks == jda.indices((10, 10), chunks=chunks).chunks
    check(darr, np.indices((10, 10)))
    check(tda.indices((3, 4, 2), dtype=float, chunks=2), np.indices((3, 4, 2), dtype=float))
    empty = tda.indices((0,), float, chunks=(1,))
    assert empty.shape == np.indices((0,), float).shape and empty.dtype == np.float64
    assert tda.indices((), chunks=()).shape == np.indices(()).shape
    with pytest.raises(ValueError):
        tda.indices((1,), chunks=tuple())


def test_fromfunction():
    def f(i, j, scale=1):
        return (i * 10 + j) * scale

    got = tda.fromfunction(f, shape=(4, 5), chunks=2, dtype=float, scale=2)
    want = jda.fromfunction(f, shape=(4, 5), chunks=2, dtype=float, scale=2)
    check(got, np.fromfunction(f, (4, 5), dtype=float, scale=2), want)
