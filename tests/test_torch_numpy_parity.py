"""The port against numpy where it used to differ: unsigned sums and
products, ``sign``, ``abs`` of bool, ``rint`` of complex, numpy's complex
ordering, and bool results of ``vdot`` and ``**``.

Every case runs the same numpy inputs through ``dask_array_tpu_torch`` on
the CPU and compares values and dtypes with numpy, exactly: NaN matches NaN
in the same place, and complex results are compared part by part, so the
NaN numpy picks (the first one in the reduced order) must be the port's
too.  Where the JAX package agrees with numpy (the unsigned reductions,
float ``sign``, complex ``sign`` of finite values, ``abs`` of bool,
complex ``rint``, the comparisons of NaN-free values, ``nanmax``/``nanmin``
and NaN-free ``max``/``min``) the port is held against it as well;
elsewhere the JAX package differs from numpy (a comparison or ``maximum``
with a NaN part, complex ``argmax`` raises, ``vdot`` of bools is int8,
``bool ** 2`` is int64) and the port pins numpy.
"""

import warnings

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu_torch import config as tconfig

torch.set_num_threads(1)

nan, inf = np.nan, np.inf


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


def same(got, want):
    """Equal dtype and shape, and equal values with NaN matching NaN (a
    complex array compared part by part)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind == "c":
        np.testing.assert_array_equal(got.real, want.real)
        np.testing.assert_array_equal(got.imag, want.imag)
        return
    np.testing.assert_array_equal(got, want)


def numpy_quiet(fn, *args, **kwargs):
    with warnings.catch_warnings(), np.errstate(all="ignore"):
        warnings.simplefilter("ignore", RuntimeWarning)
        return fn(*args, **kwargs)


# -- unsigned sums and products ---------------------------------------------------

UNSIGNED = np.array([[1, 2, 250, 255, 0], [255, 7, 255, 128, 3], [9, 255, 1, 2, 255]], dtype=np.uint8)
# 255**15 wraps past 2**64: numpy's uint64 product is modular, and so is
# the port's int64 accumulation of the same bits
WRAPPING = np.full((3, 15), 255, dtype=np.uint8)
BOOLS = np.array([[True, False, True, True], [False, False, True, False], [True, True, True, True]])
REDUCTIONS = ["sum", "prod", "nansum", "nanprod"]
SCANS = ["cumsum", "cumprod", "nancumsum", "nancumprod"]


@pytest.mark.parametrize("data", [UNSIGNED, WRAPPING, BOOLS], ids=["uint8", "uint8_wrapping", "bool"])
@pytest.mark.parametrize("kind", REDUCTIONS + SCANS)
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_unsigned_and_bool_sums_and_products(data, kind, axis):
    want = getattr(np, kind)(data, axis=axis)
    got = getattr(tda, kind)(tda.from_array(data, chunks=2), axis=axis).compute()
    same(got, want)
    if data.dtype == np.uint8:
        assert np.asarray(got).dtype == np.uint64
        same(got, getattr(jda, kind)(jda.from_array(data, chunks=2), axis=axis).compute())


@pytest.mark.parametrize("kind", REDUCTIONS)
def test_unsigned_reductions_keepdims_and_dtype(kind):
    x = tda.from_array(UNSIGNED, chunks=(2, 3))
    same(getattr(tda, kind)(x, axis=1, keepdims=True).compute(), getattr(np, kind)(UNSIGNED, axis=1, keepdims=True))
    # a signed input asked for uint64 wraps as numpy's cast does
    signed = UNSIGNED.astype(np.int32) - 200
    same(getattr(tda, kind)(tda.from_array(signed, chunks=2), dtype=np.uint64).compute(),
         getattr(np, kind)(signed, dtype=np.uint64))


@pytest.mark.parametrize("offset", [0, 1, -1])
def test_unsigned_trace(offset):
    sq = np.arange(25, dtype=np.uint8).reshape(5, 5) * 11
    want = np.trace(sq, offset=offset)
    got = tda.trace(tda.from_array(sq, chunks=2), offset=offset).compute()
    same(got, want)
    same(got, jda.trace(jda.from_array(sq, chunks=2), offset=offset).compute())


def test_unsigned_generic_tree_reduction_combines_in_int64():
    """``reduction`` with dtype uint64: the user functions see int64
    partials (torch computes little in uint64), the result is numpy's
    uint64 bits."""
    def chunk(b, axis, keepdims):
        assert b.dtype == torch.uint8
        return torch.prod(b.to(torch.int64).flatten(), dim=0).reshape((1,) * b.ndim)

    def combine(b, axis, keepdims):
        assert b.dtype == torch.int64
        out = torch.prod(b.flatten(), dim=0)
        return out.reshape((1,) * b.ndim) if keepdims else out

    x = tda.from_array(WRAPPING, chunks=(1, 4))
    got = tda.reduction(x, chunk, combine, combine=combine, dtype=np.uint64, split_every=2).compute()
    same(got, np.prod(WRAPPING, dtype=np.uint64))


def test_unsigned_sum_feeds_a_float_op():
    """A uint64 result read by a float op: converted from its bits."""
    x = tda.from_array(UNSIGNED, chunks=2)
    same((tda.sum(x, axis=0) / 2).compute(), np.sum(UNSIGNED, axis=0) / 2)


# -- sign, absolute, rint ----------------------------------------------------------

FLOATS = [nan, -1.5, 2.0, -0.0, 0.0, inf, -inf, 1e-30, -3e38]
COMPLEX_SPECIAL = [complex(inf, 0), complex(inf, inf), complex(-inf, 1), complex(nan, 0), complex(0, nan),
                   complex(nan, inf), complex(1, -inf), 0j, complex(-0.0, 0), complex(3, -4), complex(1e-300, 0),
                   complex(1e300, 1e300), complex(-2, 0)]
COMPLEX_FINITE = [complex(3, -4), 0j, complex(-1, 2), complex(0, -5), complex(1e-3, 7)]


@pytest.mark.parametrize("dtype", ["float16", "float32", "float64"])
def test_sign_of_nan_is_nan(dtype):
    x = np.array(FLOATS, dtype=dtype)
    want = numpy_quiet(np.sign, x)
    got = tda.sign(tda.from_array(x, chunks=4)).compute()
    same(got, want)
    same(got, jda.sign(jda.from_array(x, chunks=4)).compute())


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_sign_of_complex_is_z_over_abs(dtype):
    z = np.array(COMPLEX_SPECIAL, dtype=dtype)
    same(tda.sign(tda.from_array(z, chunks=4)).compute(), numpy_quiet(np.sign, z))
    zf = np.array(COMPLEX_FINITE, dtype=dtype)
    got = tda.sign(tda.from_array(zf, chunks=2)).compute()
    np.testing.assert_allclose(got, np.sign(zf), rtol=1e-6 if dtype == "complex64" else 1e-15)
    np.testing.assert_allclose(got, jda.sign(jda.from_array(zf, chunks=2)).compute(), rtol=1e-6)


@pytest.mark.parametrize("form", ["absolute", "abs", "builtin", "numpy"])
def test_absolute_of_bool_is_itself(form):
    b = np.array([[True, False, True], [False, False, True]])
    x = tda.from_array(b, chunks=2)
    got = {"absolute": lambda: tda.absolute(x), "abs": lambda: tda.abs(x), "builtin": lambda: abs(x),
           "numpy": lambda: np.abs(x)}[form]().compute()
    same(got, np.absolute(b))
    same(got, jda.absolute(jda.from_array(b, chunks=2)).compute())


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_rint_of_complex_rounds_each_part_half_to_even(dtype):
    z = np.array([2.5 + 0.5j, -1.5 - 2.5j, complex(nan, 1.5), 3.5 - 0.5j, complex(-0.4, inf), 1e20 + 0.5j],
                 dtype=dtype)
    got = tda.rint(tda.from_array(z, chunks=2)).compute()
    same(got, np.rint(z))
    same(got, jda.rint(jda.from_array(z, chunks=2)).compute())


# -- complex ordering --------------------------------------------------------------

# pairs with NaN in either part of either operand, ties of the real part,
# and signed zeros
ZA = np.array([1 + 1j, 1 + 2j, complex(nan, 0), complex(1, nan), 2 - 1j, 0j, complex(nan, nan), 3 + 0j,
               complex(2, nan), complex(-1, 5), complex(inf, 0), complex(1, -inf)])
ZB = np.array([1 + 2j, 1 + 1j, 1 + 1j, complex(1, 0), complex(nan, nan), -0j, complex(nan, 1), complex(3, nan),
               complex(1, 0), complex(-1, 5), complex(inf, 1), complex(1, -inf)])
COMPARISONS = ["greater", "greater_equal", "less", "less_equal"]
EXTREMA = ["maximum", "minimum", "fmax", "fmin"]
OPERATOR = {"greater": lambda a, b: a > b, "greater_equal": lambda a, b: a >= b,
            "less": lambda a, b: a < b, "less_equal": lambda a, b: a <= b}


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
@pytest.mark.parametrize("op", COMPARISONS + EXTREMA)
def test_complex_elementwise_order(op, dtype):
    za, zb = ZA.astype(dtype), ZB.astype(dtype)
    a, b = tda.from_array(za, chunks=5), tda.from_array(zb, chunks=5)
    want = numpy_quiet(getattr(np, op), za, zb)
    got = getattr(tda, op)(a, b).compute()
    same(got, want)
    if op in OPERATOR:
        same(OPERATOR[op](a, b).compute(), want)
        # the JAX package agrees with numpy where no part is NaN (with a NaN
        # imaginary part it lets the real parts decide)
        clean = ~(np.isnan(za) | np.isnan(zb))
        ja, jb = jda.from_array(za[clean], chunks=5), jda.from_array(zb[clean], chunks=5)
        same(got[clean], getattr(jda, op)(ja, jb).compute())


@pytest.mark.parametrize("op", COMPARISONS + EXTREMA)
@pytest.mark.parametrize("scalar", [1 + 1j, complex(nan, 0), 2.0, 1])
def test_complex_order_against_a_scalar(op, scalar):
    a = tda.from_array(ZA, chunks=5)
    same(getattr(tda, op)(a, scalar).compute(), numpy_quiet(getattr(np, op), ZA, scalar))
    same(getattr(tda, op)(scalar, a).compute(), numpy_quiet(getattr(np, op), scalar, ZA))


def test_complex_extremum_of_finite_values_matches_the_jax_package():
    za = np.array([1 + 1j, 1 + 2j, 2 - 1j, -3j, 5 + 0j])
    zb = np.array([1 + 2j, 1 + 1j, 2 + 1j, 1j, 4 + 9j])
    for op in EXTREMA:
        got = getattr(tda, op)(tda.from_array(za, chunks=2), tda.from_array(zb, chunks=2)).compute()
        same(got, getattr(np, op)(za, zb))
        same(got, getattr(jda, op)(jda.from_array(za, chunks=2), jda.from_array(zb, chunks=2)).compute())


# rows: NaN-free; a NaN in the real part; a NaN in the imaginary part after
# the maximum; two NaNs (numpy returns the first); all NaN; ties
ZM = np.array([
    [1 + 1j, 3 - 1j, 3 + 2j, -2 + 0j, 3 + 2j],
    [complex(2, 0), complex(nan, 1), 0j, 5 + 0j, 1j],
    [7 + 0j, 1j, complex(7, nan), 7 - 1j, 2 + 2j],
    [complex(1, nan), 4 + 0j, complex(nan, 3), 9j, -1 + 0j],
    [complex(nan, 0), complex(nan, 1), complex(0, nan), complex(nan, nan), complex(nan, 2)],
    [2 + 2j, 2 + 2j, 1 + 9j, 2 + 2j, -5j],
])
REDUCE = ["max", "min", "nanmax", "nanmin"]
ARGS = ["argmax", "argmin", "nanargmax", "nanargmin"]


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
@pytest.mark.parametrize("kind", REDUCE + ARGS)
def test_complex_reductions_along_rows(kind, dtype):
    z = ZM.astype(dtype)
    rows = z if not kind.startswith("nanarg") else z[:4]  # numpy raises on the all-NaN row
    x = tda.from_array(rows, chunks=(2, 2))
    same(getattr(tda, kind)(x, axis=1).compute(), numpy_quiet(getattr(np, kind), rows, axis=1))
    same(getattr(tda, kind)(x, axis=1, keepdims=True).compute(),
         numpy_quiet(getattr(np, kind), rows, axis=1, keepdims=True))


@pytest.mark.parametrize("kind", REDUCE + ARGS)
@pytest.mark.parametrize("axis", [None, 0])
def test_complex_reductions_whole_and_by_column(kind, axis):
    clean = np.array([[1 + 1j, 3 - 1j, 3 + 2j], [-2 + 0j, 3 + 2j, 0j], [3 + 2j, 3 + 1j, -4j]])
    x = tda.from_array(clean, chunks=2)
    got = getattr(tda, kind)(x, axis=axis).compute()
    same(got, getattr(np, kind)(clean, axis=axis))
    if kind in REDUCE:
        same(got, getattr(jda, kind)(jda.from_array(clean, chunks=2), axis=axis).compute())


@pytest.mark.parametrize("kind", ["nanmax", "nanmin"])
def test_complex_nan_reductions_match_the_jax_package(kind):
    rows = ZM[:4]
    got = getattr(tda, kind)(tda.from_array(rows, chunks=2), axis=1).compute()
    same(got, numpy_quiet(getattr(np, kind), rows, axis=1))
    same(got, getattr(jda, kind)(jda.from_array(rows, chunks=2), axis=1).compute())


def test_complex_nanargmax_of_an_all_nan_slice_raises():
    with pytest.raises(ValueError, match="All-NaN"):
        tda.nanargmax(tda.from_array(ZM, chunks=2), axis=1).compute()


# -- bool results ------------------------------------------------------------------


def test_vdot_of_bools_is_bool():
    a = np.array([True, False, True, False])
    b = np.array([False, False, True, True])
    for u, v in ((a, b), (a, ~a), (a, a)):
        same(tda.vdot(tda.from_array(u, chunks=3), tda.from_array(v, chunks=3)).compute(), np.vdot(u, v))


def test_vdot_still_conjugates_a_complex_first_operand():
    a = np.array([1 + 2j, 3 - 1j, -2j])
    b = np.array([2 - 1j, 1j, 4 + 0j])
    np.testing.assert_allclose(tda.vdot(tda.from_array(a, chunks=2), tda.from_array(b, chunks=2)).compute(),
                               np.vdot(a, b), rtol=1e-15)


@pytest.mark.parametrize("dtype", ["bool", "int8", "uint8", "int32", "float16", "float32", "complex64"])
@pytest.mark.parametrize("exponent", [2, 2.0, np.int64(2), np.float32(2.0), np.array(2), 3, 0, 1, -1, 0.5])
def test_power_by_a_scalar_follows_numpy(dtype, exponent):
    """ndarray ** scalar takes numpy's shortcut: a bool array squared is
    int8, an integer array to a float 2 is float64."""
    x = np.array([[0, 1, 2], [3, 0, 1]]).astype(dtype)
    if dtype == "float32":
        x = np.array([[-inf, -0.0, 2.5], [nan, 4.0, -1.0]], dtype=dtype)
    try:
        want = numpy_quiet(lambda: x ** exponent)
    except (ValueError, OverflowError):  # integers to a negative power
        with pytest.raises(Exception):
            (tda.from_array(x, chunks=2) ** exponent).compute()
        return
    got = (tda.from_array(x, chunks=2) ** exponent).compute()
    if np.asarray(want).dtype.kind in "fc" and dtype != "float32":
        np.testing.assert_allclose(got, want, rtol=1e-3)
        assert np.asarray(got).dtype == np.asarray(want).dtype
    else:
        same(got, want)
