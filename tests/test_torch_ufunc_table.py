"""The rest of numpy's ufuncs and elementwise functions through the port,
held against numpy and the JAX package on the CPU.

Each case runs one program on arrays of several chunks made from a numpy
seed: through ``dask_array_tpu_torch``, through ``dask_array_tpu`` and
through numpy.  The port must give numpy's dtype always, and numpy's
values: exactly for integer, bool and layout results (``spacing``,
``nextafter``, ``frexp``, ``modf``, ``ldexp``, ``fix``... are exact in
every float dtype too), to 2 units in the last place for ``cbrt``, ``i0``
and ``sinc`` in float32/float64 (torch's ``sin``/``pow``/``i0`` are not
numpy's), to 4 for the other transcendental ones and to 64 for complex
``float_power``.  Float16 and float32 ``i0`` are held against numpy's
float64 ``i0`` rounded to the dtype: numpy's own float32 loop is up to 5
units off, its float16 one overflows from 12 on (``i0(12) = 18940`` fits).

The inputs hold NaN, ±inf, ±0, the smallest subnormal, the largest and
smallest finite values and exact cubes, in bool, int8...int64,
uint8...uint64, float16/32/64 and complex64/128, wherever numpy defines
the function; where numpy refuses the dtype, the port must refuse it too.
Where the JAX package differs from numpy (``KNOWN_REFERENCE_FAULTS``), the
port pins numpy.
"""

import warnings

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu_torch import config as tconfig

torch.set_num_threads(1)

DTYPES = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
          "float16", "float32", "float64", "complex64", "complex128"]
CHUNKS = (2, 3)
SHAPE = (5, 7)


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


def data(dtype, seed=1):
    """Special values of ``dtype`` first, random values after."""
    dt = np.dtype(dtype)
    rng = np.random.default_rng(seed)
    n = int(np.prod(SHAPE))
    if dt.kind == "b":
        return rng.integers(0, 2, SHAPE).astype(bool)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        special = [0, 1, info.max, info.min, 2, 3, 6, 12, 27, info.max - 1]
        if dt.kind == "i":
            special += [-1, -8, -27, info.min + 1]
        rest = rng.integers(info.min, info.max, n - len(special), dtype=dt, endpoint=True)
        return np.concatenate([np.array(special, dt), rest]).reshape(SHAPE)
    real = np.dtype(dt.char.lower() if dt.kind == "c" else dt)
    real = np.dtype({"F": np.float32, "D": np.float64}.get(dt.char, real))
    fi = np.finfo(real)
    special = [np.nan, np.inf, -np.inf, 0.0, -0.0, fi.smallest_subnormal, -fi.smallest_subnormal, fi.max,
               -fi.max, fi.tiny, 1.0, -1.0, 27.0, -8.0, 0.5, 2.5, -2.5, 1e-3]
    with np.errstate(all="ignore"):
        rest = (rng.standard_normal(n - len(special)) * 10).astype(real)
        vals = np.concatenate([np.array(special, real), rest])
        if dt.kind == "c":
            im = np.roll(vals, 3) * np.where(np.arange(n) % 4 == 0, 0, 1).astype(real)
            return (vals + 1j * im).astype(dt).reshape(SHAPE)
        return vals.reshape(SHAPE)


def quiet(fn, *args, **kwargs):
    with warnings.catch_warnings(), np.errstate(all="ignore"):
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


def agree(got, want, ulps):
    """Equal dtype and shape; equal values (NaN matching NaN, the sign of a
    zero too), floats to ``ulps`` units of ``want``'s last place."""
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if want.dtype.kind not in "fc":
        return bool(np.array_equal(got, want))
    if ulps == 0:
        zero = (want == 0) & (got == 0)
        if want.dtype.kind == "f" and not np.array_equal(np.signbit(got[zero]), np.signbit(want[zero])):
            return False
        return bool(np.array_equal(got, want, equal_nan=True))
    with np.errstate(all="ignore"):
        tol = ulps * np.abs(np.spacing(np.abs(want).astype(want.real.dtype)))
        ok = (np.abs(got - want) <= tol) | (got == want) | (np.isnan(got) & np.isnan(want))
    return bool(np.all(ok))


# units in the last place each function is held to (0: exact); complex
# float_power is torch's exp(b * log(a)), numpy's cpow differs by up to ~50
ULPS = {"cbrt": 2, "i0": 2, "sinc": 2, "degrees": 2, "radians": 1, "angle": 4, "float_power": 4,
        ("float_power", "c"): 64}

# the JAX package's results that differ from numpy's on these inputs, the
# port pinning numpy: int32/uint32 inputs taken in float32 (numpy: float64)
# and narrow ints or bool in other float types than numpy's (fix, i0, sinc,
# float_power, frexp, modf), float subnormals flushed to zero (cbrt,
# radians, spacing, frexp, modf, ldexp, heaviside), float16 spacing of
# negative values, complex angle, isreal, iscomplex and sinc, and divmod by 0
_FAULTS = {
    "angle": "complex64 complex128", "cbrt": "float32 float64 int32 uint32", "degrees": "int32 uint32",
    "divmod": "bool int8 int16 int32 int64 uint8 uint16 uint32 uint64 float32 float64", "fabs": "int32 uint32",
    "fix": "bool int8 int16 uint8 uint16",
    "float_power": "int8 int16 int32 uint8 uint16 uint32 float16 float32 complex64 complex128",
    "frexp": "bool int8 int32 uint8 uint32 float32 float64", "heaviside": "float32 float64",
    "i0": "bool int8 int16 int32 uint8 uint16 uint32", "iscomplex": "complex64 complex128",
    "isreal": "complex64 complex128", "ldexp": "int32 float64",
    "modf": "bool int8 int32 uint8 uint32 float16 float32 float64", "nextafter": "int32 uint32",
    "radians": "int32 uint32 float32 float64",
    "sinc": "bool int8 int16 int32 uint8 uint16 uint32 float16 complex64 complex128",
    "spacing": "int32 uint32 float16",
}
KNOWN_REFERENCE_FAULTS = {(name, dt) for name, dts in _FAULTS.items() for dt in dts.split()}
# the JAX package's float results are held to 1e-12 relative, not ulps
REFERENCE_ULPS = 4500

UNARY = ["fabs", "cbrt", "degrees", "radians", "isneginf", "isposinf", "signbit", "spacing", "real", "imag",
         "angle", "i0", "sinc", "nan_to_num", "fix", "isreal", "iscomplex"]
BINARY = ["float_power", "nextafter", "heaviside", "gcd", "lcm"]


def lazy(mod, arrays):
    return [mod.from_array(a, chunks=CHUNKS) for a in arrays]


def reference_of(name, arrays, dtype):
    """The numpy result of ``name`` (float16/float32 ``i0`` through float64)."""
    if name == "i0" and np.dtype(dtype) in (np.float16, np.float32):
        return quiet(lambda: np.i0(arrays[0].astype(np.float64)).astype(dtype))
    return quiet(getattr(np, name), *arrays)


def reference_inputs(name, arrays):
    """The inputs the JAX package is held to numpy on: its gcd and lcm
    never end on a signed type's minimum (|min| overflows), so they get
    the inputs' residues mod 100."""
    if name in ("gcd", "lcm"):
        return tuple((a.astype(np.int64) % 100).astype(a.dtype) for a in arrays)
    return arrays


def check(name, arrays, dtype, port_fn, ref_fn):
    try:
        want = reference_of(name, arrays, dtype)
    except TypeError:
        with pytest.raises(TypeError):
            quiet(lambda: port_fn(*lazy(tda, arrays)).compute())
        return
    got = quiet(lambda: port_fn(*lazy(tda, arrays)).compute())
    ulps = ULPS.get((name, np.dtype(dtype).kind), ULPS.get(name, 0))
    assert agree(got, want, ulps), (name, dtype, got, want)
    if (name, dtype) in KNOWN_REFERENCE_FAULTS:
        return
    arrays = reference_inputs(name, arrays)
    want = reference_of(name, arrays, dtype)
    ref = quiet(lambda: ref_fn(*lazy(jda, arrays)).compute())
    assert agree(ref, want, REFERENCE_ULPS), f"the JAX package now differs from numpy in {name} {dtype}"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", UNARY)
def test_unary(name, dtype):
    check(name, (data(dtype),), dtype, getattr(tda, name), getattr(jda, name))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", BINARY)
def test_binary(name, dtype):
    check(name, (data(dtype), data(dtype, seed=2)), dtype, getattr(tda, name), getattr(jda, name))


@pytest.mark.parametrize("exp_dtype", ["int8", "int32", "int64"])
@pytest.mark.parametrize("dtype", ["int8", "int32", "float16", "float32", "float64"])
def test_ldexp(dtype, exp_dtype):
    e = (np.arange(35).reshape(SHAPE) * 7 % 61 - 30).astype(exp_dtype)
    if np.dtype(dtype) == np.float64:
        e = (e.astype(np.int64) * 40).astype(exp_dtype) if exp_dtype != "int8" else e
    check("ldexp", (data(dtype), e), dtype, tda.ldexp, jda.ldexp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["frexp", "modf", "divmod"])
def test_two_outputs(name, dtype):
    arrays = (data(dtype),) + ((data(dtype, seed=3),) if name == "divmod" else ())
    try:
        want = quiet(getattr(np, name), *arrays)
    except TypeError:
        # (the port's divmod refuses complex as its floor_divide does: no dtype)
        with pytest.raises((TypeError, ValueError)):
            quiet(lambda: [o.compute() for o in getattr(tda, name)(*lazy(tda, arrays))])
        return
    got = quiet(lambda: tda.compute(*getattr(tda, name)(*lazy(tda, arrays))))
    for g, w in zip(got, want):
        # exact, a NaN's sign aside (torch and numpy differ in NaN payloads)
        assert agree(np.where(np.isnan(w), np.nan, g) if w.dtype.kind == "f" else g, w, 0), (name, dtype, g, w)
    if (name, dtype) in KNOWN_REFERENCE_FAULTS:
        return
    ref = quiet(lambda: [o.compute() for o in getattr(jda, name)(*lazy(jda, arrays))])
    for r, w in zip(ref, want):
        assert agree(r, w, REFERENCE_ULPS), f"the JAX package now differs from numpy in {name} {dtype}"


def test_cbrt_of_exact_cubes_is_exact():
    cubes = np.array([27.0, -8.0, 0.125, 1e-300, 64.0**3, 2.0**-1074, -(3.0**30)])
    got = tda.cbrt(tda.from_array(cubes, chunks=3)).compute()
    np.testing.assert_array_equal(got[:5], [3.0, -2.0, 0.5, np.cbrt(1e-300), 64.0])
    np.testing.assert_array_equal(got, np.cbrt(cubes))


def test_spacing_of_float16_follows_numpys_half_loop():
    # numpy's float16 spacing steps toward +inf for every x: positive for a
    # negative half, and the smaller step below a power of two
    x = np.array([-1.0, -65504.0, -0.0, 1.0, 65504.0, -np.inf], np.float16)
    got = tda.spacing(tda.from_array(x, chunks=2)).compute()
    np.testing.assert_array_equal(got, np.spacing(x))


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "int64", "uint32", "uint64"])
def test_gcd_lcm_at_the_extremes(dtype):
    info = np.iinfo(dtype)
    a = np.array([info.min, info.max, 2 ** 40 if info.bits == 64 else info.max // 3, 0, info.max - 1, 6], dtype)
    b = np.array([0, info.max, 3 ** 30 if info.bits == 64 else 7, info.min, 3, 4], dtype)
    if dtype == "uint64":
        a[:2] = [2**63 + 6, 2**64 - 2]
        b[:2] = [2**63 + 9, 2**63]
    for name in ("gcd", "lcm"):
        got = getattr(tda, name)(tda.from_array(a, chunks=4), tda.from_array(b, chunks=4)).compute()
        want = quiet(getattr(np, name), a, b)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {dtype}")
        assert got.dtype == want.dtype


@pytest.mark.parametrize("dtype", ["int8", "uint8", "uint64", "float16", "float32", "complex64"])
def test_clip(dtype):
    a = data(dtype)
    lo, hi = (1, 100) if np.dtype(dtype).kind in "iu" else (-2.5, 3.5)
    want = quiet(np.clip, a, lo, hi)
    x = tda.from_array(a, chunks=CHUNKS)
    for got in (tda.clip(x, lo, hi), x.clip(lo, hi), np.clip(x, lo, hi)):
        assert agree(got.compute(), want, 0)
    assert agree(tda.clip(x, None, hi).compute(), quiet(np.clip, a, None, hi), 0)
    if np.dtype(dtype).kind == "c":
        return  # the JAX package refuses complex clip; numpy orders it
    ref = quiet(lambda: jda.clip(jda.from_array(a, chunks=CHUNKS), lo, hi).compute())
    assert agree(ref, want, REFERENCE_ULPS)


def test_clip_refuses_what_numpy_refuses():
    x = tda.from_array(np.arange(-3, 5, dtype=np.int8), chunks=3)
    with pytest.raises(OverflowError):
        tda.clip(x, 0, 300)
    with pytest.raises(ValueError, match="One of max or min"):
        tda.clip(x, None, None)


def test_frompyfunc_one_and_two_outputs():
    a, b = data("float32"), data("float32", seed=2)
    f = tda.frompyfunc(lambda p, q: p * 2 + q, 2, 1)
    jf = jda.frompyfunc(lambda p, q: p * 2 + q, 2, 1)
    x, y = tda.from_array(a, chunks=CHUNKS), tda.from_array(b, chunks=CHUNKS)
    want = quiet(lambda: a * 2 + b)
    assert agree(quiet(f(x, y).compute), want, 0)
    ref = quiet(jf(jda.from_array(a, chunks=CHUNKS), jda.from_array(b, chunks=CHUNKS)).compute)
    assert agree(ref, want, REFERENCE_ULPS)
    g = tda.frompyfunc(lambda p: (p + 1, p * p), 1, 2)
    o1, o2 = g(x)
    assert agree(quiet(o1.compute), a + 1, 0)
    assert agree(quiet(o2.compute), quiet(lambda: a * a), 0)


def test_wrap_elemwise_and_dispatch():
    a = data("float64")
    x = tda.from_array(a, chunks=CHUNKS)
    double = tda.wrap_elemwise(lambda t: t * 2, name="double")
    assert agree(double(x).compute(), a * 2, 0)
    # NEP-13 and NEP-18 reach the port's functions
    for np_fn in (np.fabs, np.cbrt, np.spacing, np.real, np.imag, np.fix, np.nan_to_num, np.isposinf):
        out = quiet(np_fn, x)
        assert isinstance(out, tda.Array), np_fn
        assert agree(quiet(out.compute), quiet(np_fn, a), ULPS.get(np_fn.__name__, 0))
    m, e = np.frexp(x)
    assert agree(e.compute(), np.frexp(a)[1], 0)


def test_nan_to_num_keywords():
    a = data("complex128")
    for kw in ({}, {"nan": 1.5, "posinf": 9.0, "neginf": -9.0}):
        got = tda.nan_to_num(tda.from_array(a, chunks=CHUNKS), **kw).compute()
        assert agree(got, np.nan_to_num(a, **kw), 0)


def test_angle_in_degrees():
    a = data("complex64")
    got = tda.angle(tda.from_array(a, chunks=CHUNKS), deg=True).compute()
    assert agree(got, quiet(np.angle, a, deg=True), 4)


def test_real_and_imag_attributes():
    a = data("complex64")
    x = tda.from_array(a, chunks=CHUNKS)
    assert agree(x.real.compute(), a.real, 0) and agree(x.imag.compute(), a.imag, 0)
    b = data("int16")
    y = tda.from_array(b, chunks=CHUNKS)
    assert agree(y.real.compute(), b.real, 0) and agree(y.imag.compute(), b.imag, 0)


def test_constants_and_dtype_names():
    for name in ("e", "pi", "nan", "inf", "euler_gamma", "newaxis"):
        got, want = getattr(tda, name), getattr(jda, name)
        assert got is want or got == want or (np.isnan(got) and np.isnan(want)), name
    for name in ("bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64", "float32",
                 "float64", "complex64", "complex128"):
        assert getattr(tda, name) is getattr(jda, name) is getattr(np, name if name != "bool" else "bool_")
    assert tda.array([1, 2], ndmin=2).shape == (1, 2)
    assert tda.asanyarray(np.ones(3)).compute().tolist() == [1.0, 1.0, 1.0]
    x = tda.from_array(np.ones((4, 4)), chunks=2) + 1
    assert tda.optimize(x).compute().sum() == 32 and tda.optimize(3) == 3
