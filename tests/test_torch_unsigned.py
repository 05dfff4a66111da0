"""numpy's unsigned integers through the port: uint8, uint16, uint32 and
uint64 arrays in, through every ufunc and reduction, back through
``compute()`` with numpy's values and dtypes (NEP 50 promotion included).

torch holds uint16/32/64 tensors but computes almost nothing in them, so
the port computes uint16 in int32, uint32 in int64 and uint64 in the bits
of an int64 (``_chunks.compute_dtype``); these tests hold every result
against numpy exactly (floats to a few ulps: torch's CPU transcendental
functions are not numpy's), on inputs holding 0, 1, the type's maximum,
2**31 and 2**63 where they fit, and random values from a numpy seed, in
arrays of several chunks.

Each ufunc case runs through the JAX package too and is held against it
where it agrees with numpy.  Where it does not (``KNOWN_REFERENCE_FAULTS``:
XLA's integer division by zero, its integer ``reciprocal`` and ``power``,
float ufuncs of uint32 taken in float32, ``uint64 < 2**63`` raising
OverflowError) the port pins numpy.
"""

import warnings

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.ops.ufuncs import _TABLE

torch.set_num_threads(1)

UNSIGNED = ["uint8", "uint16", "uint32", "uint64"]
CHUNKS = (2, 3)


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


def data(dtype, seed=1, shape=(5, 7)):
    """0, 1, the maximum and its neighbour, 2**31 and 2**63 where they fit,
    then random values of ``dtype``."""
    info = np.iinfo(dtype)
    special = [0, 1, info.max, info.max - 1] + [v for v in (2**31, 2**63, 2**63 - 1, 255) if v <= info.max]
    rng = np.random.default_rng(seed)
    rest = rng.integers(0, info.max, size=int(np.prod(shape)) - len(special), dtype=dtype, endpoint=True)
    return np.concatenate([np.array(special, dtype), rest]).reshape(shape)


def small(dtype, shape=(5, 7)):
    """0 .. 68 in steps of 2: shift counts past every width, and exponents."""
    return (np.arange(int(np.prod(shape))).reshape(shape) * 2).astype(dtype)


def quiet(fn, *args, **kwargs):
    with warnings.catch_warnings(), np.errstate(all="ignore"):
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


def agree(got, want, ulps=8):
    """Equal dtype and shape; equal values, floats to ``ulps`` units in the
    last place with NaN matching NaN."""
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if want.dtype.kind in "fc":
        rtol = ulps * np.finfo(want.dtype).eps
        return bool(np.allclose(got, want, rtol=rtol, atol=0, equal_nan=True))
    return bool(np.array_equal(got, want))


def same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert agree(got, want), (got, want)


# the JAX package's results that differ from numpy's, the port pinning
# numpy: XLA's integer division by zero, reciprocal and power; every float
# function of a uint32, and true division of uint8/uint16, taken in float32
KNOWN_REFERENCE_FAULTS = (
    {(name, dt) for name in ("floor_divide", "reciprocal", "power") for dt in UNSIGNED}
    | {(name, dt) for name in ("divide", "true_divide") for dt in ("uint8", "uint16")}
)
# the JAX package's float results are held to 1e-12, not a few ulps
REFERENCE_ULPS = 4500


def _accepts_unsigned(name):
    fn = getattr(np, name)
    try:
        fn.resolve_dtypes((np.dtype(np.uint16),) * fn.nin + (None,) * fn.nout)
    except TypeError:
        return False
    return True


UNARY = sorted(n for n, f in _TABLE.items() if getattr(np, n).nin == 1 and _accepts_unsigned(n))
BINARY = sorted(n for n, f in _TABLE.items() if getattr(np, n).nin == 2 and _accepts_unsigned(n))


def check_ufunc(name, arrays, dtype):
    want = quiet(getattr(np, name), *arrays)
    got = getattr(tda, name)(*[tda.from_array(a, chunks=CHUNKS) for a in arrays]).compute()
    same(got, want)
    ref = quiet(lambda: getattr(jda, name)(*[jda.from_array(a, chunks=CHUNKS) for a in arrays]).compute())
    if (name, dtype) in KNOWN_REFERENCE_FAULTS or (dtype == "uint32" and np.asarray(want).dtype.kind == "f"):
        return
    assert agree(ref, want, REFERENCE_ULPS), f"the JAX package now differs from numpy in {name} {dtype}"
    assert agree(got, ref, REFERENCE_ULPS)


@pytest.mark.parametrize("dtype", UNSIGNED)
@pytest.mark.parametrize("name", UNARY)
def test_unary_ufuncs(name, dtype):
    check_ufunc(name, (data(dtype),), dtype)


@pytest.mark.parametrize("dtype", UNSIGNED)
@pytest.mark.parametrize("name", BINARY)
def test_binary_ufuncs(name, dtype):
    second = small(dtype) if name in ("left_shift", "right_shift", "power") else data(dtype, seed=2)
    check_ufunc(name, (data(dtype), second), dtype)
    # the same with the operands swapped
    if name not in ("left_shift", "right_shift", "power"):
        check_ufunc(name, (second, data(dtype)), dtype)


@pytest.mark.parametrize("dtype", UNSIGNED)
@pytest.mark.parametrize("name", ["floor_divide", "remainder", "fmod"])
def test_division_by_zero_gives_numpys_zeros(name, dtype):
    a = data(dtype)
    b = data(dtype, seed=3)
    b[::2] = 0
    got = getattr(tda, name)(tda.from_array(a, chunks=CHUNKS), tda.from_array(b, chunks=CHUNKS)).compute()
    same(got, quiet(getattr(np, name), a, b))


# -- mixed promotion -------------------------------------------------------------

OTHERS = ["int8", "int16", "int32", "int64", "float32", "float64", "bool"]
MIXED_OPS = ["add", "subtract", "multiply", "less", "equal", "maximum", "floor_divide", "true_divide"]


@pytest.mark.parametrize("other", OTHERS)
@pytest.mark.parametrize("dtype", UNSIGNED)
@pytest.mark.parametrize("name", MIXED_OPS)
def test_mixed_promotion_with_arrays(name, dtype, other):
    a = data(dtype)
    rng = np.random.default_rng(4)
    b = (rng.standard_normal(a.shape) * 100).astype(other)
    for x, y in ((a, b), (b, a)):
        want = quiet(getattr(np, name), x, y)
        got = getattr(tda, name)(tda.from_array(x, chunks=CHUNKS), tda.from_array(y, chunks=CHUNKS)).compute()
        same(got, want)


@pytest.mark.parametrize("scalar", [1, 2**63 + 7, np.int64(-3), np.uint64(2**64 - 1), 2.5, True])
@pytest.mark.parametrize("dtype", UNSIGNED)
@pytest.mark.parametrize("name", MIXED_OPS + ["right_shift", "greater_equal", "not_equal"])
def test_mixed_promotion_with_scalars(name, dtype, scalar):
    a = data(dtype)
    x = tda.from_array(a, chunks=CHUNKS)
    for args, targs in (((a, scalar), (x, scalar)), ((scalar, a), (scalar, x))):
        try:
            want = quiet(getattr(np, name), *args)
        except (OverflowError, TypeError):  # NEP 50: the int does not fit, or no loop
            with pytest.raises(Exception):
                getattr(tda, name)(*targs).compute()
            continue
        same(getattr(tda, name)(*targs).compute(), want)


@pytest.mark.parametrize("scalar", [-1, 0, 2**63, 2**64 - 1, 2**64, 2**70])
@pytest.mark.parametrize("op", ["<", "<=", ">", ">=", "==", "!="])
def test_uint64_against_ints_outside_its_range(op, scalar):
    """numpy 2 compares a uint64 with any Python int exactly; the JAX
    package raises OverflowError from 2**63 on (a reference fault)."""
    a = data("uint64")
    x = tda.from_array(a, chunks=CHUNKS)
    fn = {"<": lambda p, q: p < q, "<=": lambda p, q: p <= q, ">": lambda p, q: p > q,
          ">=": lambda p, q: p >= q, "==": lambda p, q: p == q, "!=": lambda p, q: p != q}[op]
    same(fn(x, scalar).compute(), fn(a, scalar))
    same(fn(scalar, x).compute(), fn(scalar, a))


def test_reference_fault_uint64_below_2_63_raises_in_the_jax_package():
    a = data("uint64")
    with pytest.raises(OverflowError):
        (jda.from_array(a, chunks=CHUNKS) < 2**63).compute()
    same((tda.from_array(a, chunks=CHUNKS) < 2**63).compute(), a < 2**63)


def test_reference_fault_uint32_true_division_in_float32():
    a = np.array([2**31 + 2**21 + 3, 7, 2**32 - 1, 0], dtype=np.uint32)
    want = a / 3
    same((tda.from_array(a, chunks=2) / 3).compute(), want)
    ref = (jda.from_array(a, chunks=2) / 3).compute()
    assert not np.array_equal(ref, want)  # float32 precision: 7.15827904e+08
    np.testing.assert_allclose(ref, want, rtol=1e-7)


# -- reductions ----------------------------------------------------------------

REDUCTIONS = ["sum", "prod", "nansum", "nanprod", "max", "min", "nanmax", "nanmin", "mean", "nanmean",
              "any", "all"]
ARGS = ["argmax", "argmin", "nanargmax", "nanargmin"]
SCANS = ["cumsum", "cumprod", "nancumsum", "nancumprod"]
MOMENTS = ["var", "std", "nanvar", "nanstd"]


@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("dtype", UNSIGNED)
@pytest.mark.parametrize("kind", REDUCTIONS + ARGS + SCANS)
def test_reductions(kind, dtype, axis):
    a = data(dtype)
    want = quiet(getattr(np, kind), a, axis=axis)
    got = getattr(tda, kind)(tda.from_array(a, chunks=CHUNKS), axis=axis).compute()
    same(got, want)
    if axis != 1:
        ref = quiet(lambda: getattr(jda, kind)(jda.from_array(a, chunks=CHUNKS), axis=axis).compute())
        if agree(ref, want):
            same(got, ref)


@pytest.mark.parametrize("axis", [None, 0])
@pytest.mark.parametrize("dtype", UNSIGNED)
@pytest.mark.parametrize("kind", MOMENTS)
def test_moments(kind, dtype, axis):
    """Through numpy's float64 conversion (uint64 above 2**63 included);
    the one-pass shifted power sums round otherwise than numpy's two
    passes: rtol 1e-12."""
    a = data(dtype)
    want = quiet(getattr(np, kind), a, axis=axis)
    got = getattr(tda, kind)(tda.from_array(a, chunks=CHUNKS), axis=axis).compute()
    assert np.asarray(got).dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("dtype", UNSIGNED)
def test_trace_and_keepdims(dtype):
    a = data(dtype, shape=(6, 6))
    x = tda.from_array(a, chunks=4)
    for offset in (0, 1, -2):
        same(tda.trace(x, offset=offset).compute(), np.trace(a, offset=offset))
    same(tda.max(x, axis=1, keepdims=True).compute(), np.max(a, axis=1, keepdims=True))
    same(tda.sum(x, axis=0, keepdims=True).compute(), np.sum(a, axis=0, keepdims=True))
    same(tda.argmax(x, axis=0, keepdims=True).compute(), np.argmax(a, axis=0, keepdims=True))


@pytest.mark.parametrize("dtype", ["uint16", "uint32", "uint64"])
def test_generic_reduction_sees_computable_blocks(dtype):
    """``reduction()`` hands the user's functions uint16/32/64 blocks in the
    dtype torch computes them in (uint64 as its int64 bits)."""
    a = data(dtype)
    seen = []

    def chunk(b, axis, keepdims):
        seen.append(b.dtype)
        return torch.sum(b.to(torch.int64), dim=axis, keepdim=keepdims)

    def agg(b, axis, keepdims):
        return torch.sum(b, dim=axis, keepdim=keepdims)

    got = tda.reduction(tda.from_array(a, chunks=CHUNKS), chunk, agg, dtype=np.uint64).compute()
    same(got, np.sum(a, dtype=np.uint64))
    assert set(seen) == {torch.int32 if dtype == "uint16" else torch.int64}


def test_sliding_window_reductions_of_unsigned():
    a = data("uint64", shape=(41,))
    x = tda.from_array(a, chunks=8)
    v = np.lib.stride_tricks.sliding_window_view(a, 5)
    for kind in ("sum", "max", "min", "mean"):
        same(getattr(tda.sliding_window_view(x, 5), kind)(axis=-1).compute(), getattr(v, kind)(axis=-1))


# -- the cases that raised before -------------------------------------------------


def test_arithmetic_on_a_uint64_sum():
    x = tda.from_array(np.arange(42, dtype=np.uint8).reshape(6, 7), chunks=3)
    got = (x.sum() + 1).compute()
    assert got == np.uint64(862) and np.asarray(got).dtype == np.uint64
    a = np.arange(42, dtype=np.uint8).reshape(6, 7)
    same((x.sum(axis=0) * 2).compute(), a.sum(axis=0) * 2)
    same((x.sum(axis=1) - x.max()).compute(), a.sum(axis=1) - a.max())


@pytest.mark.parametrize("case", ["+ 1", "// 3", "< 2**31", "astype(float64)", "max", "-x", "x + x"])
def test_uint32_inputs(case):
    a = data("uint32")
    fn = {"+ 1": lambda v: v + 1, "// 3": lambda v: v // 3, "< 2**31": lambda v: v < 2**31,
          "astype(float64)": lambda v: v.astype(np.float64), "max": lambda v: v.max(), "-x": lambda v: -v,
          "x + x": lambda v: v + v}[case]
    same(fn(tda.from_array(a, chunks=CHUNKS)).compute(), quiet(fn, a))


@pytest.mark.parametrize("case", ["max", "argmax", "// 3", "% 7", ">> 1", "astype(float64)", "mean", "+ int64",
                                  "* 3", "-x", "min", "argmin", "astype(float32)", "astype(int64)"])
def test_uint64_above_2_63(case):
    a = np.array([[2**63 + 7, 5, 2**64 - 1], [0, 2**63, 2**63 - 1]], dtype=np.uint64)
    b = np.array([[-3, 4, 5], [-1, 9, 2]], dtype=np.int64)
    fn = {"max": lambda v, w: v.max(), "argmax": lambda v, w: v.argmax(), "// 3": lambda v, w: v // 3,
          "% 7": lambda v, w: v % 7, ">> 1": lambda v, w: v >> 1,
          "astype(float64)": lambda v, w: v.astype(np.float64), "mean": lambda v, w: v.mean(),
          "+ int64": lambda v, w: v + w, "* 3": lambda v, w: v * 3, "-x": lambda v, w: -v,
          "min": lambda v, w: v.min(), "argmin": lambda v, w: v.argmin(),
          "astype(float32)": lambda v, w: v.astype(np.float32), "astype(int64)": lambda v, w: v.astype(np.int64)}[case]
    got = fn(tda.from_array(a, chunks=2), tda.from_array(b, chunks=2)).compute()
    same(got, quiet(fn, a, b))


# -- casts ------------------------------------------------------------------------

IN_RANGE = {
    "float64": np.array([0.0, 1.5, 2.0**31, 4294967295.0, 2.0**63, 1.5e19, 65535.9, 7.25]),
    "float32": np.array([0.0, 1.5, 2.0**31, 2.0**63, 1.5e19, 65535.0, 7.25], dtype=np.float32),
    "int64": np.array([0, -1, 2**62, -(2**63), 70000, 2**40 + 5], dtype=np.int64),
    "int8": np.array([0, -1, 127, -128, 5], dtype=np.int8),
    "bool": np.array([True, False, True]),
}


@pytest.mark.parametrize("target", UNSIGNED)
@pytest.mark.parametrize("source", sorted(IN_RANGE))
def test_casts_into_unsigned(source, target):
    """Floats in range of the target (numpy's cast of an out-of-range float
    differs between its own loops), ints wrapped, bools as 0 and 1."""
    a = IN_RANGE[source]
    if source.startswith("float"):
        a = a[a <= np.iinfo(target).max]
    same(tda.from_array(a, chunks=2).astype(target).compute(), quiet(a.astype, target))


@pytest.mark.parametrize("target", ["bool", "int8", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
                                    "float16", "float32", "float64", "complex64", "complex128"])
@pytest.mark.parametrize("source", UNSIGNED)
def test_casts_out_of_unsigned(source, target):
    a = data(source)
    same(tda.from_array(a, chunks=CHUNKS).astype(target).compute(), quiet(a.astype, target))


# -- creation --------------------------------------------------------------------


@pytest.mark.parametrize("dtype", UNSIGNED)
def test_creation(dtype):
    top = np.iinfo(dtype).max
    same(tda.full((3, 5), top, dtype=dtype, chunks=2).compute(), np.full((3, 5), top, dtype=dtype))
    same(tda.ones((3, 5), dtype=dtype, chunks=2).compute(), np.ones((3, 5), dtype=dtype))
    same(tda.zeros((4,), dtype=dtype, chunks=3).compute(), np.zeros(4, dtype=dtype))
    same(tda.arange(3, 40, 3, dtype=dtype, chunks=4).compute(), np.arange(3, 40, 3, dtype=dtype))
    same(tda.eye(5, k=1, dtype=dtype, chunks=2).compute(), np.eye(5, k=1, dtype=dtype))
    same(tda.tri(4, 6, k=-1, dtype=dtype, chunks=3).compute(), np.tri(4, 6, k=-1, dtype=dtype))
    same(tda.asarray(data(dtype)).compute(), data(dtype))


# -- byte-exact layout -------------------------------------------------------------


def _bytes_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == np.ascontiguousarray(want).tobytes()


@pytest.mark.parametrize("dtype", UNSIGNED)
@pytest.mark.parametrize("op", ["transpose", "concatenate", "rechunk", "reversed", "pad-symmetric", "pad-wrap",
                                "pad-edge", "pad-constant", "map_overlap", "stack", "reshape"])
def test_layout_round_trips_byte_for_byte(op, dtype):
    a = data(dtype, shape=(9, 11))
    x = tda.from_array(a, chunks=(4, 5))
    got, want = {
        "transpose": lambda: (x.T, a.T),
        "concatenate": lambda: (tda.concatenate([x, x[:3]], axis=0), np.concatenate([a, a[:3]], axis=0)),
        "rechunk": lambda: (x.rechunk((3, 7)), a),
        "reversed": lambda: (x[::-1, ::-2], a[::-1, ::-2]),
        "pad-symmetric": lambda: (tda.pad(x, ((2, 3), (1, 4)), mode="symmetric"),
                                  np.pad(a, ((2, 3), (1, 4)), mode="symmetric")),
        "pad-wrap": lambda: (tda.pad(x, 2, mode="wrap"), np.pad(a, 2, mode="wrap")),
        "pad-edge": lambda: (tda.pad(x, ((0, 3), (2, 0)), mode="edge"), np.pad(a, ((0, 3), (2, 0)), mode="edge")),
        "pad-constant": lambda: (tda.pad(x, 1, mode="constant", constant_values=7),
                                 np.pad(a, 1, mode="constant", constant_values=7)),
        "map_overlap": lambda: (tda.map_overlap(lambda b: b, x, depth=1, boundary="reflect"), a),
        "stack": lambda: (tda.stack([x, x], axis=1), np.stack([a, a], axis=1)),
        "reshape": lambda: (x.reshape(11, 9), a.reshape(11, 9)),
    }[op]()
    _bytes_equal(got.compute(), want)


@pytest.mark.parametrize("dtype", UNSIGNED)
def test_unsigned_matmul_and_einsum_wrap_as_numpy(dtype):
    a = data(dtype, shape=(6, 5))
    b = data(dtype, seed=7, shape=(5, 4))
    x, y = tda.from_array(a, chunks=3), tda.from_array(b, chunks=2)
    same((x @ y).compute(), a @ b)
    same(tda.einsum("ij,ij->j", x, x).compute(), np.einsum("ij,ij->j", a, a))
