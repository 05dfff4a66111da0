"""The port's expression core against the JAX package and numpy.

Chunk normalization, tokenization, numpy-rule dtypes, elementwise ops and
ufuncs, slicing, transpose, rechunk, and the optimizer's plans: the same
numpy inputs (made from a seed) go through ``dask_array_tpu`` and
``dask_array_tpu_torch``, with numpy as the tie-breaker.
"""

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu._chunks import normalize_chunks as jax_normalize_chunks
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch._chunks import normalize_chunks
from dask_array_tpu_torch._expr import compute_meta
from dask_array_tpu_torch.utils._tokenize import tokenize

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


@pytest.fixture
def x64():
    return np.random.default_rng(7).standard_normal((8, 8))


# ---------------------------------------------------------------------------
# chunks and tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "chunks, shape, dtype",
    [
        (3, (10, 7), "f8"),
        ((4, 5), (10, 7), "f4"),
        (((2, 8), (3, 4)), (10, 7), "i8"),
        ({0: 5}, (10, 7), "f8"),
        ((-1, 2), (10, 7), "f8"),
        ("auto", (1000, 1000), "f8"),
        ("1 MiB", (1000, 1000), "f4"),
        (2, (0, 4), "f8"),
    ],
)
def test_normalize_chunks_matches_jax(chunks, shape, dtype):
    assert normalize_chunks(chunks, shape, dtype=dtype) == jax_normalize_chunks(chunks, shape, dtype=dtype)


def test_normalize_chunks_rejects_mismatch():
    with pytest.raises(ValueError, match="add up"):
        normalize_chunks(((2, 2),), (5,))


def test_tokenize_is_deterministic_and_content_addressed():
    a = np.arange(12.0).reshape(3, 4)
    assert tokenize(a, torch.add) == tokenize(a.copy(), torch.add)
    assert tokenize(a) != tokenize(a + 1)
    assert tokenize(torch.add) != tokenize(torch.sub)
    t = torch.arange(6.0)
    assert tokenize(t) == tokenize(t.clone())
    assert tokenize(t) != tokenize(t + 1)
    assert tokenize(lambda b: torch.roll(b, 1, 0)) == tokenize(lambda b: torch.roll(b, 1, 0))
    assert tokenize(lambda b: torch.roll(b, 1, 0)) != tokenize(lambda b: torch.roll(b, -1, 0))


def test_identical_expressions_are_one_node(x64):
    a = tda.from_array(x64, chunks=4)
    assert (a + 1).expr is (a + 1).expr
    assert (a + 1).name != (a + 2).name


def test_config_from_reference():
    got = tconfig.from_reference({
        "array.chunk-size": "64 MiB",
        "array.optimize-graph": False,
        "tpu.stencil-kernel": "interpret",
        "tpu.prng-impl": "rbg",
        "tpu.qr-method": "cholqr2",
        "tpu.jit": True,
    })
    assert got == {"array.chunk-size": "64 MiB", "array.optimize-graph": False, "stencil-kernel": "auto"}
    assert tconfig.from_reference({"tpu.stencil-kernel": "off"}) == {"stencil-kernel": "off"}


# ---------------------------------------------------------------------------
# numpy-rule dtypes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "left, right",
    [
        ("i8", 2.5),
        ("i4", 2.5),
        ("f2", 1.5),
        ("f4", np.float64(1.25)),
        ("u1", 3),
        ("i1", "u1"),
        ("i2", "f2"),
        ("bool", 1),
        ("i4", "f4"),
        ("f4", "f8"),
    ],
)
def test_add_dtype_and_values_follow_numpy(left, right):
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((6, 5)) * 10).astype(left)
    b = (rng.standard_normal((6, 5)) * 10).astype(right) if isinstance(right, str) else right
    want = a + b
    got = tda.from_array(a, chunks=3) + (tda.from_array(b, chunks=3) if isinstance(right, str) else b)
    assert got.dtype == want.dtype
    out = got.compute()
    assert out.dtype == want.dtype
    np.testing.assert_allclose(out.astype("f8"), want.astype("f8"), rtol=1e-3 if want.dtype == np.float16 else 1e-12)


def test_int_plus_float_keeps_float64_precision():
    a = np.array([2**53 - 1, 2**40 + 3, -(2**50)], dtype=np.int64)
    got = (tda.from_array(a, chunks=2) + 0.5).compute()
    np.testing.assert_array_equal(got, a + 0.5)


@pytest.mark.parametrize(
    "func, args, want",
    [
        (torch.true_divide, (np.ones(3, "i8"), np.ones(3, "i8")), np.dtype("f8")),
        (torch.sqrt, (np.ones(3, "i1"),), np.dtype("f2")),
        (torch.lt, (np.ones(3, "i8"), 2.5), np.dtype(bool)),
        (lambda b: b * 2.5, (np.ones(3, "i8"),), np.dtype("f8")),
        (lambda b: b.to(torch.float32), (np.ones(3, "i8"),), np.dtype("f4")),
        (lambda b: torch.roll(b, 1, 0) - 4 * b, (np.ones((3, 3), "f4"),), np.dtype("f4")),
    ],
)
def test_compute_meta_dtypes(func, args, want):
    meta = compute_meta(func, None, *args)
    assert meta.dtype == want
    assert meta.ndim == args[0].ndim


# ---------------------------------------------------------------------------
# elementwise, ufuncs, slicing, transpose, rechunk against JAX and numpy
# ---------------------------------------------------------------------------

UNARY = ["sin", "exp", "abs", "negative", "square", "floor", "tanh", "isnan", "sqrt"]
BINARY = ["add", "subtract", "multiply", "true_divide", "maximum", "power", "greater", "arctan2"]


@pytest.mark.parametrize("name", UNARY)
def test_unary_ufunc(name, x64):
    x = np.abs(x64) if name == "sqrt" else x64
    want = getattr(np, name)(x)
    got = getattr(tda, name)(tda.from_array(x, chunks=(4, 3))).compute()
    ref = getattr(jda, name)(jda.from_array(x, chunks=(4, 3))).compute()
    assert got.dtype == ref.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(got, ref, rtol=1e-12)


@pytest.mark.parametrize("name", BINARY)
def test_binary_ufunc(name, x64):
    a, b = np.abs(x64) + 0.5, x64.T.copy()
    want = getattr(np, name)(a, b)
    got = getattr(tda, name)(tda.from_array(a, chunks=4), tda.from_array(b, chunks=(2, 4))).compute()
    ref = getattr(jda, name)(jda.from_array(a, chunks=4), jda.from_array(b, chunks=(2, 4))).compute()
    assert got.dtype == ref.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_operators_and_numpy_ufunc_protocol(x64):
    a = tda.from_array(x64, chunks=4)
    np.testing.assert_allclose((-(a * 2) + 1 / (a ** 2 + 1)).compute(), -(x64 * 2) + 1 / (x64**2 + 1))
    np.testing.assert_array_equal((a > 0).compute(), x64 > 0)
    np.testing.assert_allclose(np.sin(a).compute(), np.sin(x64))
    i = np.arange(-6, 6).reshape(3, 4)
    ti = tda.from_array(i, chunks=2)
    np.testing.assert_array_equal((ti // 4).compute(), i // 4)
    np.testing.assert_array_equal((ti % 4).compute(), i % 4)
    np.testing.assert_array_equal((ti & 3).compute(), i & 3)


def test_broadcast_row_and_astype(x64):
    row = np.arange(8.0)
    got = (tda.from_array(x64, chunks=4) * tda.from_array(row, chunks=4)).astype("f4").compute()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, (x64 * row).astype("f4"))


SLICES = [
    (slice(2, 7), slice(None)),
    (slice(None, None, 2), slice(1, None, 3)),
    (3, slice(None)),
    (slice(1, 6), -1),
    (slice(None, None, -1), slice(6, 1, -2)),
    (Ellipsis, 4),
    (slice(5, 5), slice(None)),
    (slice(-3, None), slice(None, -3)),
]


@pytest.mark.parametrize("index", SLICES)
def test_basic_slicing(index, x64):
    want = x64[index]
    got = tda.from_array(x64, chunks=(3, 4))[index]
    ref = jda.from_array(x64, chunks=(3, 4))[index]
    assert got.chunks == ref.chunks
    np.testing.assert_array_equal(got.compute(), want)
    np.testing.assert_array_equal(ref.compute(), want)


def test_fancy_indexing_is_not_ported_yet(x64):
    # (the name predates the port of fancy indexing; it now holds the
    # integer-list take against numpy and the JAX package)
    got = tda.from_array(x64, chunks=4)[[0, 2]].compute()
    np.testing.assert_array_equal(got, x64[[0, 2]])
    np.testing.assert_array_equal(got, jda.from_array(x64, chunks=4)[[0, 2]].compute())


def test_transpose_and_rechunk(x64):
    a = tda.from_array(x64, chunks=(3, 4))
    j = jda.from_array(x64, chunks=(3, 4))
    for got, ref, want in [
        (a.T, j.T, x64.T),
        (a.rechunk((5, 2)), j.rechunk((5, 2)), x64),
        (a.T.rechunk({0: 8}), j.T.rechunk({0: 8}), x64.T),
        ((a + a.T).rechunk(2), (j + j.T).rechunk(2), x64 + x64.T),
    ]:
        assert got.chunks == ref.chunks
        np.testing.assert_allclose(got.compute(), want)
        np.testing.assert_allclose(ref.compute(), want)


@pytest.mark.parametrize(
    "old, new",
    [
        (((10,) * 10,), ((100,),)),
        (((1,) * 100, (50, 50)), ((100,), (5,) * 20)),
        (((7, 3) * 20, (4,) * 5), ((5,) * 40, (20,))),
    ],
)
def test_plan_rechunk_matches_jax(old, new):
    from dask_array_tpu._rechunk import plan_rechunk as jax_plan_rechunk
    from dask_array_tpu_torch._rechunk import plan_rechunk

    for threshold in (4, 32):
        assert plan_rechunk(old, new, threshold=threshold) == jax_plan_rechunk(old, new, threshold=threshold)


def test_from_array_refuses_dtypes_without_a_torch_twin():
    # (datetime64 has one since S9: int64 ticks; long double has none)
    with pytest.raises(TypeError, match="no torch counterpart"):
        tda.from_array(np.zeros(3, np.longdouble), chunks=2)


def test_creation_matches_numpy():
    np.testing.assert_array_equal(tda.arange(3, 20, 4, chunks=2).compute(), np.arange(3, 20, 4))
    np.testing.assert_allclose(tda.arange(0.0, 1.0, 0.1, chunks=3).compute(), np.arange(0.0, 1.0, 0.1))
    np.testing.assert_array_equal(tda.full((3, 4), 7, chunks=2).compute(), np.full((3, 4), 7))
    np.testing.assert_array_equal(tda.zeros((3, 4), dtype="i4", chunks=2).compute(), np.zeros((3, 4), "i4"))
    assert tda.empty((2, 2), chunks=1).compute().shape == (2, 2)


def test_map_blocks_block_info_and_id():
    x = np.arange(24.0).reshape(4, 6)
    a = tda.from_array(x, chunks=(2, 3))

    def tag(b, block_id=None):
        return b + 100 * block_id[0] + 10 * block_id[1]

    def where(b, block_info=None):
        (r0, _), (c0, _) = block_info[0]["array-location"]
        return torch.full_like(b, float(r0 * 10 + c0))

    got = a.map_blocks(tag, dtype=x.dtype).compute()
    want = x + np.repeat(np.repeat([[0, 10], [100, 110]], 2, 0), 3, 1)
    np.testing.assert_array_equal(got, want)
    got = a.map_blocks(where, dtype=x.dtype).compute()
    np.testing.assert_array_equal(got, np.repeat(np.repeat([[0, 3], [20, 23]], 2, 0), 3, 1))


# ---------------------------------------------------------------------------
# plans: the optimizer's trees equal the JAX package's
# ---------------------------------------------------------------------------


def plan_tree(expr):
    return (
        type(expr).__name__,
        tuple(tuple(c) for c in expr.chunks),
        tuple(plan_tree(d) for d in expr.dependencies()),
    )


def _readme(da, x):
    from dask_array_tpu.models.pipelines import readme_example as jax_readme
    from dask_array_tpu_torch.models.pipelines import readme_example as torch_readme

    return (torch_readme if da is tda else jax_readme)()


def _slice_transpose(da, x):
    a = da.from_array(x, chunks=4)
    return ((a * 2 + 1).T)[2:6, 1:7]


def _shared_slices(da, x):
    a = da.from_array(x, chunks=(2, 4))
    return (a - a.T)[:4, 4:]


def _broadcast_arange(da, x):
    return (da.ones((6, 9), chunks=3) * da.arange(9, chunks=3))[1:4, ::2]


def _rechunk_slice(da, x):
    return da.from_array(x, chunks=4).rechunk((2, 8))[3:7]


@pytest.mark.parametrize("build", [_readme, _slice_transpose, _shared_slices, _broadcast_arange, _rechunk_slice])
def test_plan_matches_jax(build, x64):
    got = build(tda, x64)
    ref = build(jda, x64)
    assert plan_tree(got.optimize().expr) == plan_tree(ref.optimize().expr)
    np.testing.assert_allclose(got.compute(), ref.compute())


def test_readme_plan_pushes_slice_into_leaves():
    from dask_array_tpu_torch.models.pipelines import readme_example

    y = readme_example()
    plan = plan_tree(y.optimize().expr)
    assert plan[0] == "FusedBlockwise"
    leaves = [n for n in _walk(plan) if n[0] == "Ones"]
    assert leaves and all(n[1] == ((100,), (100,)) for n in leaves)
    np.testing.assert_array_equal(y.compute(), np.full((100, 100), 2.0))


def _walk(node):
    yield node
    for child in node[2]:
        yield from _walk(child)


# ---------------------------------------------------------------------------
# integer division by zero: numpy's values (0 where the divisor is 0)
# ---------------------------------------------------------------------------

INT_DIV = [
    ("floor_divide", lambda a, b: a // b),
    ("remainder", lambda a, b: a % b),
    ("mod", lambda a, b: a % b),
    ("fmod", np.fmod),
]


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("name, op", INT_DIV, ids=[n for n, _ in INT_DIV])
def test_integer_division_by_zero_gives_numpy_values(dtype, name, op):
    a = np.array([1, 2, 3, -7, 0, 9], dtype=dtype)
    b = np.array([0, 1, 0, 2, 0, -4], dtype=dtype)
    x, y = tda.from_array(a, chunks=4), tda.from_array(b, chunks=4)
    with np.errstate(all="ignore"):
        want_arr = getattr(np, name)(a, b)
        want_scalar = getattr(np, name)(a, np.array(0, dtype))
        want_left = getattr(np, name)(np.array(7, dtype), b)
    # numpy: 0 wherever the divisor is 0, for array and scalar divisors
    assert want_arr.tolist() == [0, op(2, 1), 0, int(want_arr[3]), 0, int(want_arr[5])]
    assert (want_scalar == 0).all()
    got = getattr(tda, name)(x, y).compute()
    assert got.dtype == want_arr.dtype
    np.testing.assert_array_equal(got, want_arr)
    np.testing.assert_array_equal(getattr(tda, name)(x, 0).compute(), want_scalar)
    np.testing.assert_array_equal(getattr(tda, name)(7, y).compute(), want_left)
    if name != "fmod":
        np.testing.assert_array_equal(op(x, y).compute(), want_arr)
        np.testing.assert_array_equal(op(x, 0).compute(), want_scalar)
        np.testing.assert_array_equal(op(7, y).compute(), want_left)


def test_float_division_by_zero_is_untouched():
    a = np.array([1.0, -2.0, 0.0, 3.5])
    b = np.array([0.0, 0.0, 0.0, 2.0])
    x, y = tda.from_array(a, chunks=2), tda.from_array(b, chunks=2)
    with np.errstate(all="ignore"):
        np.testing.assert_array_equal((x // y).compute(), a // b)
        np.testing.assert_array_equal((x % y).compute(), a % b)
        np.testing.assert_array_equal(tda.fmod(x, y).compute(), np.fmod(a, b))


# ---------------------------------------------------------------------------
# scalars enter torch in the loop dtype (numpy's NEP 50 rounding)
# ---------------------------------------------------------------------------

SCALARS = [0.1, 3.3, 1 / 3, 7.77]
SCALAR_OPS = {
    "x*s": lambda x, s: x * s,
    "s*x": lambda x, s: s * x,
    "x/s": lambda x, s: x / s,
    "s/x": lambda x, s: s / x,
    "x+s": lambda x, s: x + s,
    "x-s": lambda x, s: x - s,
}
# the torch call the port makes for each (torch's own ``s / t`` is a
# reciprocal times s, not a division)
TORCH_OPS = {
    "x*s": lambda t, s: torch.mul(t, s),
    "s*x": lambda t, s: torch.mul(s, t),
    "x/s": lambda t, s: torch.true_divide(t, s),
    "s/x": lambda t, s: torch.true_divide(torch.tensor(s, dtype=t.dtype), t),
    "x+s": lambda t, s: torch.add(t, s),
    "x-s": lambda t, s: torch.sub(t, s),
}


@pytest.mark.parametrize("s", SCALARS, ids=str)
@pytest.mark.parametrize("op", list(SCALAR_OPS))
def test_float16_scalar_ops_equal_numpy_byte_for_byte(op, s):
    # numpy rounds s to float16 first; torch, handed a Python float as the
    # second operand, multiplied by the unrounded value
    x = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float16)
    fn = SCALAR_OPS[op]
    got = fn(tda.from_array(x, chunks=32), s).compute()
    want = fn(x, s)
    assert got.dtype == want.dtype == np.float16
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


@pytest.mark.parametrize("s", SCALARS, ids=str)
@pytest.mark.parametrize("op", list(SCALAR_OPS))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_float32_float64_scalar_ops_unchanged(op, s, dtype):
    # a Python scalar still enters torch as it did: the same bytes as the
    # torch op on the tensor with the Python scalar, and as numpy's
    x = np.random.default_rng(1).standard_normal((64, 64)).astype(dtype)
    fn = SCALAR_OPS[op]
    got = fn(tda.from_array(x, chunks=32), s).compute()
    direct = TORCH_OPS[op](torch.from_numpy(x), s).numpy()
    bits = f"u{x.dtype.itemsize}"
    np.testing.assert_array_equal(got.view(bits), direct.view(bits))
    np.testing.assert_array_equal(got.view(bits), fn(x, s).view(bits))


def test_float16_scalar_comparison_and_numpy_scalar():
    x = np.linspace(0.09, 0.11, 101, dtype=np.float16)
    d = tda.from_array(x, chunks=50)
    np.testing.assert_array_equal((d > 0.1).compute(), x > 0.1)
    np.testing.assert_array_equal((d * np.float64(0.1)).compute().view(np.uint16),
                                  (x * np.float64(0.1)).view(np.uint16))
