"""Sliding windows, moving-window reductions and push in the PyTorch port.

The cases of tests/test_sliding.py and tests/test_sliding_battery.py: the
same numpy inputs go through the JAX package and through the port, and
both are held against numpy (``sliding_window_view`` reductions, a numpy
replica of bottleneck's ``move_*`` and ``push``).  The plan checks are
the JAX package's: after ``simplify()`` a reduction over the window axis
is one ``SlidingWindowReduce`` and no ``SlidingWindowView`` is left.
Tolerances are the JAX tests' own, per case; ``push`` moves values and is
compared exactly.
"""

import warnings

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu.ops import _sliding as jsliding
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.ops import _sliding as tsliding
from dask_array_tpu_torch.ops._overlap import SlidingWindowView
from dask_array_tpu_torch.ops._sliding import MovingWindowReduction, SlidingWindowReduce

torch.set_num_threads(1)

swv = np.lib.stride_tricks.sliding_window_view


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


def kinds(expr):
    return {type(n).__name__ for n in expr.simplify().walk()}


def np_ref(reduction, data, window, axis=0, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return getattr(np, reduction)(swv(data, window, axis=axis), axis=-1, **kw)


def check(got, want, jax_got=None, **tol):
    """``got`` (a port array) computes to ``want`` within ``tol``, with
    numpy's dtype; ``jax_got`` (the JAX package's array) agrees with it."""
    out = got.compute()
    assert out.dtype == np.asarray(want).dtype == got.dtype
    assert out.shape == np.shape(want)
    tol.setdefault("equal_nan", True)
    if out.dtype.kind in "fc":
        np.testing.assert_allclose(out, want, **tol)
        if jax_got is not None:
            np.testing.assert_allclose(out, np.asarray(jax_got.compute()), **tol)
    else:
        np.testing.assert_array_equal(out, want)
        if jax_got is not None:
            np.testing.assert_array_equal(out, np.asarray(jax_got.compute()))


# ---------------------------------------------------------------------------
# sliding_window_view and the fused window reductions
# ---------------------------------------------------------------------------


def test_view_matches_numpy_and_jax():
    x = np.random.default_rng(0).standard_normal((9, 12))
    for window, axis in ((3, 0), ((2, 4), (0, 1)), ((5,), (1,)), ((3, 2), None)):
        got = tda.sliding_window_view(tda.from_array(x, chunks=(4, 5)), window, axis=axis)
        want = jda.sliding_window_view(jda.from_array(x, chunks=(4, 5)), window, axis=axis)
        assert got.chunks == want.chunks
        np.testing.assert_array_equal(got.compute(), swv(x, window, axis=axis))


def test_view_errors():
    x = tda.from_array(np.zeros((4, 5)), chunks=2)
    with pytest.raises(ValueError, match="larger than input"):
        tda.sliding_window_view(x, 6, axis=1)
    with pytest.raises(ValueError, match="positive"):
        tda.sliding_window_view(x, 0, axis=1)
    with pytest.raises(ValueError, match="same length"):
        tda.sliding_window_view(x, (2, 2), axis=0)


def test_sliding_reduce_fusion():
    x = np.random.default_rng(42).standard_normal((40,))
    d = tda.from_array(x, chunks=10)
    jd = jda.from_array(x, chunks=10)
    for kind in ("sum", "mean", "max", "min"):
        out = getattr(tda.sliding_window_view(d, 7), kind)(axis=-1)
        assert "SlidingWindowReduce" in kinds(out.expr)
        check(out, getattr(np, kind)(swv(x, 7), axis=-1), getattr(jda.sliding_window_view(jd, 7), kind)(axis=-1),
              rtol=1e-10)


def test_sliding_reduce_2d_axis():
    x = np.random.default_rng(42).standard_normal((6, 30))
    out = tda.sliding_window_view(tda.from_array(x, chunks=(3, 10)), (5,), axis=(1,)).sum(axis=-1)
    check(out, swv(x, (5,), axis=(1,)).sum(axis=-1), rtol=1e-10)


@pytest.mark.parametrize(
    "reduction",
    ["sum", "mean", "min", "max", "prod", "nansum", "nanmean", "nanmin", "nanmax", "nanprod"],
)
def test_window_spanning_many_chunks_keeps_native_chunks(reduction):
    rng = np.random.default_rng(42)
    data = rng.normal(size=(13 * 96, 3))
    if reduction in ("prod", "nanprod"):
        data = 1 + data / 100
    if reduction.startswith("nan"):
        data[rng.random(data.shape) < 0.2] = np.nan
        data[100:600, 1] = np.nan  # includes all-NaN windows
    result = getattr(tda, reduction)(tda.sliding_window_view(tda.from_array(data, chunks=(96, 2)), 480, axis=0), axis=-1)
    jresult = getattr(jda, reduction)(jda.sliding_window_view(jda.from_array(data, chunks=(96, 2)), 480, axis=0), axis=-1)
    optimized = result.expr.simplify()
    assert optimized.chunks == ((96,) * 8 + (1,), (2, 1)) == jresult.expr.simplify().chunks
    assert "SlidingWindowView" not in kinds(result.expr) and "SlidingWindowReduce" in kinds(result.expr)
    check(result, np_ref(reduction, data, 480), jresult, rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("window", [13, 20])
@pytest.mark.parametrize("reduction", ["sum", "min", "nanmean"])
def test_irregular_chunks(reduction, window):
    rng = np.random.default_rng(7)
    data = rng.normal(size=80)
    if reduction == "nanmean":
        data[rng.random(80) < 0.3] = np.nan
    x = tda.from_array(data, chunks=((7, 12, 9, 14, 8, 12, 6, 12),))
    result = getattr(tda, reduction)(tda.sliding_window_view(x, window, axis=0), axis=-1)
    if window == 20:
        assert result.expr.simplify().chunks == ((7, 12, 9, 14, 8, 11),)
    assert "SlidingWindowView" not in kinds(result.expr)
    check(result, np_ref(reduction, data, window), rtol=1e-12)


def test_window_one_past_chunk_and_large_offset():
    data = np.arange(80, dtype=np.float64)
    result = tda.sliding_window_view(tda.from_array(data, chunks=8), 9, axis=0).sum(axis=-1)
    assert result.expr.simplify().chunks == ((8,) * 9,)
    check(result, np_ref("sum", data, 9), rtol=1e-13)
    # a prefix-sum difference would lose these digits; the direct window sum
    # does not
    noise = np.random.default_rng(3).normal(size=12 * 64)
    result = tda.sliding_window_view(tda.from_array(1e9 + noise, chunks=64), 256, axis=0).sum(axis=-1)
    assert result.expr.simplify().chunks == ((64,) * 8 + (1,),)
    check(result, 256 * 1e9 + swv(noise, 256).sum(axis=-1), rtol=1e-13)


@pytest.mark.parametrize("reduction", ["min", "max", "sum", "prod", "mean"])
@pytest.mark.parametrize("keepdims", [False, True])
def test_reduction_keeps_non_window_chunks(reduction, keepdims):
    data = (1 + (np.arange(96 * 32 * 48, dtype=np.float32) % 5) / 100).reshape(96, 32, 48)
    windowed = tda.sliding_window_view(tda.from_array(data, chunks=(24, 24, 24)), 72, axis=0)
    result = getattr(windowed, reduction)(axis=-1, keepdims=keepdims)
    expected_chunks = ((24, 1), (24, 8), (24, 24)) + (((1,),) if keepdims else ())
    assert result.expr.simplify().chunks == expected_chunks
    assert "SlidingWindowView" not in kinds(result.expr)
    check(result, np_ref(reduction, data, 72, keepdims=keepdims), rtol=1e-5)


@pytest.mark.parametrize("reduction", ["any", "all"])
@pytest.mark.parametrize("keepdims", [False, True])
def test_boolean_reduction_keeps_non_window_chunks(reduction, keepdims):
    data = (np.arange(96 * 32 * 48).reshape(96, 32, 48) % 5) == 0
    windowed = tda.sliding_window_view(tda.from_array(data, chunks=(24, 24, 24)), 72, axis=0)
    result = getattr(windowed, reduction)(axis=-1, keepdims=keepdims)
    assert "SlidingWindowView" not in kinds(result.expr)
    check(result, np_ref(reduction, data, 72, keepdims=keepdims))


@pytest.mark.parametrize("reduction", ["nansum", "nanprod", "nanmin", "nanmax", "nanmean"])
@pytest.mark.parametrize("keepdims", [False, True])
def test_nan_reduction_keeps_non_window_chunks(reduction, keepdims):
    data = (1 + (np.arange(96 * 32 * 48, dtype=np.float64) % 5) / 10).reshape(96, 32, 48)
    data[::7, :, :] = np.nan
    data[:80, 0, 0] = np.nan  # all-NaN windows
    windowed = tda.sliding_window_view(tda.from_array(data, chunks=(24, 24, 24)), 72, axis=0)
    result = getattr(tda, reduction)(windowed, axis=-1, keepdims=keepdims)
    assert result.expr.simplify().chunks == ((24, 1), (24, 8), (24, 24)) + (((1,),) if keepdims else ())
    assert "SlidingWindowView" not in kinds(result.expr)
    check(result, np_ref(reduction, data, 72, keepdims=keepdims), rtol=1e-6)


@pytest.mark.parametrize("reduction, axis, expected_chunks", [
    ("min", 1, ((20, 20), (9,), (24, 24))),
    ("prod", 2, ((20, 20), (24, 8), (24, 1))),
])
def test_reduction_keeps_non_leading_non_window_chunks(reduction, axis, expected_chunks):
    data = (1 + (np.arange(40 * 32 * 48, dtype=np.float32) % 5) / 100).reshape(40, 32, 48)
    windowed = tda.sliding_window_view(tda.from_array(data, chunks=(20, 24, 24)), 24, axis=axis)
    result = getattr(windowed, reduction)(axis=-1)
    assert result.expr.simplify().chunks == expected_chunks
    check(result, np_ref(reduction, data, 24, axis=axis), rtol=1e-5)


# ---------------------------------------------------------------------------
# moments: the var/std family through the decomposition and the re-fusion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduction", ["var", "std", "nanvar", "nanstd"])
@pytest.mark.parametrize("ddof", [0, 1])
@pytest.mark.parametrize("keepdims", [False, True])
def test_moment_reduction_keeps_non_window_chunks(reduction, ddof, keepdims):
    data = (1 + (np.arange(96 * 32 * 48, dtype=np.float64) % 13) / 10).reshape(96, 32, 48)
    if reduction.startswith("nan"):
        data[::7, :, :] = np.nan
        data[:80, 0, 0] = np.nan
    windowed = tda.sliding_window_view(tda.from_array(data, chunks=(24, 24, 24)), 72, axis=0)
    result = getattr(tda, reduction)(windowed, axis=-1, ddof=ddof, keepdims=keepdims)
    assert result.expr.simplify().chunks == ((24, 1), (24, 8), (24, 24)) + (((1,),) if keepdims else ())
    assert "SlidingWindowView" not in kinds(result.expr)
    check(result, np_ref(reduction, data, 72, ddof=ddof, keepdims=keepdims), rtol=1e-7, atol=1e-8)


@pytest.mark.parametrize("reduction", ["var", "nanvar"])
def test_var_uses_stable_block_algorithm(reduction):
    data = (1e9 + (np.arange(96 * 8, dtype=np.float64) % 13) / 10).reshape(96, 8)
    if reduction == "nanvar":
        data[::7, :] = np.nan
    result = getattr(tda, reduction)(tda.sliding_window_view(tda.from_array(data, chunks=(24, 4)), 72, axis=0), axis=-1)
    assert "SlidingWindowView" not in kinds(result.expr)
    check(result, np_ref(reduction, data, 72), rtol=5e-7, atol=1e-8)


def test_sliding_var_large_mean_stability():
    rng = np.random.default_rng(42)
    x = (rng.standard_normal(64) + 1e4).astype(np.float32)
    w = tda.sliding_window_view(tda.from_array(x, chunks=16), 9)
    expected = swv(x.astype(np.float64), 9).var(axis=-1)
    np.testing.assert_allclose(w.var(axis=-1).compute().astype(np.float64), expected, rtol=1e-2)
    np.testing.assert_allclose(w.std(axis=-1).compute().astype(np.float64), np.sqrt(expected), rtol=1e-2)


def test_fused_var_and_std_kinds():
    # the node's own var/std, on shifted power sums with the global mean
    x = (np.random.default_rng(4).standard_normal((50, 3)) + 1e4).astype(np.float32)
    d = tda.from_array(x, chunks=(10, 3))
    for kind in ("var", "std"):
        node = SlidingWindowReduce(d.expr, kind, 8, 0, np.dtype(np.float32))
        got = tda.Array(node).compute()
        want = getattr(swv(x.astype(np.float64), 8, axis=0), kind)(axis=-1)
        np.testing.assert_allclose(got, want, rtol=1e-2)


@pytest.mark.parametrize("data", [np.arange(8, dtype=np.float64), np.ones(8, dtype=np.float64)])
def test_var_ddof_equal_window(data):
    result = tda.sliding_window_view(tda.from_array(data, chunks=4), 3, axis=0).var(axis=-1, ddof=3)
    check(result, np_ref("var", data, 3, ddof=3))


@pytest.mark.parametrize("reduction", ["var", "nanvar", "std", "nanstd"])
def test_var_explicit_integer_dtype(reduction):
    data = np.arange(24, dtype=np.int64) * 3
    windowed = tda.sliding_window_view(tda.from_array(data, chunks=8), 3, axis=0)
    result = getattr(tda, reduction)(windowed, axis=-1, dtype="i8")
    variance = np_ref("nanvar" if reduction.startswith("nan") else "var", data, 3, dtype="i8")
    expected = np.sqrt(variance).astype("i8") if reduction.endswith("std") else variance
    assert "SlidingWindowView" not in kinds(result.expr)
    check(result, expected)


def test_slice_of_fused_reduction_and_left_padding():
    data = (1 + (np.arange(96 * 8, dtype=np.float64) % 13) / 10).reshape(96, 8)
    data[::7, :] = np.nan
    windowed = tda.sliding_window_view(tda.from_array(data, chunks=(24, 4)), 72, axis=0)
    result = tda.nanvar(windowed, axis=-1)[:10]
    assert "SlidingWindowView" not in kinds(result.expr)
    check(result, np_ref("nanvar", data, 72)[:10], rtol=1e-9)
    window = 4
    ints = np.arange(10 * 2, dtype=np.int64).reshape(10, 2)
    padding = np.full((window - 1, 2), -1, dtype=ints.dtype)
    x = tda.concatenate([tda.from_array(padding, chunks=(window - 1, 2)), tda.from_array(ints, chunks=(10, 2))], axis=0)
    result = tda.sliding_window_view(x, window, axis=0).sum(axis=-1)
    assert "SlidingWindowView" not in kinds(result.expr)
    check(result, np_ref("sum", np.concatenate([padding, ints]), window))


@pytest.mark.parametrize("reduction", ["nansum", "nanprod", "nanmean"])
def test_nan_reduction_complex_values(reduction):
    data = np.array([1 + 1j, np.nan + 2j, 3 + 3j, 4 + np.nan * 1j, 5 + 5j, 6 + 6j, np.nan + np.nan * 1j, 8 + 8j],
                    dtype="complex128")
    result = getattr(tda, reduction)(tda.sliding_window_view(tda.from_array(data, chunks=4), 3, axis=0), axis=-1)
    assert "SlidingWindowView" not in kinds(result.expr)
    check(result, np_ref(reduction, data, 3))


def test_view_slicing_pushes_into_the_source():
    x = np.arange(60.0).reshape(6, 10)
    view = tda.sliding_window_view(tda.from_array(x, chunks=(3, 5)), (2, 3))
    np.testing.assert_array_equal(view[1:4, 2:6].compute(), swv(x, (2, 3))[1:4, 2:6])
    assert view[2, 3, 1, 2].compute() == x[3, 5]
    plan = view[1:4, 2:6].expr.simplify()
    assert isinstance(plan, SlidingWindowView) and plan.array.shape == (4, 6)


# ---------------------------------------------------------------------------
# bottleneck move_* semantics
# ---------------------------------------------------------------------------


def np_move(kind, data, window, min_count, axis):
    """Replica of bottleneck.move_*: trailing windows, NaN-aware, NaN where
    the valid count is below min_count (default: the window)."""
    x = np.moveaxis(np.asarray(data, dtype=np.float64), axis, -1)
    pad = np.full(x.shape[:-1] + (window - 1,), np.nan)
    wins = swv(np.concatenate([pad, x], axis=-1), window, axis=-1)
    cnt = (~np.isnan(wins)).sum(axis=-1)
    mc = min_count if min_count is not None else window
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        fn = {"sum": np.nansum, "mean": np.nanmean, "min": np.nanmin,
              "max": np.nanmax, "var": np.nanvar, "std": np.nanstd}[kind]
        r = fn(wins, axis=-1)
    return np.moveaxis(np.where(cnt >= mc, r, np.nan), -1, axis)


@pytest.mark.parametrize("kind", ["sum", "mean", "min", "max"])
@pytest.mark.parametrize("min_count", [1, None, 300])
def test_move_window_spanning_many_chunks(kind, min_count):
    rng = np.random.default_rng(0)
    data = rng.normal(size=(13 * 96, 4))
    data[rng.random(data.shape) < 0.2] = np.nan
    data[100:600, 2] = np.nan
    result = getattr(tsliding, f"move_{kind}")(tda.from_array(data, chunks=(96, 2)), 480, min_count=min_count, axis=0)
    jresult = getattr(jsliding, f"move_{kind}")(jda.from_array(data, chunks=(96, 2)), 480, min_count=min_count, axis=0)
    assert result.expr.optimize().chunks == ((96,) * 13, (2, 2))
    check(result, np_move(kind, data, 480, min_count, axis=0), jresult, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["var", "std"])
def test_move_moments_nan_heavy(kind):
    rng = np.random.default_rng(5)
    data = rng.normal(size=(200, 3))
    data[rng.random(data.shape) < 0.3] = np.nan
    data[20:80, 1] = np.nan
    result = getattr(tsliding, f"move_{kind}")(tda.from_array(data, chunks=(64, 2)), 40, min_count=2, axis=0)
    jresult = getattr(jsliding, f"move_{kind}")(jda.from_array(data, chunks=(64, 2)), 40, min_count=2, axis=0)
    check(result, np_move(kind, data, 40, 2, axis=0), jresult, rtol=1e-8, atol=1e-10)


def test_move_irregular_chunks_and_2d_axis():
    rng = np.random.default_rng(1)
    data = rng.normal(size=1248)
    data[rng.random(1248) < 0.2] = np.nan
    x = tda.from_array(data, chunks=((100, 51, 96, 96, 200, 96, 313, 200, 96),))
    check(tsliding.move_sum(x, 400, min_count=1, axis=0), np_move("sum", data, 400, 1, axis=0), rtol=1e-12, atol=1e-12)
    m = rng.standard_normal((4, 20))
    check(tsliding.move_min(tda.from_array(m, chunks=(2, 5)), 4, axis=1), np_move("min", m, 4, None, axis=1))


def test_move_nan_handling():
    x = np.array([1.0, np.nan, 3.0, 4.0, 5.0, np.nan])
    out = tsliding.move_sum(tda.from_array(x, chunks=3), 3, min_count=2).compute()
    np.testing.assert_array_equal(out, [np.nan, np.nan, 4.0, 7.0, 12.0, 9.0])
    mx = tsliding.move_max(tda.from_array(x, chunks=3), 3, min_count=1).compute()
    assert mx[1] == 1.0 and mx[4] == 5.0


@pytest.mark.parametrize("kind", ["sum", "mean", "var", "std"])
def test_move_integer_input_gives_float64(kind):
    data = np.arange(30, dtype=np.int32) % 7
    result = getattr(tsliding, f"move_{kind}")(tda.from_array(data, chunks=8), 5)
    assert result.dtype == np.float64
    check(result, np_move(kind, data, 5, None, axis=0), rtol=1e-12, atol=1e-12)


def test_move_var_large_mean_stability():
    x = (np.random.default_rng(42).standard_normal(40) + 1e4).astype(np.float32)
    v = tsliding.move_var(tda.from_array(x, chunks=10), 8).compute().astype(np.float64)
    xs = x.astype(np.float64)
    for i in range(7, 40):
        w = xs[i - 7:i + 1]
        assert abs(v[i] - w.var()) < 1e-2 * max(w.var(), 1e-6), (i, v[i], w.var())


def test_move_errors_and_node():
    x = tda.from_array(np.zeros(10), chunks=5)
    with pytest.raises(ValueError, match="window must be"):
        tsliding.move_sum(x, 0)
    with pytest.raises(ValueError, match="exceeds"):
        tsliding.move_sum(x, 11)
    assert isinstance(tsliding.move_mean(x, 3).expr, MovingWindowReduction)


# ---------------------------------------------------------------------------
# push
# ---------------------------------------------------------------------------


def np_push(data, n, axis):
    x = np.moveaxis(np.asarray(data, dtype=np.float64), axis, -1).copy()
    out = x.copy()
    for idx in np.ndindex(*x.shape[:-1]):
        last = -1
        for i in range(x.shape[-1]):
            if not np.isnan(x[idx + (i,)]):
                last = i
            elif last >= 0 and (n is None or i - last <= n):
                out[idx + (i,)] = x[idx + (last,)]
    return np.moveaxis(out, -1, axis)


@pytest.mark.parametrize("n", [None, 0, 1, 3])
@pytest.mark.parametrize("axis", [0, -1])
def test_push(n, axis):
    rng = np.random.default_rng(9)
    data = rng.standard_normal((30, 17))
    data[rng.random(data.shape) < 0.5] = np.nan
    data[:, 3] = np.nan
    data[4, :] = np.nan
    got = tda.push(tda.from_array(data, chunks=(7, 5)), n=n, axis=axis)
    want = jda.push(jda.from_array(data, chunks=(7, 5)), n=n, axis=axis)
    assert got.chunks == want.chunks
    out = got.compute()
    np.testing.assert_array_equal(out, np_push(data, n, axis))
    np.testing.assert_array_equal(out, np.asarray(want.compute()))


def test_push_integer_and_float32_input():
    ints = np.arange(12, dtype=np.int64).reshape(3, 4)
    got = tda.push(tda.from_array(ints, chunks=2))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got.compute(), ints.astype(np.float64))
    f = np.array([np.nan, 1.5, np.nan, np.nan, -2.0, np.nan], dtype=np.float32)
    got = tda.push(tda.from_array(f, chunks=4), n=1)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.compute(), np.array([np.nan, 1.5, 1.5, np.nan, -2.0, -2.0], dtype=np.float32))
