"""The port's reshape, ravel and their follow-ons against the JAX package
and numpy, on the CPU.

``reshape`` (the dask chunk plan with its pre-rechunk, the dense fallback
for interleaved shapes, and the prefix/suffix slice pushdown), ``ravel``
and ``flatten``, ``reshape_blockwise``, and what ``ravel`` unlocks:
``vdot``, ``outer`` and the cumulative reductions with ``axis=None`` on
n-d arrays.  The same seeded numpy inputs go through ``from_array`` in
both packages; layout results must be equal exactly, with the JAX
package's dtypes, chunks and leaf shapes after pushdown.  Products and
scans of float64 hold to rtol 1e-12 (the sums run in another order).
"""

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu.ops._from_array import FromArray as JFromArray
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.ops._from_array import FromArray
from dask_array_tpu_torch.ops._reshape import Reshape, ReshapeLowered, reshape_rechunk

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


def sample(shape, dtype="float64", seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind in "iu":
        return rng.integers(-9, 10, size=shape).astype(dtype)
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def leaf_shapes(expr, cls):
    return sorted(tuple(sum(c) for c in n.chunks) for n in expr.simplify().walk() if isinstance(n, cls))


def agree(fn, arrays, chunks, rtol=None):
    want = fn(np, *arrays)
    got = fn(tda, *[tda.from_array(a, chunks=chunks) for a in arrays])
    ref = fn(jda, *[jda.from_array(a, chunks=chunks) for a in arrays])
    assert got.shape == want.shape == ref.shape
    assert got.dtype == want.dtype == ref.dtype
    assert got.chunks == ref.chunks
    out = got.compute()
    jout = np.asarray(ref.compute())
    assert out.dtype == want.dtype
    if rtol is None:
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(out, jout)
    else:
        np.testing.assert_allclose(out, want, rtol=rtol, atol=rtol)
        np.testing.assert_allclose(out, jout, rtol=rtol, atol=rtol)
    assert leaf_shapes(got.expr, FromArray) == leaf_shapes(ref.expr, JFromArray)
    return got


RESHAPES = [
    ((12,), 4, (3, 4)),
    ((12,), 4, (12, 1)),
    ((12,), 4, (1, 12)),
    ((12,), 5, (2, 3, 2)),
    ((4, 6), 2, (24,)),
    ((4, 6), 2, (-1,)),
    ((4, 6), 2, (-1, 6)),
    ((4, 6), (2, 3), (6, 4)),
    ((4, 6), 2, (2, 12)),
    ((6, 10), (3, 5), (4, 15)),
    ((8, 6, 4), (2, 6, 4), (8, 24)),
    ((8, 6, 4), (3, 2, 2), (48, 4)),
    ((10, 6), (5, 6), (10, 2, 3)),
    ((2, 3, 4), 2, (6, 4)),
    ((3, 5, 7), (2, 2, 3), (7, 15)),
    ((30,), 7, (6, 5)),
    ((1, 12, 1), 4, (12,)),
    ((2, 1, 6), (1, 1, 3), (2, 6, 1)),
]


@pytest.mark.parametrize("in_shape, chunks, out_shape", RESHAPES, ids=str)
def test_reshape(in_shape, chunks, out_shape):
    agree(lambda m, d: m.reshape(d, out_shape), [sample(in_shape, seed=len(in_shape))], chunks)
    agree(lambda m, d: d.reshape(out_shape), [sample(in_shape, "int32", seed=3)], chunks)


@pytest.mark.parametrize("in_shape, chunks", [((6, 5), (2, 5)), ((4, 3, 2), 2), ((7,), 3), ((), ())])
def test_ravel_and_flatten(in_shape, chunks):
    x = sample(in_shape, seed=5)
    agree(lambda m, d: m.ravel(d), [x], chunks)
    agree(lambda m, d: d.ravel(), [x], chunks)
    got = tda.from_array(x, chunks=chunks).flatten()
    np.testing.assert_array_equal(got.compute(), x.flatten())


SLICED = [
    ((8, 6, 4), (2, 6, 4), (8, 24), np.s_[2:6]),
    ((6, 4, 2), (3, 4, 2), (6, 8), np.s_[1:5]),
    ((10, 6), (5, 6), (10, 2, 3), np.s_[3:8]),
    ((6, 4), (3, 4), (24,), np.s_[5:19]),
    ((12, 4), 3, (48,), np.s_[7:30]),
    ((2, 3, 4), 3, (6, 4), np.s_[1:5, ::2]),
    ((24,), 3, (4, 6), np.s_[2, 1:4]),
    ((4, 9), 3, (4, 3, 3), np.s_[::2]),
    ((5, 6, 7), (2, 3, 7), (5, 42), np.s_[1, 10:]),
    ((6, 4, 5), 2, (24, 5), np.s_[:, 1:3]),
]


@pytest.mark.parametrize("in_shape, chunks, out_shape, index", SLICED, ids=str)
def test_slice_through_reshape(in_shape, chunks, out_shape, index):
    agree(lambda m, d: d.reshape(out_shape)[index], [sample(in_shape, seed=7)], chunks)


def test_slice_pushdown_shrinks_the_leaf():
    x = sample((8, 6, 4), seed=8)
    got = agree(lambda m, d: d.reshape(8, 24)[2:6], [x], (2, 6, 4))
    assert leaf_shapes(got.expr, FromArray) == [(4, 6, 4)]
    got = agree(lambda m, d: d.reshape(48, 4)[:, 1:3], [x], (2, 6, 4))
    assert leaf_shapes(got.expr, FromArray) == [(8, 6, 2)]


def test_reshape_plan_and_pre_rechunk():
    assert reshape_rechunk((4, 6), (24,), ((2, 2), (3, 3))) == (((2, 2), (6,)), ((12, 12),))
    assert reshape_rechunk((12,), (3, 4), ((5, 5, 2),)) == (((4, 4, 4),), ((1, 1, 1), (4,)))
    d = tda.from_array(sample((4, 6)), chunks=(2, 3))
    r = d.reshape(24)
    assert isinstance(r.expr, Reshape) and r.chunks == ((12, 12),)
    # lowering rechunks the input to the plan's (2, 2) x (6,) blocks first
    lowered = r.optimize(fuse=False).expr
    assert isinstance(lowered, ReshapeLowered) and lowered.chunks == ((12, 12),)
    assert lowered.array.chunks == ((2, 2), (6,))
    np.testing.assert_array_equal(r.compute(), d.compute().reshape(24))


def test_reshape_of_a_transpose_and_roundtrips():
    x = sample((8, 6), seed=9)
    agree(lambda m, d: d.T.reshape(48), [x], (4, 3))
    agree(lambda m, d: d.T.reshape(3, 16), [x], (4, 3))
    agree(lambda m, d: d.reshape(48).reshape(8, 6), [x], (4, 6))
    agree(lambda m, d: (d.reshape(6, 8) + 1).sum(axis=0), [x], (2, 3), rtol=1e-12)


def test_reshape_errors_and_noops():
    d = tda.from_array(sample((4, 6)), chunks=2)
    assert d.reshape(4, 6) is not None and d.reshape(4, 6).name == d.name
    with pytest.raises(ValueError, match="cannot reshape"):
        d.reshape(5, 5)
    with pytest.raises(ValueError, match="one unknown"):
        d.reshape(-1, -1)
    with pytest.raises(NotImplementedError, match="order"):
        d.reshape(24, order="F")


def test_reshape_blockwise():
    x = sample((6, 4, 5), seed=10)
    for m, mod in ((tda, "port"), (jda, "jax")):
        d = m.from_array(x, chunks=(2, 4, 5))
        merged = m.reshape_blockwise(d, (6, 20))
        assert merged.chunks == ((2, 2, 2), (20,)), mod
        np.testing.assert_array_equal(np.asarray(merged.compute()), x.reshape(6, 20))
        split = m.reshape_blockwise(merged, (6, 4, 5), chunks=((2, 2, 2), (4,), (5,)))
        np.testing.assert_array_equal(np.asarray(split.compute()), x)
    with pytest.raises(ValueError, match="rechunk"):
        tda.reshape_blockwise(tda.from_array(x, chunks=2), (6, 20))
    with pytest.raises(ValueError, match="chunks="):
        tda.reshape_blockwise(tda.from_array(x, chunks=2), (6, 4, 5, 1))


# ---------------------------------------------------------------------------
# what ravel unlocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "int32", "complex128"])
def test_vdot_and_outer(dtype):
    a, b = sample((4, 6), dtype, seed=11), sample((3, 8), dtype, seed=12)
    rtol = None if dtype == "int32" else 1e-12
    agree(lambda m, x, y: m.vdot(x, y), [a, b], 2, rtol=rtol)
    agree(lambda m, x, y: m.outer(x, y), [a, b], 3, rtol=rtol)
    agree(lambda m, x, y: m.outer(x[0], y[:, 1]), [a, b], 2, rtol=rtol)


@pytest.mark.parametrize("method", ["sequential", "blelloch"])
@pytest.mark.parametrize("kind", ["cumsum", "cumprod", "nancumsum"])
@pytest.mark.parametrize("shape, chunks", [((4, 6), (2, 3)), ((3, 4, 5), 2)], ids=str)
def test_cumulative_axis_none_flattens(shape, chunks, kind, method):
    x = sample(shape, seed=13) * (0.5 if "prod" in kind else 1.0) + (1.0 if "prod" in kind else 0.0)
    if kind.startswith("nan"):
        x[0, 1] = np.nan
    agree(lambda m, d: getattr(m, kind)(d) if m is np else getattr(m, kind)(d, method=method),
          [x], chunks, rtol=1e-12)
    ints = sample(shape, "int16", seed=14)
    agree(lambda m, d: m.cumsum(d), [ints], chunks)


def test_cumreduction_axis_none_flattens():
    x = sample((4, 5), seed=15)

    def cummax(b, axis):
        return torch.cummax(b, dim=axis).values

    got = tda.cumreduction(cummax, torch.maximum, -np.inf, tda.from_array(x, chunks=2))
    ref = jda.cumreduction(lambda b, axis=None: np.maximum.accumulate(b, axis=axis), np.maximum,
                           -np.inf, jda.from_array(x, chunks=2))
    assert got.chunks == ref.chunks
    np.testing.assert_array_equal(got.compute(), np.maximum.accumulate(x.ravel()))
    np.testing.assert_array_equal(got.compute(), np.asarray(ref.compute()))
