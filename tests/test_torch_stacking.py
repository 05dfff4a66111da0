"""The port's concatenate / stack / block against the JAX package and
numpy, on the CPU.

``concatenate`` (with ``axis=None``), ``stack``, ``vstack``/``hstack``/
``dstack`` and ``block``; result dtypes by numpy's promotion, also after
nested concatenates flatten into one; the slice that distributes onto the
surviving parts (their leaves shrink, the others drop out of the plan);
and the rechunk that distributes onto the parts where its boundaries land
on their seams.  The same seeded numpy inputs go through ``from_array`` in
both packages; values must be equal exactly, with the JAX package's
dtypes, chunks and leaf shapes.
"""

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu.ops._from_array import FromArray as JFromArray
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch._rechunk import Rechunk
from dask_array_tpu_torch.ops._from_array import FromArray
from dask_array_tpu_torch.ops.stacking import Concatenate

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


def sample(shape, dtype="float64", seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(shape) < 0.5
    if np.dtype(dtype).kind in "iu":
        return rng.integers(0, 100, size=shape).astype(dtype)
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def leaf_shapes(expr, cls):
    return sorted(tuple(sum(c) for c in n.chunks) for n in expr.simplify().walk() if isinstance(n, cls))


def agree(fn, arrays, chunks):
    """``fn(module, arrays)`` through numpy, the JAX package and the port;
    ``chunks`` is one spec for every input or one per input."""
    per = chunks if isinstance(chunks, list) else [chunks] * len(arrays)
    want = fn(np, arrays)
    got = fn(tda, [tda.from_array(a, chunks=c) for a, c in zip(arrays, per)])
    ref = fn(jda, [jda.from_array(a, chunks=c) for a, c in zip(arrays, per)])
    assert got.shape == want.shape == ref.shape
    assert got.dtype == want.dtype == ref.dtype
    assert got.chunks == ref.chunks
    out = got.compute()
    assert out.dtype == want.dtype
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, np.asarray(ref.compute()))
    assert leaf_shapes(got.expr, FromArray) == leaf_shapes(ref.expr, JFromArray)
    return got


THREE_2D = [((6, 4), 0), ((5, 4), 1), ((3, 4), 2)]

CASES = {
    "concat-0": (THREE_2D, lambda m, xs: m.concatenate(xs, axis=0)),
    "concat-neg": ([((4, 3), 0), ((4, 5), 1)], lambda m, xs: m.concatenate(xs, axis=-1)),
    "concat-none": ([((4, 3), 0), ((2, 5), 1)], lambda m, xs: m.concatenate(xs, axis=None)),
    "concat-3d": ([((2, 3, 4), 0), ((2, 3, 1), 1)], lambda m, xs: m.concatenate(xs, axis=2)),
    "concat-one": ([((4, 3), 0)], lambda m, xs: m.concatenate(xs)),
    "stack-0": ([((4, 3), 0), ((4, 3), 1)], lambda m, xs: m.stack(xs)),
    "stack-1": ([((4, 3), 0), ((4, 3), 1), ((4, 3), 2)], lambda m, xs: m.stack(xs, axis=1)),
    "stack-last": ([((4, 3), 0), ((4, 3), 1)], lambda m, xs: m.stack(xs, axis=-1)),
    "vstack": ([((2, 3), 0), ((4, 3), 1)], lambda m, xs: m.vstack(xs)),
    "vstack-1d": ([((3,), 0), ((3,), 1)], lambda m, xs: m.vstack(xs)),
    "hstack": ([((3, 2), 0), ((3, 4), 1)], lambda m, xs: m.hstack(xs)),
    "hstack-1d": ([((3,), 0), ((5,), 1)], lambda m, xs: m.hstack(xs)),
    "dstack": ([((3, 2), 0), ((3, 2), 1)], lambda m, xs: m.dstack(xs)),
    "dstack-1d": ([((3,), 0), ((3,), 1)], lambda m, xs: m.dstack(xs)),
    "block-2x2": ([((2, 3), 0), ((2, 4), 1), ((5, 3), 2), ((5, 4), 3)],
                  lambda m, xs: m.block([[xs[0], xs[1]], [xs[2], xs[3]]])),
    "block-1d": ([((3,), 0), ((4,), 1), ((2,), 2)], lambda m, xs: m.block(list(xs))),
    "block-mixed-depth": ([((2, 3), 0), ((3,), 1)], lambda m, xs: m.block([[xs[0]], [xs[1]]])),
    "block-3d": ([((2, 2, 2), 0), ((2, 2, 3), 1)], lambda m, xs: m.block([[[xs[0], xs[1]]]])),
    "slice-culls": (THREE_2D, lambda m, xs: m.concatenate(xs)[7:10]),
    "slice-step": (THREE_2D, lambda m, xs: m.concatenate(xs)[1:13:3, 1:]),
    "slice-int": (THREE_2D, lambda m, xs: m.concatenate(xs)[8]),
    "slice-reverse": (THREE_2D, lambda m, xs: m.concatenate(xs)[::-2]),
    "slice-empty": (THREE_2D, lambda m, xs: m.concatenate(xs)[20:]),
    "slice-other-axis": (THREE_2D, lambda m, xs: m.concatenate(xs)[:, 2]),
    "nested": (THREE_2D, lambda m, xs: m.concatenate([m.concatenate(xs[:2]), xs[2]])),
    "roll": (THREE_2D, lambda m, xs: m.roll(m.concatenate(xs), 4, axis=0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stacking(case):
    specs, fn = CASES[case]
    arrays = [sample(shape, seed=seed) for shape, seed in specs]
    agree(fn, arrays, 2)


def test_concatenate_with_other_chunks():
    """Off-axis chunks unify (the parts are rechunked to a common grid)."""
    a, b = sample((4, 6), seed=1), sample((5, 6), seed=2)
    got = agree(lambda m, xs: m.concatenate(xs), [a, b], [(2, 3), (5, 2)])
    assert got.chunks[0] == (2, 2, 5)


@pytest.mark.parametrize(
    "dtypes",
    [("int64", "uint8"), ("bool", "int8"), ("int64", "float32"), ("float32", "complex64"),
     ("uint8", "int8"), ("bool", "bool"), ("int16", "uint8", "float16")],
    ids=str,
)
def test_result_dtype_is_numpys_promotion(dtypes):
    arrays = [sample((3, 4), dt, seed=i) for i, dt in enumerate(dtypes)]
    agree(lambda m, xs: m.concatenate(xs), arrays, 2)
    agree(lambda m, xs: m.stack(xs, axis=1), arrays, 2)


def test_flattened_nested_concatenates_cast_to_numpys_dtype():
    """After the nested concatenates flatten into one, the parts differ in
    dtype; torch.cat would promote int64 with float32 to float32 by its
    own rule, so each part is cast to numpy's dtype (float64) first."""
    parts = [sample((2, 3), "int64", seed=1), sample((2, 3), "bool", seed=2), sample((2, 3), "float32", seed=3)]
    got = agree(lambda m, xs: m.concatenate([m.concatenate(xs[:2]), xs[2]]), parts, 2)
    flat = got.expr.simplify()
    assert type(flat) is Concatenate and len(flat.arrays) == 3
    assert [a.dtype for a in flat.arrays] == [np.dtype("int64"), np.dtype("bool"), np.dtype("float32")]
    assert got.dtype == np.float64


def test_slice_drops_the_parts_it_misses():
    arrays = [sample(shape, seed=seed) for shape, seed in THREE_2D]
    got = agree(lambda m, xs: m.concatenate(xs)[7:10], arrays, 2)
    assert leaf_shapes(got.expr, FromArray) == [(3, 4)]  # one part, three rows
    got = agree(lambda m, xs: m.concatenate(xs)[5:8, 1:3], arrays, 2)
    assert leaf_shapes(got.expr, FromArray) == [(1, 2), (2, 2)]


def test_rechunk_distributes_onto_the_parts():
    a, b = sample((4, 6), seed=4), sample((6, 6), seed=5)
    other = tda.concatenate([tda.from_array(a, chunks=2), tda.from_array(b, chunks=2)]).rechunk((2, 3))
    opt = other.expr.simplify()
    assert type(opt) is Concatenate and not any(isinstance(n, Rechunk) for n in opt.walk())
    np.testing.assert_array_equal(other.compute(), np.concatenate([a, b]))
    seams = tda.concatenate([tda.from_array(a, chunks=2), tda.from_array(b, chunks=2)]).rechunk((4, 6))
    assert type(seams.expr.simplify()) is Concatenate
    crossing = tda.concatenate([tda.from_array(a, chunks=2), tda.from_array(b, chunks=2)]).rechunk((5, 6))
    assert type(crossing.expr.simplify()) is Rechunk  # a chunk spans the seam
    for r in (seams, crossing):
        ref = jda.concatenate([jda.from_array(a, chunks=2), jda.from_array(b, chunks=2)]).rechunk(r.chunks)
        assert r.chunks == ref.chunks
        np.testing.assert_array_equal(r.compute(), np.concatenate([a, b]))


def test_stacking_errors():
    a = tda.from_array(sample((4, 3)), chunks=2)
    b = tda.from_array(sample((4, 5)), chunks=2)
    with pytest.raises(ValueError, match="Need array"):
        tda.concatenate([])
    with pytest.raises(ValueError, match="do not align"):
        tda.concatenate([a, b], axis=0)
    with pytest.raises(ValueError, match="same number of dimensions"):
        tda.concatenate([a, tda.from_array(sample((4,)), chunks=2)])
    with pytest.raises(ValueError, match="same shape"):
        tda.stack([a, b])
    with pytest.raises(ValueError, match="Need array"):
        tda.stack([])
