"""The port's shape ops against the JAX package and numpy, on the CPU.

Transpose and its aliases, squeeze / expand_dims / atleast_nd /
broadcast_to, the flips, ``rot90`` and ``roll``, the ``.blocks``
accessor, ``persist`` and ``freeze_chunks``, and the ``rechunk_relayout``
pipeline (BASELINE metric 2).  The same seeded numpy inputs go through
``from_array`` in both packages; values must be equal exactly (layout ops
move values, they compute none), and dtypes, chunks and the leaf shapes
left after slice or rechunk pushdown must be the JAX package's.
"""

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu.ops._from_array import FromArray as JFromArray
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch._collection import Persisted
from dask_array_tpu_torch._rechunk import Rechunk
from dask_array_tpu_torch.kernels import transpose as tk
from dask_array_tpu_torch.models.pipelines import rechunk_relayout
from dask_array_tpu_torch.ops._from_array import FromArray
from dask_array_tpu_torch.ops.manipulation import Transpose

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
        return rng.integers(-100 if np.dtype(dtype).kind == "i" else 0, 100, size=shape).astype(dtype)
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def leaf_shapes(expr, cls):
    return sorted(tuple(sum(c) for c in n.chunks) for n in expr.simplify().walk() if isinstance(n, cls))


def agree(fn, arrays, chunks, exact=True):
    """``fn(module, *arrays)`` through numpy, the JAX package and the port
    (inputs through ``from_array``); returns the port's collection."""
    want = fn(np, *arrays)
    got = fn(tda, *[tda.from_array(a, chunks=chunks) for a in arrays])
    ref = fn(jda, *[jda.from_array(a, chunks=chunks) for a in arrays])
    assert got.shape == want.shape and ref.shape == want.shape
    assert got.dtype == want.dtype == ref.dtype
    assert got.chunks == ref.chunks
    out = got.compute()
    jout = np.asarray(ref.compute())
    assert out.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(out, jout)
    else:
        np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(out, jout, rtol=1e-12, atol=1e-12)
    assert leaf_shapes(got.expr, FromArray) == leaf_shapes(ref.expr, JFromArray)
    return got


# ---------------------------------------------------------------------------
# transpose and its aliases
# ---------------------------------------------------------------------------

TRANSPOSES = {
    "T": lambda m, d: d.T,
    "axes-201": lambda m, d: m.transpose(d, (2, 0, 1)),
    "axes-021": lambda m, d: m.transpose(d, (0, 2, 1)),
    "method": lambda m, d: d.transpose(1, 0, 2),
    "swapaxes": lambda m, d: m.swapaxes(d, 0, -1),
    "swapaxes-method": lambda m, d: d.swapaxes(1, 2),
    "moveaxis": lambda m, d: m.moveaxis(d, 0, -1),
    "moveaxis-many": lambda m, d: m.moveaxis(d, [0, 1], [-1, 0]),
    "rollaxis": lambda m, d: m.rollaxis(d, 2),
    "rollaxis-start": lambda m, d: m.rollaxis(d, 0, 2),
    "T-slice": lambda m, d: d.T[1:4, ::2, 3],
    "T-int": lambda m, d: d.transpose(2, 0, 1)[1],
    "T-of-T": lambda m, d: d.T.T,
    "add-T": lambda m, d: (d + 2 * d).transpose(0, 2, 1),
}


@pytest.mark.parametrize("case", sorted(TRANSPOSES))
def test_transposes(case):
    agree(TRANSPOSES[case], [sample((6, 8, 10), seed=1)], (4, 3, 5))


@pytest.mark.parametrize("dtype", ["bool", "int8", "float16", "float32", "int64", "complex64", "complex128"])
def test_transpose_every_dtype(dtype):
    agree(lambda m, d: d.T, [sample((17, 23), dtype, seed=2)], (5, 7))
    agree(lambda m, d: m.swapaxes(d, 1, 2), [sample((3, 9, 4), dtype, seed=3)], 2)


def test_transpose_slice_shrinks_the_leaf():
    x = sample((40, 40), seed=4)
    got = agree(lambda m, d: d.T[:10, :20], [x], 10)
    assert leaf_shapes(got.expr, FromArray) == [(20, 10)]
    got = agree(lambda m, d: d.T[2:10, 7], [x], (5, 4))
    assert leaf_shapes(got.expr, FromArray) == [(8,)]  # one source row


def test_rechunk_pushes_through_transpose():
    x = sample((12, 8), seed=5)
    got = tda.from_array(x, chunks=4).T.rechunk((2, 6))
    ref = jda.from_array(x, chunks=4).T.rechunk((2, 6))
    assert got.chunks == ref.chunks
    opt = got.expr.simplify()
    assert type(opt) is Transpose and type(opt.array) is FromArray
    assert opt.array.chunks == ((6, 6), (2, 2, 2, 2))
    np.testing.assert_array_equal(got.compute(), x.T)


def test_elemwise_pushes_the_transpose_onto_each_operand(monkeypatch):
    """``(a + b).T`` becomes ``a.T + b.T`` (the JAX package's rewrite), so
    the swap runs once per operand."""
    calls = []
    real = tk.transpose_last2_plain
    monkeypatch.setattr(tk, "transpose_last2_plain", lambda t: calls.append(1) or real(t))
    x, y = sample((8, 6), seed=6), sample((8, 6), seed=7)
    r = (tda.from_array(x, chunks=(2, 3)) + tda.from_array(y, chunks=(2, 3))).T
    np.testing.assert_array_equal(r.compute(), (x + y).T)
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# squeeze / expand_dims / atleast_nd / broadcast_to
# ---------------------------------------------------------------------------

SHAPE_OPS = {
    "squeeze-all": ((1, 6, 1, 8), lambda m, d: m.squeeze(d)),
    "squeeze-axis": ((1, 6, 1, 8), lambda m, d: m.squeeze(d, axis=2)),
    "squeeze-axes": ((1, 6, 1, 8), lambda m, d: d.squeeze(axis=(0, 2))),
    "squeeze-slice": ((1, 6, 1, 8), lambda m, d: m.squeeze(d)[2:5, 3]),
    "expand-0": ((6, 8), lambda m, d: m.expand_dims(d, 0)),
    "expand-last": ((6, 8), lambda m, d: m.expand_dims(d, -1)),
    "expand-many": ((6, 8), lambda m, d: m.expand_dims(d, (0, 2))),
    "expand-slice": ((6, 8), lambda m, d: m.expand_dims(d, 1)[1:4, :, ::3]),
    "expand-int": ((6, 8), lambda m, d: m.expand_dims(d, 0)[0, 2]),
    "atleast_1d-0d": ((), lambda m, d: m.atleast_1d(d)),
    "atleast_2d-1d": ((6,), lambda m, d: m.atleast_2d(d)),
    "atleast_3d-1d": ((6,), lambda m, d: m.atleast_3d(d)),
    "atleast_3d-2d": ((6, 8), lambda m, d: m.atleast_3d(d)),
    "atleast_3d-0d": ((), lambda m, d: m.atleast_3d(d)),
    "broadcast-new": ((6,), lambda m, d: m.broadcast_to(d, (4, 6))),
    "broadcast-one": ((1, 6), lambda m, d: m.broadcast_to(d, (5, 6))),
    "broadcast-3d": ((5, 1), lambda m, d: m.broadcast_to(d, (2, 5, 4))),
    "broadcast-slice": ((1, 6), lambda m, d: m.broadcast_to(d, (5, 6))[1:4, 2:]),
    "broadcast-int": ((6,), lambda m, d: m.broadcast_to(d, (4, 6))[2, 1:5]),
}


@pytest.mark.parametrize("case", sorted(SHAPE_OPS))
def test_shape_ops(case):
    shape, fn = SHAPE_OPS[case]
    agree(fn, [sample(shape, seed=len(case))], 3)


def test_broadcast_to_with_chunks():
    x = sample((1, 6), seed=8)
    got = tda.broadcast_to(tda.from_array(x, chunks=3), (6, 6), chunks=(2, 3))
    ref = jda.broadcast_to(jda.from_array(x, chunks=3), (6, 6), chunks=(2, 3))
    assert got.chunks == ref.chunks == ((2, 2, 2), (3, 3))
    np.testing.assert_array_equal(got.compute(), np.broadcast_to(x, (6, 6)))
    with pytest.raises(ValueError, match="rechunk broadcast"):
        tda.broadcast_to(tda.from_array(x, chunks=3), (6, 6), chunks=(2, 2))


def test_rechunk_pushes_through_expand_dims_and_squeeze():
    x = sample((12, 8), seed=9)
    got = tda.expand_dims(tda.from_array(x, chunks=4), 0).rechunk((1, 6, 2))
    opt = got.expr.simplify()
    assert [n.chunks for n in opt.walk() if isinstance(n, FromArray)] == [((6, 6), (2, 2, 2, 2))]
    np.testing.assert_array_equal(got.compute(), x[None])
    sq = tda.squeeze(tda.from_array(x[None], chunks=4)).rechunk((3, 8))
    assert not any(isinstance(n, Rechunk) for n in sq.expr.simplify().walk())
    np.testing.assert_array_equal(sq.compute(), x)


def test_shape_op_errors():
    d = tda.from_array(sample((1, 6)), chunks=3)
    with pytest.raises(ValueError, match="size other than one"):
        tda.squeeze(d, axis=1)
    with pytest.raises(ValueError, match="repeated axis"):
        tda.expand_dims(d, (0, 0))
    with pytest.raises(ValueError, match="cannot broadcast"):
        tda.broadcast_to(d, (4, 5))
    with pytest.raises(ValueError, match="axes don't match"):
        tda.transpose(d, (0, 0))


# ---------------------------------------------------------------------------
# flips / rot90 / roll
# ---------------------------------------------------------------------------

FLIPS = {
    "flip-all": lambda m, d: m.flip(d),
    "flip-0": lambda m, d: m.flip(d, 0),
    "flip-1": lambda m, d: m.flip(d, axis=1),
    "flip-01": lambda m, d: m.flip(d, (0, 1)),
    "flipud": lambda m, d: m.flipud(d),
    "fliplr": lambda m, d: m.fliplr(d),
    "rot90-0": lambda m, d: m.rot90(d, 0),
    "rot90-1": lambda m, d: m.rot90(d),
    "rot90-2": lambda m, d: m.rot90(d, 2),
    "rot90-3": lambda m, d: m.rot90(d, 3),
    "rot90-neg": lambda m, d: m.rot90(d, -1, axes=(1, 0)),
    "roll-0": lambda m, d: m.roll(d, 3, axis=0),
    "roll-neg": lambda m, d: m.roll(d, -4, axis=1),
    "roll-big": lambda m, d: m.roll(d, 23, axis=1),
    "roll-zero": lambda m, d: m.roll(d, 0, axis=0),
    "roll-many": lambda m, d: m.roll(d, (2, -1), axis=(0, 1)),
    "roll-flat": lambda m, d: m.roll(d, 5),
    "roll-sum": lambda m, d: m.roll(d, 2, axis=0).sum(axis=0),
}


@pytest.mark.parametrize("case", sorted(FLIPS))
def test_flips_and_rolls(case):
    agree(FLIPS[case], [sample((10, 9), seed=10)], (4, 3), exact=case != "roll-sum")


def test_flips_of_3d_and_roll_errors():
    agree(lambda m, d: m.rot90(d, 1, axes=(1, 2)), [sample((3, 4, 5), seed=11)], 2)
    agree(lambda m, d: m.flip(d, -1)[1:, ::2], [sample((3, 4, 5), seed=12)], 2)
    d = tda.from_array(sample((4, 4)), chunks=2)
    with pytest.raises(ValueError, match="same number of shifts"):
        tda.roll(d, (1, 2), axis=0)
    with pytest.raises(TypeError, match="Must specify axis"):
        tda.roll(d, (1, 2))
    with pytest.raises(ValueError, match="Axes must be different"):
        tda.rot90(d, axes=(0, 0))


# ---------------------------------------------------------------------------
# .blocks
# ---------------------------------------------------------------------------

BLOCKS = {
    "int": lambda d: d.blocks[1],
    "pair": lambda d: d.blocks[1, 2],
    "neg": lambda d: d.blocks[-1, 0],
    "slice": lambda d: d.blocks[:, 1:],
    "reverse": lambda d: d.blocks[::-1],
    "list": lambda d: d.blocks[[0, 2], [2, 0]],
}


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_blocks(case):
    x = sample((10, 12), seed=13)
    got = BLOCKS[case](tda.from_array(x, chunks=(4, 5)))
    ref = BLOCKS[case](jda.from_array(x, chunks=(4, 5)))
    assert got.chunks == ref.chunks
    np.testing.assert_array_equal(got.compute(), np.asarray(ref.compute()))


def test_blocks_shape_and_ravel():
    x = sample((10, 12), seed=14)
    d = tda.from_array(x, chunks=(4, 5))
    assert d.blocks.shape == (3, 3) and d.blocks.size == 9
    parts = d.blocks.ravel()
    assert len(parts) == 9 and [p.shape for p in parts][:3] == [(4, 5), (4, 5), (4, 2)]
    np.testing.assert_array_equal(parts[4].compute(), x[4:8, 5:10])
    assert len(list(d.blocks)) == 9
    with pytest.raises(IndexError):
        d.blocks[3]
    with pytest.raises(IndexError):
        d.blocks[0, 0, 0]


# ---------------------------------------------------------------------------
# persist / freeze_chunks
# ---------------------------------------------------------------------------


def test_persist_keeps_the_name_and_holds_a_device_tensor():
    x = sample((16, 16), seed=15)
    d = tda.from_array(x, chunks=4)
    y = (d + d.T)[:8] * 2
    p = y.persist()
    assert isinstance(p.expr, Persisted)
    assert p.name == y.name and p.chunks == y.chunks and p.dtype == y.dtype
    # no FromArray below the persisted leaf: later work reads the tensor
    composed = p + 1
    assert not any(isinstance(n, FromArray) for n in composed.optimize().expr.walk())
    want = (x + x.T)[:8] * 2
    np.testing.assert_array_equal(p.compute(), want)
    np.testing.assert_array_equal(composed.compute(), want + 1)
    np.testing.assert_array_equal(y.compute(), want)  # the original is unchanged
    # the persisted tensor goes into the executor without a copy
    buf = p.expr.buffer
    assert p.compute_device().data_ptr() == buf.data_ptr()
    ref = (jda.from_array(x, chunks=4) + jda.from_array(x, chunks=4).T)[:8] * 2
    np.testing.assert_array_equal((ref.persist() + 1).compute(), composed.compute())


def test_persist_of_a_lowered_expression_reads_the_device_tensor():
    """The persisted leaf shares the original's name; the lowering cache
    must not hand back the original's lowered plan, which reads the numpy
    source again."""
    x = sample((8, 8), seed=21)
    y = tda.from_array(x, chunks=4).reshape(4, 16)
    y.compute()  # lowers y: its plan is cached under its name
    p = y.persist()
    assert p.name == y.name
    plan = (p.T + 1).optimize().expr
    assert not any(isinstance(n, FromArray) for n in plan.walk())
    assert any(isinstance(n, Persisted) for n in plan.walk())
    np.testing.assert_array_equal((p.T + 1).compute(), x.reshape(4, 16).T + 1)


def test_persist_snapshots_a_cpu_source():
    x = sample((8, 8), seed=16)
    p = tda.from_array(x, chunks=4).persist()
    x[:] = 0  # the caller's array changes after persist
    assert float(np.abs(p.compute()).sum()) > 0
    assert p.persist().name == p.name


def test_persist_of_a_transpose_is_laid_out():
    x = sample((12, 9), seed=17)
    p = tda.from_array(x, chunks=4).T.persist()
    assert p.expr.buffer.is_contiguous()
    np.testing.assert_array_equal(p.compute(), x.T)


def test_freeze_chunks_keeps_the_rechunk_above_the_transpose():
    x = sample((16, 16), seed=18)
    d = tda.from_array(x, chunks=(4, 16))
    free = d.T.rechunk((4, 16)).expr.simplify()
    assert type(free) is Transpose  # the rechunk sank into the leaf
    frozen = d.T.freeze_chunks()
    assert frozen.freeze_chunks() is frozen
    y = frozen.rechunk((4, 16))
    plan = y.optimize().expr
    assert any(isinstance(n, Transpose) for n in plan.walk())
    assert y.chunks == jda.from_array(x, chunks=(4, 16)).T.freeze_chunks().rechunk((4, 16)).chunks
    np.testing.assert_array_equal(y.compute(), x.T)


# ---------------------------------------------------------------------------
# rechunk_relayout (BASELINE metric 2)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("persist", [False, True])
def test_rechunk_relayout_matches_jax(persist, monkeypatch):
    calls = []
    real = tk.transpose_last2_plain
    monkeypatch.setattr(tk, "transpose_last2_plain", lambda t: calls.append(1) or real(t))
    x = sample((256, 256), "float32", seed=19)
    got = rechunk_relayout(chunk=32, persist=persist, x_np=x)
    jx = jda.from_array(x, chunks=(32, 256))
    if persist:
        jx = jx.persist()
    ref = jx.T.freeze_chunks().rechunk((32, 256))
    assert got.chunks == ref.chunks == ((32,) * 8, (256,))
    assert isinstance(got.expr, Rechunk)
    dev = got.compute_device()
    assert dev.is_contiguous() and dev.dtype == torch.float32
    np.testing.assert_array_equal(dev.numpy(), x.T)
    np.testing.assert_array_equal(got.compute(), np.asarray(ref.compute()))
    assert len(calls) == 2  # one physical transpose per compute
    leaves = [n for n in got.optimize().expr.walk() if isinstance(n, (FromArray, Persisted))]
    assert [type(n) for n in leaves] == [Persisted if persist else FromArray]


def test_rechunk_relayout_of_a_rectangle():
    x = sample((96, 40), "float32", seed=20)
    got = rechunk_relayout(chunk=16, x_np=x)
    assert got.chunks == ((16, 16, 8), (96,))
    np.testing.assert_array_equal(got.compute(), x.T)
