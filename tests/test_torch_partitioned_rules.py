"""The partitioned walk's rule table, on 8 CPU slots.

Every rule of ``parallel/partition.py`` under ``"execution-lane": "gspmd"``
on three meshes (an 8-slot ring, a 2 x 4 grid and the ``(dcn=2, x=4)``
mesh of ``tests/test_multislice.py``), against the walk without a mesh
and numpy: bit for bit for elementwise, layout, slicing, integer and
min/max results; floating sums and moments over a sharded axis within
1e-12 (float64) or 1e-6 (float32) of the sum of |x|.  A 10-row array on
8 slots leaves the last parts empty, and every rule takes them.

Then the walk's own promises: each rule's node is walked per slot (and
gathers nothing); the kernels on its path (the transpose, scale,
multi-statistic and histogram kernels; their plain versions here) run once
a slot, never on an empty part; the flagship gathers only its output; a
relayout hands its shards on; ``persist()`` keeps the shards and a later
walk binds them with no copy; a node read both ways gathers once; without
a mesh the walk never asks the rule table and the records stay still.
"""

import pickle

import numpy as np
import pytest
import torch

import dask_array_tpu_torch as da
from dask_array_tpu_torch import config
from dask_array_tpu_torch.parallel import Mesh, use_mesh
from dask_array_tpu_torch.parallel._sharded import COLLECTIVES, ShardedTensor, ShardedView
from dask_array_tpu_torch.parallel.partition import PARTITIONED

torch.set_num_threads(1)

MESHES = {"ring8": ((8,), ("r",)), "mesh2x4": ((2, 4), ("x", "y")), "dcn2x4": ((2, 4), ("dcn", "x"))}


@pytest.fixture(autouse=True)
def _cpu_device():
    with config.set({"device": "cpu"}):
        yield


def mesh(name):
    shape, names = MESHES[name]
    return Mesh(np.array(["cpu"] * int(np.prod(shape)), dtype=object).reshape(shape), names)


RNG = np.random.default_rng(18)
XF = RNG.standard_normal((64, 48))
YF = RNG.standard_normal((48, 32))
SQ = RNG.standard_normal((48, 48))
XI = RNG.integers(-1000, 1000, size=(64, 48))
X3 = RNG.standard_normal((16, 24, 8))
NANS = XF.copy()
NANS[RNG.random(XF.shape) < 0.1] = np.nan
XS = RNG.standard_normal((64, 48)).astype(np.float32)
Z = RNG.standard_normal((10, 6))  # 10 rows on 8 slots: ceil 2, the last three parts empty
ZI = RNG.integers(0, 50, size=10)
COL = RNG.standard_normal((64, 1))
ROW = RNG.standard_normal(48)


def x():
    return da.from_array(XF, chunks=(8, 12))


def xi():
    return da.from_array(XI, chunks=(8, 12))


def z():
    return da.from_array(Z, chunks=(3, 6))


def _lap(b):
    return torch.roll(b, 1, 0) + torch.roll(b, -1, 0) + torch.roll(b, 1, 1) + torch.roll(b, -1, 1) - 4 * b


# (name, build, numpy, exact, node types the rule walks per slot)
CASES = [
    # -- elementwise
    ("elemwise", lambda: x() * 2 + 1, lambda: XF * 2 + 1, True, ("Elemwise",)),
    ("two_leaves", lambda: x() + da.from_array(NANS, chunks=(16, 16)) * 3, lambda: XF + NANS * 3, True, ("Elemwise",)),
    ("row_broadcast", lambda: x() - da.from_array(ROW, chunks=12), lambda: XF - ROW, True, ("Elemwise",)),
    ("col_scale", lambda: x() * da.from_array(COL, chunks=(8, 1)), lambda: XF * COL, True, ("Elemwise",)),
    ("scalar_scale", lambda: x() * 0.5, lambda: XF * 0.5, True, ("Elemwise",)),
    ("where", lambda: da.where(x() > 0, x(), -x()), lambda: np.where(XF > 0, XF, -XF), True, ("Elemwise",)),
    ("int_ops", lambda: (xi() * 3) // 7 - xi() % 5, lambda: (XI * 3) // 7 - XI % 5, True, ("Elemwise",)),
    ("transposed_operand", lambda: da.from_array(SQ, chunks=12) + da.from_array(SQ, chunks=12).T,
     lambda: SQ + SQ.T, True, ("Elemwise", "Transpose")),
    # -- layout
    ("transpose", lambda: x().T, lambda: XF.T, True, ("Transpose",)),
    ("transpose_3d", lambda: da.from_array(X3, chunks=4).transpose(2, 0, 1) * 1.0, lambda: X3.transpose(2, 0, 1),
     True, ("Transpose",)),
    ("swapaxes", lambda: da.swapaxes(da.from_array(X3, chunks=4), 1, 2) + 0.0, lambda: X3.swapaxes(1, 2), True,
     ("Transpose",)),
    # (a scan keeps a slice of its axis above it: the slice pushdown stops)
    ("slice_step", lambda: xi().cumsum(axis=0)[3:50:3, 1:], lambda: np.cumsum(XI, axis=0)[3:50:3, 1:], True,
     ("Slice",)),
    ("slice_row", lambda: xi().cumsum(axis=0)[5], lambda: np.cumsum(XI, axis=0)[5], True, ("Slice",)),
    ("slice_point", lambda: xi().cumsum(axis=0)[40, 7], lambda: np.cumsum(XI, axis=0)[40, 7], True, ("Slice",)),
    ("slice_col", lambda: xi().cumsum(axis=1)[:, 5], lambda: np.cumsum(XI, axis=1)[:, 5], True, ("Slice",)),
    ("slice_tail", lambda: xi().cumsum(axis=0)[60:] + 1, lambda: np.cumsum(XI, axis=0)[60:] + 1, True,
     ("Slice", "Elemwise")),
    ("slice_then_bcast", lambda: xi().cumsum(axis=0)[3:50:3] + xi()[3:50:3],
     lambda: np.cumsum(XI, axis=0)[3:50:3] + XI[3:50:3], True, ("Slice", "Elemwise")),
    ("slice_reversed", lambda: xi().cumsum(axis=0)[::-2], lambda: np.cumsum(XI, axis=0)[::-2], True, ()),
    ("rechunk", lambda: (x() * 2).freeze_chunks().rechunk((64, 6)), lambda: XF * 2, True, ("Rechunk",)),
    ("freeze_rechunk", lambda: x().cumsum(axis=1).freeze_chunks().rechunk((64, 6)), lambda: np.cumsum(XF, axis=1),
     False, ("Rechunk", "CumReduction")),
    # (a shuffle gathers, permutes and shards its result: the + 1 runs per slot)
    ("shuffle", lambda: (x() * 1.0).shuffle([[5, 1], [0, 2, 63], [40]], axis=0) + 1,
     lambda: XF[[5, 1, 0, 2, 63, 40]] + 1, True, ("Elemwise",)),
    # -- reductions
    ("sum0", lambda: x().sum(axis=0), lambda: XF.sum(axis=0), False, ("Reduction",)),
    ("sum1", lambda: x().sum(axis=1), lambda: XF.sum(axis=1), False, ("Reduction",)),
    ("sum_all_keep", lambda: x().sum(keepdims=True), lambda: XF.sum(keepdims=True), False, ("Reduction",)),
    ("mean", lambda: x().mean(axis=0), lambda: XF.mean(axis=0), False, ("Reduction",)),
    ("int_sum", lambda: xi().sum(axis=0), lambda: XI.sum(axis=0), True, ("Reduction",)),
    ("int_mean", lambda: xi().mean(), lambda: XI.mean(), False, ("Reduction",)),
    ("min", lambda: x().min(axis=0), lambda: XF.min(axis=0), True, ("Reduction",)),
    ("max_all", lambda: x().max(), lambda: XF.max(), True, ("Reduction",)),
    ("any_all", lambda: (x() > 2.5).any(axis=0) & (x() > -5).all(axis=0), lambda: (XF > 2.5).any(0) & (XF > -5).all(0),
     True, ("Reduction",)),
    ("nansum", lambda: da.nansum(da.from_array(NANS, chunks=16), axis=0), lambda: np.nansum(NANS, axis=0), False,
     ("Reduction",)),
    ("nanmean", lambda: da.nanmean(da.from_array(NANS, chunks=16), axis=1), lambda: np.nanmean(NANS, axis=1), False,
     ("Reduction",)),
    ("nanmax", lambda: da.nanmax(da.from_array(NANS, chunks=16), axis=0), lambda: np.nanmax(NANS, axis=0), True,
     ("Reduction",)),
    ("var", lambda: x().var(axis=0), lambda: XF.var(axis=0), False, ("Reduction", "Slice")),
    ("std_all", lambda: x().std(), lambda: XF.std(), False, ("Reduction",)),
    ("argmax0", lambda: x().argmax(axis=0), lambda: XF.argmax(axis=0), True, ("ArgReduction",)),
    ("argmin1", lambda: x().argmin(axis=1), lambda: XF.argmin(axis=1), True, ("ArgReduction",)),
    ("argmax_all", lambda: x().argmax(), lambda: XF.argmax(), True, ("ArgReduction",)),
    ("argmax_nan", lambda: da.from_array(NANS, chunks=16).argmax(axis=0), lambda: NANS.argmax(axis=0), True,
     ("ArgReduction",)),
    ("cumsum0", lambda: x().cumsum(axis=0), lambda: np.cumsum(XF, axis=0), False, ("CumReduction",)),
    ("cumsum1", lambda: x().cumsum(axis=1), lambda: np.cumsum(XF, axis=1), False, ("CumReduction",)),
    ("cumprod0", lambda: (x() * 0.1 + 1).cumprod(axis=0), lambda: np.cumprod(XF * 0.1 + 1, axis=0), False,
     ("CumReduction",)),
    ("int_cumsum", lambda: xi().cumsum(axis=0), lambda: np.cumsum(XI, axis=0), True, ("CumReduction",)),
    ("nancumsum", lambda: da.nancumsum(da.from_array(NANS, chunks=16), axis=0), lambda: np.nancumsum(NANS, axis=0),
     False, ("CumReduction",)),
    # -- contraction
    ("matmul", lambda: x() @ da.from_array(YF, chunks=(12, 8)), lambda: XF @ YF, False, ("Einsum",)),
    ("gram", lambda: x() @ x().T, lambda: XF @ XF.T, False, ("Einsum",)),
    ("contract_k", lambda: x().T @ x(), lambda: XF.T @ XF, False, ("Einsum",)),
    ("int_matmul", lambda: xi() @ xi().T, lambda: XI @ XI.T, True, ("Einsum",)),
    ("matvec", lambda: x() @ da.from_array(ROW, chunks=12), lambda: XF @ ROW, False, ("Einsum",)),
    # -- the kernels' nodes
    ("histogram", lambda: da.histogram(x(), bins=np.linspace(-3, 3, 17))[0],
     lambda: np.histogram(XF, bins=np.linspace(-3, 3, 17))[0], True, ("Histogram",)),
    ("histogram_density", lambda: da.histogram(x(), bins=np.linspace(-3, 3, 17), density=True)[0],
     lambda: np.histogram(XF, bins=np.linspace(-3, 3, 17), density=True)[0], False, ("Histogram",)),
    ("histogram_weighted", lambda: da.histogram(x(), bins=np.linspace(-3, 3, 9), weights=x() * x())[0],
     lambda: np.histogram(XF, bins=np.linspace(-3, 3, 9), weights=XF * XF)[0], False, ("Histogram",)),
    ("histogram_lazy_edges", lambda: da.histogram(x(), bins=12)[0], lambda: np.histogram(XF, bins=12)[0], True,
     ("Histogram",)),
    ("bincount", lambda: da.bincount(da.from_array(XI[:, 0] % 37 + 37, chunks=8)),
     lambda: np.bincount(XI[:, 0] % 37 + 37), True, ("Bincount",)),
    ("bincount_weighted", lambda: da.bincount(da.from_array(XI[:, 0] % 37 + 37, chunks=8), weights=x()[:, 0]),
     lambda: np.bincount(XI[:, 0] % 37 + 37, weights=XF[:, 0]), False, ("Bincount",)),
    ("map_blocks", lambda: x().map_blocks(lambda b: b * 2 + 1), lambda: XF * 2 + 1, True, ("MapBlocks",)),
    ("map_blocks_id", lambda: x().map_blocks(lambda b, block_id=None: b + block_id[0], dtype="f8"),
     lambda: XF + (np.arange(64) // 8)[:, None], True, ("_MapBlocksWithId",)),
    ("stencil", lambda: da.map_overlap(_lap, da.from_array(XF, chunks=(16, 16)), depth=1, boundary="reflect"),
     None, False, ("BandStencil",)),
    # -- empty last parts: 10 rows on 8 slots
    ("empty_elemwise", lambda: z() * 2 + 1, lambda: Z * 2 + 1, True, ("Elemwise",)),
    ("empty_sum", lambda: z().sum(axis=0), lambda: Z.sum(axis=0), False, ("Reduction",)),
    ("empty_mean", lambda: z().mean(), lambda: Z.mean(), False, ("Reduction",)),
    ("empty_min", lambda: z().min(axis=0), lambda: Z.min(axis=0), True, ("Reduction",)),
    ("empty_argmin", lambda: z().argmin(axis=0), lambda: Z.argmin(axis=0), True, ("ArgReduction",)),
    ("empty_cumsum", lambda: z().cumsum(axis=0), lambda: np.cumsum(Z, axis=0), False, ("CumReduction",)),
    ("empty_transpose", lambda: z().T * 1.0, lambda: Z.T, True, ("Transpose",)),
    ("empty_slice", lambda: z().cumsum(axis=0)[7:], lambda: np.cumsum(Z, axis=0)[7:], False, ("Slice",)),
    ("empty_matmul", lambda: z() @ z().T, lambda: Z @ Z.T, False, ("Einsum",)),
    ("empty_histogram", lambda: da.histogram(z(), bins=np.linspace(-2, 2, 5))[0],
     lambda: np.histogram(Z, bins=np.linspace(-2, 2, 5))[0], True, ("Histogram",)),
    ("empty_bincount", lambda: da.bincount(da.from_array(ZI, chunks=3)), lambda: np.bincount(ZI), True,
     ("Bincount",)),
]
CASE = {c[0]: c for c in CASES}
# the nodes a case gathers by design: a descending slice of a sharded
# axis, the shuffle's boundary, the lazy edges' two endpoints (0-d)
GATHERS = {"slice_reversed": {"Slice"}, "shuffle": {"Shuffle"}, "histogram_lazy_edges": {"LinspaceEdges"}}


def _stencil_numpy():
    p = np.pad(XF, 1, mode="symmetric")
    return p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4 * XF


def _close(got, want, exact, src_scale):
    assert got.shape == np.shape(want) and got.dtype == np.asarray(want).dtype, (got.shape, got.dtype)
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    rtol = 1e-6 if got.dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * src_scale, equal_nan=True)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", list(CASE))
def test_rule_matches_the_walk_without_a_mesh(name, mesh_name):
    _, build, np_fn, exact, nodes = CASE[name]
    e = build()
    want = np.asarray(e.compute())
    with use_mesh(mesh(mesh_name)), config.set({"execution-lane": "gspmd"}):
        before = PARTITIONED.snapshot()
        got = np.asarray(e.compute())
        parted = PARTITIONED.delta(before)
    scale = float(np.nansum(np.abs(XF)))
    _close(got, want, exact, scale)
    np_want = _stencil_numpy() if np_fn is None else np_fn()
    np.testing.assert_allclose(got, np_want, rtol=1e-9, atol=1e-9 * scale, equal_nan=True)
    for node in nodes:
        assert parted.get("slots", {}).get(node, 0) >= 1, (node, parted)
    # every other node keeps its value sharded: nothing gathered on the way
    assert set(parted.get("gathered", {})) == GATHERS.get(name, set()), parted


# -- kernels once a slot -------------------------------------------------------------


@pytest.fixture
def calls(monkeypatch):
    """Count the kernel wrappers' calls by the shape they were given."""
    from dask_array_tpu_torch.kernels import mstat, scale
    from dask_array_tpu_torch.ops import _histogram, manipulation

    seen = {"transpose": [], "scale": [], "mstat": [], "histogram": []}

    def spy(kind, fn):
        def wrapped(x, *a, **k):
            seen[kind].append(tuple(x.shape))
            return fn(x, *a, **k)

        return wrapped

    monkeypatch.setattr(manipulation, "transpose_last2", spy("transpose", manipulation.transpose_last2))
    monkeypatch.setattr(scale, "scale", spy("scale", scale.scale))
    monkeypatch.setattr(mstat, "multi_stat_packed", spy("mstat", mstat.multi_stat_packed))
    monkeypatch.setattr(_histogram, "histogram_counts", spy("histogram", _histogram.histogram_counts))
    return seen


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_kernels_run_once_a_slot(calls, mesh_name):
    xs = da.from_array(XS, chunks=(8, 12))
    with use_mesh(mesh(mesh_name)), config.set({"execution-lane": "gspmd"}):
        t = np.asarray(xs.T.compute())
        s = np.asarray((xs * da.from_array(COL.astype(np.float32), chunks=(8, 1))).compute())
        m = da.compute(xs.sum(axis=0), xs.mean(axis=1), xs.std())
        h = np.asarray(da.histogram(xs, bins=np.linspace(-3, 3, 17))[0].compute())
    np.testing.assert_array_equal(t, XS.T)
    np.testing.assert_array_equal(s, XS * COL.astype(np.float32))
    np.testing.assert_allclose(m[0], XS.sum(axis=0), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(m[1], XS.mean(axis=1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m[2], XS.std(), rtol=1e-5)
    np.testing.assert_array_equal(h, np.histogram(XS, bins=np.linspace(-3, 3, 17))[0])
    # one call a slot, each on the slot's part (8 slots; a 64 x 48 array
    # has no empty part on these meshes)
    for kind in ("transpose", "scale", "mstat", "histogram"):
        assert len(calls[kind]) == 8, (kind, calls[kind])
    # P4 on row parts (a column-sharded input is resharded to rows first)
    assert all(s[1] == 48 for s in calls["mstat"])


def test_kernels_skip_empty_parts(calls):
    zs = da.from_array(Z.astype(np.float32), chunks=(3, 6))
    with use_mesh(mesh("ring8")), config.set({"execution-lane": "gspmd"}):
        before = PARTITIONED.snapshot()
        m = da.compute(zs.sum(axis=0), zs.mean(axis=1))
        h = np.asarray(da.histogram(zs, bins=np.linspace(-2, 2, 5))[0].compute())
        skipped = PARTITIONED.delta(before)["skipped"]
    np.testing.assert_allclose(m[0], Z.astype(np.float32).sum(axis=0), rtol=1e-5)
    np.testing.assert_allclose(m[1], Z.astype(np.float32).mean(axis=1), rtol=1e-5)
    np.testing.assert_array_equal(h, np.histogram(Z.astype(np.float32), bins=np.linspace(-2, 2, 5))[0])
    # parts of 2 rows: the last three slots hold none, and take no launch
    assert len(calls["mstat"]) == 5 and len(calls["histogram"]) == 5
    assert skipped == {"MultiStat": 3, "Histogram": 3}


def test_strided_parts_reach_the_kernels(calls):
    """A column-sharded value's parts are strided views: the transpose and
    scale kernels take them as they are; the histogram's copy is counted."""
    xs = da.from_array(XS.T.copy(), chunks=(12, 8))  # 48 x 64: the ring shards the 64 columns
    with use_mesh(mesh("ring8")), config.set({"execution-lane": "gspmd"}):
        before = PARTITIONED.snapshot()
        t = np.asarray((xs.T * 1.0).compute())
        h = np.asarray(da.histogram(xs, bins=np.linspace(-3, 3, 9))[0].compute())
        parted = PARTITIONED.delta(before)
    np.testing.assert_array_equal(t, XS)
    np.testing.assert_array_equal(h, np.histogram(XS, bins=np.linspace(-3, 3, 9))[0])
    assert calls["transpose"] == [(48, 8)] * 8
    assert parted["contiguous"] == {"Histogram": 8}


# -- what the walk keeps -------------------------------------------------------------


def _pipeline(a, b):
    centered = a - a.mean(axis=0)
    scaled = centered / (a.std(axis=0) + 1e-6)
    y = scaled @ b.T
    return (y * y).sum(axis=1)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_flagship_gathers_only_its_output(mesh_name):
    a_np = RNG.standard_normal((64, 64)).astype(np.float32)
    b_np = RNG.standard_normal((32, 64)).astype(np.float32)
    a, b = da.from_array(a_np, chunks=(16, 16)), da.from_array(b_np, chunks=(16, 16))
    out = _pipeline(a, b)
    want = np.asarray(out.compute())
    with use_mesh(mesh(mesh_name)), config.set({"execution-lane": "gspmd"}):
        coll, nb, before = COLLECTIVES.snapshot(), dict(COLLECTIVES.nbytes), PARTITIONED.snapshot()
        got = np.asarray(out.compute())
        moved = COLLECTIVES.delta(coll)
        parted = PARTITIONED.delta(before)
        gathered = COLLECTIVES.nbytes["gather"] - nb["gather"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    assert "gathered" not in parted, parted
    assert moved["gather"] == 1 and gathered <= want.nbytes
    assert parted["bound"] == {"FromArray": 2}


def test_relayout_hands_its_shards_on():
    """``Rechunk`` under a mesh moves the shards (one all_to_all) and the
    consumer reads them as they are: no gather of the array follows, only
    the result's."""
    e = x().freeze_chunks().rechunk((64, 6)).sum(axis=0)
    with use_mesh(mesh("ring8")), config.set({"execution-lane": "gspmd"}):
        coll, nb = COLLECTIVES.snapshot(), dict(COLLECTIVES.nbytes)
        got = np.asarray(e.compute())
        moved = COLLECTIVES.delta(coll)
        gathered = COLLECTIVES.nbytes["gather"] - nb["gather"]
        a2a = COLLECTIVES.nbytes["all_to_all"] - nb["all_to_all"]
    np.testing.assert_allclose(got, XF.sum(axis=0), rtol=1e-12)
    assert moved == {"all_to_all": 1, "gather": 1}
    assert a2a == XF.nbytes * 7 // 8 and gathered <= got.nbytes


def test_persist_keeps_shards_and_binds_them_without_a_copy():
    m = mesh("mesh2x4")
    with use_mesh(m), config.set({"execution-lane": "gspmd"}):
        p = (x() * 2).persist()
        buf = p.expr.buffer
        assert isinstance(buf, ShardedTensor)
        ptrs = [s.data_ptr() for s in buf.shards]
        from dask_array_tpu_torch._executor import execute_views

        view = execute_views([p.expr])[0]
        assert isinstance(view, ShardedView) and view.sharded is buf
        assert [s.data_ptr() for s in view.sharded.shards] == ptrs
        coll = COLLECTIVES.snapshot()
        got = np.asarray((p + 1).compute())
        assert COLLECTIVES.delta(coll) == {"gather": 1}
    np.testing.assert_array_equal(got, XF * 2 + 1)
    # no mesh, or another: the dense form, gathered once a walk
    coll = COLLECTIVES.snapshot()
    np.testing.assert_array_equal(np.asarray((p + 1).compute()), XF * 2 + 1)
    assert COLLECTIVES.delta(coll) == {"gather": 1}
    with use_mesh(mesh("ring8")), config.set({"execution-lane": "gspmd"}):
        np.testing.assert_array_equal(np.asarray((p - 1).compute()), XF * 2 - 1)
    # pickled through its dense form (in host memory)
    _, (buf_state, *_) = p.expr.__reduce__()
    assert isinstance(buf_state, torch.Tensor) and buf_state.device.type == "cpu"
    np.testing.assert_array_equal(buf_state.numpy(), XF * 2)
    np.testing.assert_array_equal(np.asarray(pickle.loads(pickle.dumps(p)).compute()), XF * 2)


def test_a_node_read_both_ways_gathers_once():
    y = x() * 2
    # a per-slot consumer (the sum) and two dense ones (quantiles have no rule)
    outs = [y.sum(axis=1), da.nanquantile(y, 0.5, axis=1), da.median(y, axis=1)]
    with use_mesh(mesh("ring8")), config.set({"execution-lane": "gspmd"}):
        coll, before = COLLECTIVES.snapshot(), PARTITIONED.snapshot()
        got = da.compute(*outs)
        moved = COLLECTIVES.delta(coll)
        parted = PARTITIONED.delta(before)
    np.testing.assert_allclose(got[0], (XF * 2).sum(axis=1), rtol=1e-12)
    np.testing.assert_allclose(got[1], np.nanquantile(XF * 2, 0.5, axis=1), rtol=1e-12)
    np.testing.assert_allclose(got[2], np.median(XF * 2, axis=1), rtol=1e-12)
    # y gathered once for both quantiles, the row sums once as the result
    assert moved == {"gather": 2}
    assert parted["gathered"] == {"Quantile": 2}


def test_no_mesh_never_asks_the_rule_table(monkeypatch):
    from dask_array_tpu_torch.parallel import partition

    def boom(*a, **k):
        raise AssertionError("the rule table was asked without a mesh")

    monkeypatch.setattr(partition, "build", boom)
    coll, before = COLLECTIVES.snapshot(), PARTITIONED.snapshot()
    for name in ("elemwise", "sum0", "transpose", "histogram", "cumsum0", "matmul", "stencil", "slice_step"):
        _, build, np_fn, _, _ = CASE[name]
        want = _stencil_numpy() if np_fn is None else np_fn()
        np.testing.assert_allclose(np.asarray(build().compute()), want, rtol=1e-12, atol=1e-9)
    assert COLLECTIVES.delta(coll) == {} and PARTITIONED.delta(before) == {}


def test_gspmd_and_auto_agree():
    """Under "auto" the shard lane answers what it plans and the walk the
    rest; the values are the "gspmd" walk's."""
    for name in ("var", "cumsum0", "matmul", "argmax0", "slice_step", "rechunk"):
        e = CASE[name][1]()
        outs = []
        for lane in ("gspmd", "auto", "shard-map"):
            with use_mesh(mesh("mesh2x4")), config.set({"execution-lane": lane}):
                outs.append(np.asarray(e.compute()))
        for o in outs[1:]:
            np.testing.assert_allclose(o, outs[0], rtol=1e-12, atol=1e-12)


def test_sharded_tensor_irregular_parts_round_trip():
    """A slice narrows each part: the offsets become irregular, a reshard
    regularizes them, and both gather to the same array."""
    from dask_array_tpu_torch.parallel._sharded import reshard, shard

    m = mesh("ring8")
    st = shard(torch.from_numpy(XF), m, ("r", None))
    with use_mesh(m), config.set({"execution-lane": "gspmd"}):
        from dask_array_tpu_torch._executor import execute_views
        from dask_array_tpu_torch._materialize import optimize_expr

        view = execute_views([optimize_expr(xi().cumsum(axis=0)[3:50:3].expr)])[0]
    narrowed = view.sharded
    assert narrowed.bounds is not None and narrowed.axis_bounds(0)[-1] == 16
    want = np.cumsum(XI, axis=0)[3:50:3]
    np.testing.assert_array_equal(narrowed.gather(record=False).numpy(), want)
    regular = reshard(narrowed, ("r", None))
    assert regular.bounds is None and [s.shape[0] for s in regular.shards] == [2] * 8
    np.testing.assert_array_equal(regular.gather(record=False).numpy(), want)
    assert st.same_layout(("r", None)) and not narrowed.same_layout(("r", None))
