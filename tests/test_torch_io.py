"""IO through the port on the CPU, each case beside the JAX package.

Every case of the JAX package's ``tests/test_io.py``,
``tests/test_io_parity3.py``, the IO cases of
``tests/test_io_reference_cases.py``, ``tests/test_from_map_battery.py``
and ``tests/test_tiledb_fake.py`` (and the store contracts of
``tests/test_collection_parity3.py``) runs through both packages (the
``pkg`` fixture): the same program, the same seeded inputs, numpy's
values.  Then the differential checks: ``to_npy_stack`` writes the same
files byte for byte through both, ``from_map`` slice culling loads the same
blocks (the port's ``io._from_map.LOADS`` against the JAX package's loader
calls), and ``from_array`` of an h5py dataset reads the same regions.

Tolerance: IO moves bytes, so every value is compared exactly, but sums of
float data (rtol 1e-12, or numpy's allclose where the JAX test has it).
"""

import hashlib
import importlib
import os
import sys
import types

import numpy as np
import pytest
import torch

from dask_array_tpu_torch import config as tconfig

torch.set_num_threads(1)

ROOTS = {"port": "dask_array_tpu_torch", "jax": "dask_array_tpu"}


class Pkg:
    """One package under test: its top level and its modules by path."""

    def __init__(self, which):
        self.which = which
        self.root = ROOTS[which]
        self.da = importlib.import_module(self.root)
        self.assert_eq = importlib.import_module(f"{self.root}._test_utils").assert_eq

    def mod(self, path):
        return importlib.import_module(f"{self.root}.{path}")

    @property
    def FromMap(self):
        return self.mod("io._from_map").FromMap

    @property
    def Concatenate(self):
        return self.mod("ops.stacking").Concatenate


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


@pytest.fixture(params=sorted(ROOTS))
def pkg(request):
    return Pkg(request.param)


@pytest.fixture
def rng():
    return np.random.default_rng(31)


def same(got, want):
    got = np.asarray(got)
    assert got.shape == np.shape(want)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# tests/test_io.py
# ---------------------------------------------------------------------------


def test_from_map(pkg, rng):
    x = rng.standard_normal((12, 5))
    parts = [x[:4], x[4:8], x[8:]]
    calls = []

    def load(i):
        calls.append(i)
        return parts[i]

    d = pkg.da.from_map(load, range(3))
    assert calls == [0]  # only the probe call so far (laziness)
    assert d.shape == (12, 5)
    assert d.chunks == ((4, 4, 4), (5,))
    pkg.assert_eq(d, x)


def test_from_map_explicit_chunks(pkg, rng):
    x = rng.standard_normal((8, 6))
    slices = [(slice(0, 4), slice(0, 6)), (slice(4, 8), slice(0, 6))]
    d = pkg.da.from_map(lambda sl: x[sl], slices, chunks=((4, 4), (6,)), shape=(8, 6), dtype=x.dtype)
    pkg.assert_eq(d, x)


def test_from_delayed(pkg, rng):
    x = rng.standard_normal((5, 5))
    d = pkg.da.from_delayed(pkg.mod("io").delayed(lambda: x)(), shape=(5, 5), dtype=x.dtype)
    pkg.assert_eq(d, x)


def test_from_blocks(pkg, rng):
    x = rng.standard_normal((6, 4))
    d = pkg.da.from_blocks({(0, 0): x[:3], (1, 0): x[3:]}, chunks=((3, 3), (4,)))
    pkg.assert_eq(d, x)


def test_store_and_regions(pkg, rng):
    da = pkg.da
    x = rng.standard_normal((6, 6))
    d = da.from_array(x, chunks=3) + 1
    out = np.zeros((6, 6))
    da.store(d, out)
    np.testing.assert_allclose(out, x + 1)
    big = np.zeros((10, 10))
    da.store(d, big, regions=(slice(2, 8), slice(1, 7)))
    np.testing.assert_allclose(big[2:8, 1:7], x + 1)
    out2 = np.zeros((6, 6))
    handle = da.store(d, out2, compute=False)
    assert out2.sum() == 0
    handle.compute()
    np.testing.assert_allclose(out2, x + 1)


def test_hdf5_roundtrip(pkg, rng, tmp_path):
    h5py = pytest.importorskip("h5py")
    da = pkg.da
    x = rng.standard_normal((20, 10))
    d = da.from_array(x, chunks=(5, 10))
    fn = str(tmp_path / "t.h5")
    da.to_hdf5(fn, "/data/x", d)
    with h5py.File(fn, "r") as f:
        np.testing.assert_allclose(f["/data/x"][:], x)
        assert f["/data/x"].chunks == (5, 10)
    back = pkg.mod("io").from_hdf5(fn, "/data/x")
    assert back.chunks == ((5,) * 4, (10,))
    pkg.assert_eq(back, x)
    with h5py.File(fn, "r") as f:
        pkg.assert_eq(da.from_array(f["/data/x"], chunks=(10, 5)), x)


def test_npy_stack_roundtrip(pkg, rng, tmp_path):
    da = pkg.da
    x = rng.standard_normal((12, 7))
    dirname = str(tmp_path / "stack")
    da.to_npy_stack(dirname, da.from_array(x, chunks=(4, 7)), axis=0)
    assert sorted(os.listdir(dirname)) == ["0.npy", "1.npy", "2.npy", "info"]
    back = da.from_npy_stack(dirname)
    assert back.chunks == ((4, 4, 4), (7,))
    pkg.assert_eq(back, x)


def test_zarr_always_available(pkg, tmp_path):
    da = pkg.da
    with pytest.raises(FileNotFoundError):
        da.from_zarr(str(tmp_path / "nonexistent.zarr"))
    da.to_zarr(da.ones((4,), chunks=2), str(tmp_path / "out.zarr"))
    assert np.allclose(np.asarray(da.from_zarr(str(tmp_path / "out.zarr")).compute()), 1.0)


def test_store_method_and_persist_roundtrip(pkg, rng):
    x = rng.standard_normal((4, 4))
    out = np.zeros((4, 4))
    (pkg.da.from_array(x, chunks=2) * 2).store(out)
    np.testing.assert_allclose(out, x * 2)


def test_review_fixes_io(pkg, rng, tmp_path):
    h5py = pytest.importorskip("h5py")
    da = pkg.da
    x = rng.standard_normal((4, 4))
    d = da.from_array(x, chunks=2)
    fn = str(tmp_path / "m.h5")
    d.to_hdf5(fn, "/x")
    with h5py.File(fn, "r") as f:
        np.testing.assert_allclose(f["/x"][:], x)
    tgt = np.zeros((8, 8))
    stored = da.store(d + 1, tgt, regions=(slice(2, 6), slice(1, 5)), return_stored=True)
    assert stored.shape == (4, 4)
    np.testing.assert_allclose(stored.compute(), x + 1)
    parts = [x[:2], x[2:]]
    np.testing.assert_allclose(da.from_map(lambda i: parts[i], range(2), shape=(4, 4), dtype=x.dtype).compute(), x)
    np.testing.assert_allclose(
        da.from_map(lambda i: parts[i], range(2), chunks=((2, 2), (4,)), dtype=x.dtype).compute(), x)
    with pytest.raises(ValueError, match="explicit"):
        da.from_map(lambda i: parts[i], range(2), chunks=(2, 4), dtype=x.dtype)
    multi = pkg.mod("ops._map_blocks").map_blocks_multi_output
    a, b = multi(lambda blk, s: (blk + s, blk * s), d, 2.0, dtypes=["f8", "f8"])
    np.testing.assert_allclose(a.compute(), x + 2.0)
    np.testing.assert_allclose(b.compute(), x * 2.0)


def test_from_graph_external_task_graph(pkg, rng):
    x = rng.standard_normal((4, 6))

    def half(i):
        return x[i * 2:(i + 1) * 2]

    graph = {
        ("src", 0, 0): (half, 0),
        ("src", 1, 0): (half, 1),
        ("out", 0, 0): (np.add, ("src", 0, 0), (np.multiply, ("src", 0, 0), 0.5)),
        ("out", 1, 0): (np.add, ("src", 1, 0), 1.0),
    }
    arr = pkg.mod("io").from_graph(graph, np.empty((0, 0)), ((2, 2), (6,)), [("out", 0, 0), ("out", 1, 0)], "out")
    want = np.concatenate([x[:2] * 1.5, x[2:] + 1.0])
    pkg.assert_eq(arr, want)
    pkg.assert_eq(arr.sum(axis=0), want.sum(axis=0))


def test_from_graph_with_dependencies(pkg, rng):
    x = rng.standard_normal((6,))
    dep = pkg.da.from_array(x, chunks=3) * 2
    dep_name = dep.expr._name
    graph = {("o", 0): (np.negative, (dep_name, 0)), ("o", 1): (np.negative, (dep_name, 1))}
    arr = pkg.mod("io").from_graph(graph, np.empty((0,)), ((3, 3),), [("o", 0), ("o", 1)], "o", dependencies=(dep,))
    pkg.assert_eq(arr, -(x * 2))


def test_from_graph_key_count_mismatch(pkg):
    with pytest.raises(ValueError, match="keys"):
        pkg.mod("io").from_graph({}, np.empty((0,)), ((3, 3),), [("o", 0)], "o")


# ---------------------------------------------------------------------------
# tests/test_io_parity3.py: hdf5 chunk specs, several datasets, npy stacks
# ---------------------------------------------------------------------------


def test_to_hdf5_method(pkg, tmp_path):
    h5py = pytest.importorskip("h5py")
    x = pkg.da.ones((4, 4), chunks=(2, 2))
    fn = str(tmp_path / "a.hdf5")
    x.to_hdf5(fn, "/x")
    with h5py.File(fn, mode="r") as f:
        pkg.assert_eq(f["/x"][:], x)
        assert f["/x"].chunks == (2, 2)


@pytest.mark.parametrize("chunks, want", [(None, None), ((1, 1), (1, 1))])
def test_to_hdf5_chunks_none_and_explicit(pkg, tmp_path, chunks, want):
    h5py = pytest.importorskip("h5py")
    x = pkg.da.ones((4, 4), chunks=(2, 2))
    fn = str(tmp_path / "a.hdf5")
    x.to_hdf5(fn, "/x", chunks=chunks)
    with h5py.File(fn, mode="r") as f:
        pkg.assert_eq(f["/x"][:], x)
        assert f["/x"].chunks == want


def test_to_hdf5_multiple_datasets(pkg, tmp_path):
    h5py = pytest.importorskip("h5py")
    da = pkg.da
    x = da.ones((4, 4), chunks=(2, 2))
    y = da.ones(4, chunks=2, dtype="i4")
    fn = str(tmp_path / "a.hdf5")
    da.to_hdf5(fn, {"/x": x, "/y": y})
    with h5py.File(fn, mode="r") as f:
        pkg.assert_eq(f["/x"][:], x)
        assert f["/x"].chunks == (2, 2)
        pkg.assert_eq(f["/y"][:], y)
        assert f["/y"].chunks == (2,)


def test_to_hdf5_bad_args(pkg, tmp_path):
    pytest.importorskip("h5py")
    fn = str(tmp_path / "a.hdf5")
    with pytest.raises(ValueError):
        pkg.da.to_hdf5(fn, "/x", pkg.da.ones(4), "extra")
    with pytest.raises(ValueError):
        pkg.da.to_hdf5(fn)


def test_hdf5_dataset_from_array_storage_chunks(pkg, tmp_path):
    """from_array of a live h5py dataset defaults to the storage granules."""
    h5py = pytest.importorskip("h5py")
    x = np.arange(24.0).reshape(4, 6)
    fn = str(tmp_path / "a.hdf5")
    with h5py.File(fn, mode="w") as f:
        f.create_dataset("/data/x", data=x, chunks=(2, 3))
    with h5py.File(fn, mode="r") as f:
        d = pkg.da.from_array(f["/data/x"])
        assert all(c % g == 0 for cs, g in zip(d.chunks, (2, 3)) for c in cs)
        pkg.assert_eq(d, x)
        e = pkg.da.from_array(f["/data/x"], chunks=(2, 3), name="x-roundtrip")
        assert e.name == "x-roundtrip"
        pkg.assert_eq(e, x)


def test_to_npy_stack_roundtrip(pkg, tmp_path):
    x = np.arange(48.0).reshape(4, 12)
    dirname = str(tmp_path / "stack")
    pkg.da.to_npy_stack(dirname, pkg.da.from_array(x, chunks=(2, 12)))
    pkg.assert_eq(pkg.da.from_npy_stack(dirname), x)


@pytest.mark.parametrize("axis", [0, 1])
def test_npy_stack_roundtrip_axis(pkg, tmp_path, axis):
    x = np.arange(60.0).reshape(6, 10)
    dirname = str(tmp_path / f"stack{axis}")
    pkg.da.to_npy_stack(dirname, pkg.da.from_array(x, chunks=(3, 5)), axis=axis)
    pkg.assert_eq(pkg.da.from_npy_stack(dirname), x)


@pytest.mark.parametrize("mmap_mode", ["r", None])
def test_npy_stack_mmap_mode(pkg, tmp_path, mmap_mode):
    x = np.arange(20.0).reshape(4, 5)
    dirname = str(tmp_path / "stackm")
    pkg.da.to_npy_stack(dirname, pkg.da.from_array(x, chunks=(2, 5)))
    pkg.assert_eq(pkg.da.from_npy_stack(dirname, mmap_mode=mmap_mode), x)


def test_npy_stack_sliced_and_rechunked_read(pkg, tmp_path):
    x = np.arange(120.0).reshape(12, 10)
    dirname = str(tmp_path / "stacks")
    pkg.da.to_npy_stack(dirname, pkg.da.from_array(x, chunks=(3, 10)))
    back = pkg.da.from_npy_stack(dirname)
    pkg.assert_eq(back[2:10, 1:9], x[2:10, 1:9])
    pkg.assert_eq(back.rechunk((6, 5)).sum(axis=0), x.sum(axis=0))


# ---------------------------------------------------------------------------
# tests/test_io_reference_cases.py: the store and from_map cases
# ---------------------------------------------------------------------------


def test_store_compute_false(pkg, rng):
    x = rng.standard_normal((6, 8))
    tgt = np.zeros((6, 8))
    handle = pkg.da.store(pkg.da.from_array(x, chunks=(3, 4)), tgt, compute=False)
    assert not np.any(tgt)
    handle.compute()
    np.testing.assert_allclose(tgt, x)


def test_store_return_stored(pkg, rng):
    x = rng.standard_normal((6, 8))
    tgt = np.zeros((6, 8))
    out = pkg.da.store(pkg.da.from_array(x, chunks=(3, 4)), tgt, return_stored=True)
    arr = out[0] if isinstance(out, (list, tuple)) else out
    np.testing.assert_allclose(np.asarray(arr.compute()), x)
    np.testing.assert_allclose(tgt, x)


def test_store_regions_multiple(pkg, rng):
    da = pkg.da
    x = rng.standard_normal((3, 4))
    tgt = np.zeros((6, 8))
    da.store(da.from_array(x, chunks=2), tgt, regions=(slice(0, 3), slice(2, 6)))
    np.testing.assert_allclose(tgt[0:3, 2:6], x)
    a, b = rng.standard_normal((4, 4)), rng.standard_normal((4, 4))
    t1, t2 = np.zeros((4, 4)), np.zeros((4, 4))
    da.store([da.from_array(a, chunks=2), da.from_array(b, chunks=2)], [t1, t2])
    np.testing.assert_allclose(t1, a)
    np.testing.assert_allclose(t2, b)


def test_from_map_only_computes_needed_blocks(pkg):
    calls = []

    def make(i):
        calls.append(i)
        return np.full((3,), float(i))

    d = pkg.da.from_map(make, range(4), chunks=((3, 3, 3, 3),), dtype="f8")
    np.testing.assert_allclose(np.asarray(d[6:9].compute()), np.full(3, 2.0))
    assert set(calls) <= {2}, calls


def test_from_delayed_of_a_callable(pkg):
    v = pkg.da.from_delayed(lambda: np.ones((2, 2)), shape=(2, 2), dtype="f8")
    np.testing.assert_allclose(np.asarray(v.compute()), np.ones((2, 2)))


def test_from_array_hdf5_dataset_naming(pkg, tmp_path):
    h5py = pytest.importorskip("h5py")
    x = np.arange(24.0).reshape(4, 6)
    fn = str(tmp_path / "n.h5")
    pkg.da.to_hdf5(fn, "/data/x", pkg.da.from_array(x, chunks=(2, 3)))
    with h5py.File(fn, "r") as f:
        e = pkg.da.from_array(f["/data/x"], chunks=(2, 3))
        assert e.name == e.expr._name
        same(e.compute(), x)
        e2 = pkg.da.from_array(f["/data/x"], chunks=(2, 3), name="my-hdf5-data")
        assert e2.name == "my-hdf5-data"
        same(e2.compute(), x)


# ---------------------------------------------------------------------------
# store contracts (tests/test_collection_parity3.py)
# ---------------------------------------------------------------------------


class StoreTarget:
    """A zarr.Array-ish write target carrying per-target state."""

    def __init__(self, name, shape):
        self.name = name
        self.data = np.zeros(shape)

    def __setitem__(self, index, value):
        self.data[index] = value


def _unwrap(block):
    if isinstance(block, np.ndarray) and block.dtype == object and block.shape == ():
        return block.item()
    return block


def test_store_compute_false_return_stored_roundtrip(pkg):
    x = np.arange(12).reshape(3, 4)
    target = np.empty_like(x)
    writes = pkg.da.store(pkg.da.from_array(x, chunks=(2, 2)), target, compute=False, return_stored=True)
    result = np.asarray(writes.compute())
    same(target, x)
    same(result, x)


def test_store_load_stored_false_returns_targets_not_values(pkg):
    """Each block of the returned array is the target that was written
    (an object payload, kept on the host by the port)."""
    source = pkg.da.from_array(np.arange(8.0), chunks=4)
    target = StoreTarget("t", (8,))
    stored = pkg.da.store(source, target, compute=False, return_stored=True, load_stored=False, lock=False)
    blocks = [_unwrap(stored.blocks[i].compute()) for i in range(2)]
    assert all(block is target for block in blocks)
    same(target.data, np.arange(8.0))


def test_store_load_stored_false_feeds_followup_reduction(pkg):
    def read_name(block, axis=None, keepdims=None, computing_meta=False):
        if computing_meta:
            return np.array([object()], dtype=object)
        return np.array([_unwrap(block).name], dtype=object)

    def collect(names, axis=None, keepdims=None, computing_meta=False):
        if computing_meta:
            return np.array([object()], dtype=object)
        return np.array(sorted(np.concatenate(names).tolist()), dtype=object)

    source = pkg.da.from_array(np.arange(12.0), chunks=4)
    target = StoreTarget("t", (12,))
    stored = pkg.da.store(source, target, compute=False, return_stored=True, load_stored=False, lock=False)
    reduced = pkg.da.reduction(stored, chunk=read_name, aggregate=collect, concatenate=False, keepdims=False,
                               dtype=object, meta=np.array([object()], dtype=object))
    assert reduced.compute().tolist() == ["t", "t", "t"]
    same(target.data, np.arange(12.0))


def test_store_region_rechunked_exact_name_slice(pkg):
    y = pkg.da.from_array(np.ones(30), chunks=(10, 10, 10), name="x")[5:25].rechunk((10, 10))
    target = np.zeros(30)
    pkg.da.store(y, target, regions=(slice(5, 25),))
    expected = np.zeros(30)
    expected[5:25] = 1
    same(target, expected)


# ---------------------------------------------------------------------------
# tests/test_from_map_battery.py: values, the grouped collapse, declines
# ---------------------------------------------------------------------------


def mk(i):
    return np.full((4, 3), i, dtype=np.float64)


def mk_block(i):
    return np.full((2, 3), i, dtype=np.float64)


def _parts(pkg, n, shape=(4, 3)):
    io = pkg.mod("io")
    return [io.from_delayed(io.delayed(mk)(i), shape=shape, dtype="f8") for i in range(n)]


def test_from_map_values_and_structure(pkg):
    fm = pkg.da.from_map(mk_block, [0, 1, 2, 3], chunks=((2, 2), (3, 3)))
    assert type(fm.expr) is pkg.FromMap
    assert fm.chunks == ((2, 2), (3, 3))
    same(fm.compute(), np.block([[mk_block(0), mk_block(1)], [mk_block(2), mk_block(3)]]))


def test_from_map_passes_constant_kwargs(pkg):
    def f(i, scale=1):
        return np.full((2,), i * scale, dtype="f8")

    fm = pkg.da.from_map(f, [1, 2, 3], chunks=((2, 2, 2),), scale=10)
    same(fm.compute(), np.repeat([10, 20, 30], 2).astype("f8"))


def test_from_map_over_3d_block_grid(pkg):
    fm = pkg.da.from_map(lambda i: np.full((2, 2, 2), i, dtype="f8"), list(range(8)), chunks=((2, 2), (2, 2), (2, 2)))
    got = np.asarray(fm.compute())
    assert got[0, 0, 0] == 0 and got[0, 0, 3] == 1 and got[0, 3, 0] == 2 and got[3, 0, 0] == 4
    assert got.shape == (4, 4, 4)


def test_from_map_rejects_values_shape_mismatch(pkg):
    bad = pkg.da.from_map(lambda i: np.zeros((5,)), [0], chunks=((3,),), dtype="f8")
    with pytest.raises(ValueError, match="expected"):
        bad.compute()


def test_from_map_scalar_return_supports_0d_block(pkg):
    fm = pkg.da.from_map(lambda i: np.float64(i * 2), [3], chunks=((1,),), dtype="f8")
    same(fm.compute(), [6.0])


def test_from_map_requires_chunk_grid_match(pkg):
    with pytest.raises(ValueError, match="blocks"):
        pkg.da.from_map(mk, [0, 1, 2], chunks=((4, 4), (3,)), dtype="f8")


def test_from_map_loader_may_return_a_tensor(pkg):
    """A loader of the port may return a torch tensor; the JAX package's
    takes the same block as numpy."""
    port = pkg.which == "port"
    fm = pkg.da.from_map(lambda i: torch.full((2, 3), float(i)) if port else np.full((2, 3), float(i)),
                         [0, 1], chunks=((2, 2), (3,)))
    assert fm.dtype == np.float32 if port else fm.dtype == np.float64
    same(fm.compute(), np.repeat([0.0, 1.0], 6).reshape(4, 3))


@pytest.mark.parametrize("axis", [0, 1])
def test_stack_of_from_delayed_becomes_one_from_map(pkg, axis):
    parts = _parts(pkg, 10 if axis == 0 else 5)
    s = pkg.da.stack(parts, axis=axis)
    opt = s.expr.simplify()
    assert type(opt) is pkg.FromMap
    assert len(list(opt.walk())) == 1
    if axis == 0:
        assert opt.chunks == ((1,) * 10, (4,), (3,))
    same(s.compute(), np.stack([mk(i) for i in range(len(parts))], axis=axis))


def test_concatenate_of_from_delayed_becomes_one_from_map(pkg):
    c = pkg.da.concatenate(_parts(pkg, 6), axis=0)
    opt = c.expr.simplify()
    assert type(opt) is pkg.FromMap
    assert opt.chunks == ((4,) * 6, (3,))
    same(c.compute(), np.concatenate([mk(i) for i in range(6)]))


def test_concatenate_of_from_map_merges_into_one(pkg):
    fm1 = pkg.da.from_map(mk_block, [0, 1, 2, 3], chunks=((2, 2), (3, 3)))
    fm2 = pkg.da.from_map(mk_block, [10, 11, 12, 13], chunks=((2, 2), (3, 3)))
    e1 = np.block([[mk_block(0), mk_block(1)], [mk_block(2), mk_block(3)]])
    e2 = np.block([[mk_block(10), mk_block(11)], [mk_block(12), mk_block(13)]])
    for axis in (0, 1):
        m = pkg.da.concatenate([fm1, fm2], axis=axis)
        assert type(m.expr.simplify()) is pkg.FromMap, axis
        same(m.compute(), np.concatenate([e1, e2], axis=axis))


def test_nested_concatenate_of_stacks_collapses_to_one_from_map(pkg):
    parts = _parts(pkg, 6)
    nested = pkg.da.concatenate([pkg.da.stack(parts[:3]), pkg.da.stack(parts[3:])], axis=0)
    opt = nested.expr.simplify()
    assert type(opt) is pkg.FromMap
    assert len(list(opt.walk())) == 1
    same(nested.compute(), np.stack([mk(i) for i in range(6)]))


def test_block_of_from_delayed_collapses_to_one_from_map(pkg):
    parts = _parts(pkg, 4)
    b = pkg.da.block([[parts[0], parts[1]], [parts[2], parts[3]]])
    assert type(b.expr.simplify()) is pkg.FromMap
    same(b.compute(), np.block([[mk(0), mk(1)], [mk(2), mk(3)]]))


def test_expand_dims_folds_into_from_map(pkg):
    fm = pkg.da.from_map(mk_block, [0, 1], chunks=((2, 2), (3,)))
    e = pkg.da.expand_dims(fm, 0)
    opt = e.expr.simplify()
    assert type(opt) is pkg.FromMap
    assert opt.chunks == ((1,), (2, 2), (3,))
    same(e.compute(), np.concatenate([mk_block(0), mk_block(1)])[None])


def test_merge_declines_when_func_differs(pkg):
    def other(i):
        return np.full((4, 3), -i, dtype=np.float64)

    io = pkg.mod("io")
    a = io.from_delayed(io.delayed(mk)(1), shape=(4, 3), dtype="f8")
    b = io.from_delayed(io.delayed(other)(5), shape=(4, 3), dtype="f8")
    m = pkg.da.concatenate([a, b], axis=0)
    assert type(m.expr.simplify()) is pkg.Concatenate
    same(m.compute(), np.concatenate([mk(1), other(5)]))


def test_merge_declines_when_kwargs_differ(pkg):
    def f(i, scale=1):
        return np.full((2,), i * scale, dtype="f8")

    m = pkg.da.concatenate([pkg.da.from_map(f, [1], chunks=((2,),), scale=10),
                            pkg.da.from_map(f, [1], chunks=((2,),), scale=20)], axis=0)
    assert type(m.expr.simplify()) is pkg.Concatenate
    same(m.compute(), [10, 10, 20, 20])


def test_merge_declines_when_off_axis_chunks_differ(pkg):
    def f(i):
        return np.full((4, 3), i, dtype="f8")

    a = pkg.da.from_map(f, [0, 1], chunks=((4, 4), (3,)))
    b = pkg.da.from_map(f, [2], chunks=((4,), (3,)))
    assert type(pkg.da.concatenate([a, b], axis=0).expr.simplify()) is pkg.FromMap
    c = pkg.da.from_map(f, [5, 6], chunks=((4,), (1, 2)))
    assert type(pkg.da.concatenate([a, c], axis=0).expr.simplify()) is pkg.Concatenate


def test_collapsed_stack_slices_cull_loader_calls(pkg):
    calls = []

    def spy(i):
        calls.append(i)
        return np.full((4, 3), i, dtype=np.float64)

    io = pkg.mod("io")
    parts = [io.from_delayed(io.delayed(spy)(i), shape=(4, 3), dtype="f8") for i in range(10)]
    z = pkg.da.stack(parts, axis=0)[7]
    same(z.compute(), mk(7))
    assert sorted(set(calls)) == [7]


def test_collapsed_plan_stays_small_at_width(pkg):
    opt = pkg.da.stack(_parts(pkg, 200), axis=0).expr.simplify()
    assert type(opt) is pkg.FromMap
    assert len(opt.args_per_block) == 200
    assert len(list(opt.walk())) == 1


def _obj(values):
    a = np.empty(len(values), dtype=object)
    a[:] = list(values)
    return a


def test_from_map_object_values_grid_1d(pkg):
    a = pkg.da.from_map(lambda v: np.full(5, v, dtype="int64"), _obj([1, 2, 3]), chunks=((5, 5, 5),), dtype="int64")
    assert a.shape == (15,)
    same(a.compute(), np.concatenate([np.full(5, v) for v in [1, 2, 3]]).astype("int64"))


def test_from_map_object_values_grid_2d(pkg):
    values = np.empty((2, 2), dtype=object)
    values[:] = [[1, 2], [3, 4]]
    a = pkg.da.from_map(lambda v: np.full((2, 3), v, dtype="int64"), values, chunks=((2, 2), (3, 3)), dtype="int64")
    assert a.shape == (4, 6) and a.numblocks == (2, 2)
    same(a.compute(), np.block([[np.full((2, 3), 1), np.full((2, 3), 2)],
                                [np.full((2, 3), 3), np.full((2, 3), 4)]]).astype("int64"))


def test_from_map_object_values_grid_3d_noncontiguous(pkg):
    base = np.empty((3, 2), dtype=object)
    base[:] = (np.arange(6).reshape(3, 2) * 10).tolist()
    vals = base.T
    assert vals.shape == (2, 3) and not vals.flags["C_CONTIGUOUS"]
    a = pkg.da.from_map(lambda v: np.full((2, 4), v, dtype="int64"), vals, chunks=((2, 2), (4, 4, 4)), dtype="int64")
    got = np.asarray(a.compute())
    for i in range(2):
        for j in range(3):
            assert (got[2 * i:2 * i + 2, 4 * j:4 * j + 4] == int(vals[i, j])).all()


def test_from_map_0d_block_grid_scalar_coerced(pkg):
    values = np.empty((), dtype=object)
    values[()] = 7
    a = pkg.da.from_map(lambda v: v * 2, values, chunks=(), dtype="int64")
    assert a.shape == ()
    assert int(a.compute()) == 14


def test_from_map_object_grid_requires_chunks(pkg):
    with pytest.raises(ValueError, match="chunks"):
        pkg.da.from_map(mk, _obj([1, 2, 3]), dtype="int64")


def test_from_map_object_grid_block_grid_mismatch(pkg):
    with pytest.raises(ValueError, match="block grid"):
        pkg.da.from_map(mk, _obj([1, 2]), chunks=((5, 5, 5),), dtype="int64")


def test_from_map_rejects_reordering_shape_mismatch(pkg):
    values = np.empty((1, 1), dtype=object)
    values[0, 0] = 0
    bad = pkg.da.from_map(lambda _: np.arange(6).reshape(3, 2), values, chunks=((2,), (3,)), dtype="int64")
    with pytest.raises(ValueError, match="incompatible with the declared chunk shape"):
        bad.compute()


def test_named_from_delayed_name_preserved(pkg):
    io = pkg.mod("io")
    a = io.from_delayed(io.delayed(mk)(7), shape=(4, 3), dtype="f8", name="myblock")
    assert a.name == "myblock"
    same(a.compute(), mk(7))
    b = io.from_delayed(io.delayed(mk)(8), shape=(4, 3), dtype="f8", name="other")
    s = pkg.da.stack([a, b])
    assert type(s.expr.simplify()) is not pkg.FromMap
    same(s.compute(), np.stack([mk(7), mk(8)]))


def test_multi_task_delayed_body_resolves(pkg):
    io = pkg.mod("io")

    def multi():
        return io.delayed(lambda x, y: (x + y).astype("int64"))(io.delayed(np.ones)(5), io.delayed(np.zeros)(5))

    arr = pkg.da.stack([io.from_delayed(multi(), shape=(5,), dtype="int64") for _ in range(2)])
    same(arr.compute(), np.stack([np.ones(5), np.ones(5)]).astype("int64"))

    def scaled(k):
        return io.delayed(lambda x, y, k=k: (x * k + y).astype("int64"))(io.delayed(np.ones)(5),
                                                                          io.delayed(np.zeros)(5))

    arr2 = pkg.da.stack([io.from_delayed(scaled(2), shape=(5,), dtype="int64"),
                         io.from_delayed(scaled(3), shape=(5,), dtype="int64")])
    assert type(arr2.expr.simplify()) is not pkg.FromMap
    same(arr2.compute(), np.stack([np.full(5, 2), np.full(5, 3)]).astype("int64"))


def _full_parts(pkg, values, shape):
    io = pkg.mod("io")
    return [io.from_delayed(io.delayed(np.full)(shape, v, "int64"), shape=shape, dtype="int64") for v in values]


def test_nested_stacks_build_3d_from_map(pkg):
    parts = _full_parts(pkg, [1, 2, 3, 4], (5,))
    arr = pkg.da.stack([pkg.da.stack(parts[:2]), pkg.da.stack(parts[2:])])
    assert type(arr.expr.simplify()) is pkg.FromMap
    assert arr.shape == (2, 2, 5)
    same(arr.compute(), np.stack([np.stack([np.full(5, 1), np.full(5, 2)]),
                                  np.stack([np.full(5, 3), np.full(5, 4)])]).astype("int64"))


def test_mixed_rank_block_collapses_to_one_from_map(pkg):
    arr = pkg.da.block([[p] for p in _full_parts(pkg, [1, 2], (3,))])
    assert type(arr.expr.simplify()) is pkg.FromMap
    assert arr.shape == (2, 3)
    same(arr.compute(), np.block([[np.full((3,), 1)], [np.full((3,), 2)]]).astype("int64"))


def test_coalesced_from_map_dedup_same_and_distinct(pkg):
    io = pkg.mod("io")

    def build(vals):
        return pkg.da.concatenate([io.from_delayed(io.delayed(mk)(v), shape=(4, 3), dtype="f8") for v in vals])

    assert build([1, 2, 3]).expr.simplify()._name == build([1, 2, 3]).expr.simplify()._name
    assert build([1, 2, 3]).expr.simplify()._name != build([1, 2, 9]).expr.simplify()._name


def test_direct_from_map_dedups(pkg):
    a = pkg.da.from_map(mk_block, [0, 1, 2, 3], chunks=((2, 2), (3, 3)))
    b = pkg.da.from_map(mk_block, [0, 1, 2, 3], chunks=((2, 2), (3, 3)))
    assert a.expr._name == b.expr._name


def test_value_correctness_through_rechunk(pkg):
    x = pkg.da.concatenate(_full_parts(pkg, [1, 2, 3, 4], (5,))).rechunk((4,))
    same(x.compute(), np.concatenate([np.full(5, v) for v in [1, 2, 3, 4]]).astype("int64"))


def test_opaque_from_map_never_merges(pkg):
    a = pkg.da.from_map(lambda i: np.full((2,), i, "f8"), [0, 1], chunks=((2, 2),), dtype="f8", _opaque=True)
    b = pkg.da.from_map(lambda i: np.full((2,), i, "f8"), [2, 3], chunks=((2, 2),), dtype="f8", _opaque=True)
    assert type(pkg.da.concatenate([a, b], axis=0).expr.simplify()) is not pkg.FromMap


def test_mixed_consumers_still_correct(pkg):
    parts = _parts(pkg, 3)
    s = pkg.da.stack(parts, axis=0)
    total = s.sum() + (parts[1] + 1).sum()
    expected = np.stack([mk(i) for i in range(3)]).sum() + (mk(1) + 1).sum()
    assert np.isclose(float(total.compute()), expected)


def test_from_delayed_of_unknown_length(pkg):
    """A nan-shaped from_delayed adopts the block's shape when it loads."""
    io = pkg.mod("io")
    a = io.from_delayed(io.delayed(np.arange)(7.0), shape=(np.nan,), dtype="f8")
    same(a.compute(), np.arange(7.0))


# ---------------------------------------------------------------------------
# tests/test_tiledb_fake.py: the tiledb shim against an in-memory fake
# ---------------------------------------------------------------------------


class _FakeDim:
    def __init__(self, size, tile):
        self.size = size
        self.tile = tile


class _FakeDomain:
    def __init__(self, dims):
        self._dims = dims

    def dim(self, i):
        return self._dims[i]


class _FakeAttr:
    def __init__(self, name, dtype):
        self.name = name
        self.dtype = dtype


class _FakeSchema:
    def __init__(self, shape, tiles, dtype, attr_name=""):
        self.domain = _FakeDomain([_FakeDim(s, t) for s, t in zip(shape, tiles)])
        self.ndim = len(shape)
        self._attr = _FakeAttr(attr_name, dtype)

    def attr(self, i_or_name):
        return self._attr


class FakeTileDBArray:
    def __init__(self, data, tiles, attr_name=""):
        self._data = np.asarray(data)
        self.schema = _FakeSchema(self._data.shape, tiles, self._data.dtype, attr_name)
        self._attr_name = attr_name

    def __getitem__(self, sl):
        return {self._attr_name: self._data[sl]}

    def __setitem__(self, sl, value):
        self._data[sl] = value


def _install_fake(monkeypatch, registry):
    try:
        import tiledb  # noqa: F401

        pytest.skip("real tiledb installed; fake not applicable")
    except ImportError:
        pass
    mod = types.ModuleType("tiledb")
    mod.Array = FakeTileDBArray
    mod.open = lambda uri, **kw: registry[uri]

    def empty_like(uri, darray, key=None, **kw):
        arr = FakeTileDBArray(np.zeros(darray.shape, dtype=darray.dtype), tuple(c[0] for c in darray.chunks))
        registry[uri] = arr
        return arr

    mod.empty_like = empty_like
    monkeypatch.setitem(sys.modules, "tiledb", mod)


def test_from_tiledb_reads_by_tile(pkg, rng, monkeypatch):
    registry = {}
    _install_fake(monkeypatch, registry)
    x = rng.standard_normal((12, 8))
    registry["mem://a"] = FakeTileDBArray(x, tiles=(4, 4))
    arr = pkg.da.from_tiledb("mem://a")
    assert arr.chunks == ((4, 4, 4), (4, 4))
    pkg.assert_eq(arr, x)
    pkg.assert_eq(arr[:4, :4], x[:4, :4])


def test_from_tiledb_explicit_chunks(pkg, rng, monkeypatch):
    registry = {}
    _install_fake(monkeypatch, registry)
    x = rng.standard_normal((10,))
    registry["mem://b"] = FakeTileDBArray(x, tiles=(5,))
    arr = pkg.da.from_tiledb("mem://b", chunks=(2,))
    assert arr.chunks == ((2,) * 5,)
    pkg.assert_eq(arr, x)


def test_to_tiledb_roundtrip(pkg, rng, monkeypatch):
    registry = {}
    _install_fake(monkeypatch, registry)
    x = rng.standard_normal((8, 6))
    pkg.da.to_tiledb(pkg.da.from_array(x, chunks=(4, 3)) * 2, "mem://out")
    np.testing.assert_allclose(registry["mem://out"]._data, x * 2)
    pkg.assert_eq(pkg.da.from_tiledb("mem://out"), x * 2)


def test_to_tiledb_compute_false_and_method(pkg, rng, monkeypatch):
    registry = {}
    _install_fake(monkeypatch, registry)
    x = rng.standard_normal((6,))
    d = pkg.da.from_array(x, chunks=3)
    handle = pkg.da.to_tiledb(d, "mem://lazy", compute=False)
    assert registry["mem://lazy"]._data.sum() == 0
    handle.compute()
    np.testing.assert_allclose(registry["mem://lazy"]._data, x)
    d.to_tiledb("mem://method")
    np.testing.assert_allclose(registry["mem://method"]._data, x)


def test_tiledb_gated_without_lib(pkg):
    try:
        import tiledb  # noqa: F401

        pytest.skip("real tiledb installed")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="tiledb"):
        pkg.da.from_tiledb("mem://nope")
    with pytest.raises(ImportError, match="tiledb"):
        pkg.da.to_tiledb(pkg.da.ones(3), "mem://nope")


# ---------------------------------------------------------------------------
# the port's own: to_delayed, LOADS, and differential checks
# ---------------------------------------------------------------------------


def test_to_delayed_blocks(pkg, rng):
    x = rng.standard_normal((6, 4))
    handles = pkg.da.from_array(x, chunks=(3, 2)).to_delayed()
    assert handles.shape == (2, 2) and handles.dtype == object
    same(handles[1, 0].compute(), x[3:, :2])


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


@pytest.mark.parametrize("dtype", ["float32", "float64", "int64", "uint32", "bool"])
@pytest.mark.parametrize("axis", [0, 1])
def test_to_npy_stack_writes_the_same_files_as_the_jax_package(tmp_path, dtype, axis):
    x = (np.random.default_rng(5).standard_normal((12, 10)) * 100).astype(dtype)
    port, jax = Pkg("port"), Pkg("jax")
    for p in (port, jax):
        p.da.to_npy_stack(str(tmp_path / p.which), p.da.from_array(x, chunks=(5, 4)), axis=axis)
    # the pickled info holds each package's own dtype object: its bytes
    # are compared after loading
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if k != "info"} == {k: v for k, v in want.items() if k != "info"}
    import pickle

    infos = [pickle.load(open(tmp_path / w / "info", "rb")) for w in ("port", "jax")]
    assert infos[0]["chunks"] == infos[1]["chunks"] and infos[0]["axis"] == infos[1]["axis"]
    assert np.dtype(infos[0]["dtype"]) == np.dtype(infos[1]["dtype"])
    same(port.da.from_npy_stack(str(tmp_path / "jax")).compute(), x)


_CALLS = []


def _recorded_block(i):
    _CALLS.append(i)
    return np.full((3,), float(i))


@pytest.mark.parametrize("index", [np.s_[6:9], np.s_[0:3], np.s_[2:7], np.s_[10], np.s_[:], np.s_[3:12]])
def test_from_map_culling_loads_the_blocks_the_jax_package_loads(index):
    """The same slice through both packages calls the loader on the same
    blocks; the port's ``LOADS`` counts them."""
    from dask_array_tpu_torch.io import _from_map

    loaded = {}
    out = {}
    for which in ("port", "jax"):
        p = Pkg(which)
        d = p.da.from_map(_recorded_block, range(4), chunks=((3, 3, 3, 3),), dtype="f8")
        _CALLS.clear()
        _from_map.LOADS = 0
        out[which] = np.asarray(d[index].compute())
        loaded[which] = list(_CALLS)
        if which == "port":
            assert _from_map.LOADS == len(_CALLS)
    assert sorted(loaded["port"]) == sorted(loaded["jax"])
    same(out["port"], out["jax"])
    same(out["port"], np.repeat(np.arange(4.0), 3)[index])


def test_h5py_dataset_reads_the_regions_the_jax_package_reads(tmp_path):
    """from_array of an h5py dataset: the same reads through both packages
    (recorded on a wrapper that forwards to the dataset)."""
    h5py = pytest.importorskip("h5py")
    x = np.arange(100 * 60, dtype="f8").reshape(100, 60)
    fn = str(tmp_path / "r.h5")
    with h5py.File(fn, "w") as f:
        f.create_dataset("x", data=x, chunks=(10, 20))

    class Recording:
        def __init__(self, dset):
            self.dset, self.calls = dset, []
            self.shape, self.dtype, self.chunks, self.ndim = dset.shape, dset.dtype, dset.chunks, dset.ndim

        def __getitem__(self, sl):
            self.calls.append(sl)
            return self.dset[sl]

    reads = {}
    with h5py.File(fn, "r") as f:
        for which in ("port", "jax"):
            p = Pkg(which)
            rec = Recording(f["x"])
            d = p.da.from_array(rec)
            assert all(c % g == 0 for cs, g in zip(d.chunks[:-1], (10, 20)) for c in cs[:-1])
            same(d[15:25, 35:45].compute(), x[15:25, 35:45])
            same(p.da.from_array(rec, chunks=(10, 20)).rechunk((20, 40)).compute(), x)
            reads[which] = [tuple((s.start, s.stop, s.step) for s in sl) for sl in rec.calls]
    assert reads["port"] == reads["jax"]
    assert reads["port"][0] == ((15, 25, 1), (35, 45, 1))
