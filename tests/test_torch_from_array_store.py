"""``from_array`` of an array-like store through the port, beside the JAX
package, on the CPU.

A store (anything with ``shape``, ``dtype``, ``chunks`` and
``__getitem__``: an h5py dataset, a zarr array) stays as it is until
compute time, and then only the region a slice needs is read.  The grid
defaults to the storage granule (``shards`` before ``chunks``), and a
rechunk is absorbed into the leaf only where its boundaries land on
granule edges.  Each program runs on a recording store through the port
and through the JAX package: the same reads (each ``__getitem__`` index),
the same grid, the same leaf grid after ``simplify()``, and numpy's values.
Then the same programs on an h5py dataset behind a recording wrapper, and
the full signature.

The JAX package names a store by its pickle and interns expressions by
name while they live, so two equal stores alive at once share one
expression there, and a compute reads the first
(``KNOWN_REFERENCE_FAULTS``, checked to differ).  ``_run`` collects
cycles first, so that only a live store can collide with a fresh one.

Tolerance: exact (the reads move bytes; sums are of small integers in
float64, exact).
"""

import gc
import importlib

import numpy as np
import pytest
import torch

from dask_array_tpu_torch import config as tconfig

torch.set_num_threads(1)

ROOTS = {"port": "dask_array_tpu_torch", "jax": "dask_array_tpu"}


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


class RecordingStore:
    """A chunked store (zarr/h5py style): ``.chunks`` granules (and
    optionally ``.shards``), every read recorded."""

    def __init__(self, shape, chunks, shards=None, dtype="f8"):
        self.data = np.arange(np.prod(shape), dtype=dtype).reshape(shape)
        self.shape = shape
        self.dtype = self.data.dtype
        self.chunks = chunks
        self.ndim = len(shape)
        self.calls = []
        if shards:
            self.shards = shards

    def __getitem__(self, sl):
        self.calls.append(sl)
        return self.data[sl]


def _norm(sl):
    sl = sl if isinstance(sl, tuple) else (sl,)
    return tuple((s.start, s.stop, s.step) if isinstance(s, slice) else int(s) for s in sl)


def _leaf_chunks(expr, FromArray):
    return [n.chunks for n in expr.walk() if isinstance(n, FromArray)]


# program name -> (store args, function of (da, store) giving the lazy
# array, numpy's value of the store's data)
PROGRAMS = {
    "default-grid": (((100, 100), (10, 10)), lambda da, s: da.from_array(s), lambda x: x),
    "default-grid-large": (((512, 384), (64, 96)), lambda da, s: da.from_array(s, chunks="auto"), lambda x: x),
    "default-grid-shards": (((60, 40), (2, 2), (20, 20)), lambda da, s: da.from_array(s), lambda x: x),
    "slice-one-region": (((100, 100), (10, 10)), lambda da, s: da.from_array(s)[15:25, 35:45],
                         lambda x: x[15:25, 35:45]),
    "slice-then-slice": (((100, 100), (10, 10)), lambda da, s: da.from_array(s, chunks=(10, 10))[5:95][10:20, ::3],
                         lambda x: x[5:95][10:20, ::3]),
    "integer-index": (((40, 30), (10, 10)), lambda da, s: da.from_array(s, chunks=10)[7, 3:27], lambda x: x[7, 3:27]),
    "rechunk-on-granule-edges": (((20, 30), (10, 10)),
                                 lambda da, s: da.from_array(s, chunks=(10, 10)).rechunk((20, 10)), lambda x: x),
    "rechunk-off-granule-edges": (((10, 10), (10, 10)),
                                  lambda da, s: da.from_array(s, chunks=(10, 10)).rechunk((2, 2)), lambda x: x),
    "rechunk-refines-coarse-source": (((20, 30), (10, 10)),
                                      lambda da, s: da.from_array(s, chunks=(20, 30)).rechunk((2, 2)), lambda x: x),
    "rechunk-respects-shards": (((20, 20), (2, 2), (10, 10)),
                                lambda da, s: da.from_array(s, chunks=(20, 20)).rechunk((2, 2)), lambda x: x),
    "rechunk-offset-region": (((20, 30), (10, 10)),
                              lambda da, s: da.from_array(s, chunks=(10, 10))[3:17].rechunk((2, 10)), lambda x: x[3:17]),
    "elemwise-with-numpy": (((20, 20), (10, 10)),
                            lambda da, s: da.from_array(s, chunks=(10, 10)) + da.from_array(np.ones((20, 20)), chunks=(4, 4)),
                            lambda x: x + 1),
    "sum": (((30, 20), (10, 5)), lambda da, s: da.from_array(s).sum(axis=0), lambda x: x.sum(axis=0)),
}


def _run(which, name):
    da = importlib.import_module(ROOTS[which])
    FromArray = importlib.import_module(f"{ROOTS[which]}.ops._from_array").FromArray
    args, build, _ = PROGRAMS[name]
    gc.collect()  # an earlier case's expression in an uncollected cycle would hold an equal store
    store = RecordingStore(*args)
    arr = build(da, store)
    assert store.calls == []  # nothing is read while the program is built
    leafs = _leaf_chunks(arr.expr.simplify(), FromArray)
    value = np.asarray(arr.compute())
    assert store.calls, "the compute read nothing"
    return {"chunks": arr.chunks, "leafs": leafs, "calls": [_norm(c) for c in store.calls], "value": value,
            "data": store.data}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_a_recording_store_reads_what_the_jax_package_reads(name):
    port, jax = _run("port", name), _run("jax", name)
    assert port["chunks"] == jax["chunks"]
    assert port["leafs"] == jax["leafs"]
    assert port["calls"] == jax["calls"]
    np.testing.assert_array_equal(port["value"], jax["value"])
    np.testing.assert_array_equal(port["value"], PROGRAMS[name][2](port["data"]))


# case -> how the JAX package differs from the port and dask (each checked to differ)
KNOWN_REFERENCE_FAULTS = {
    "two-equal-live-stores": "the JAX package names a store by its pickle (utils/_tokenize.py:250) and interns "
                             "expressions by name (_expr.py:74-110): the second of two equal live stores gets "
                             "the first one's expression, and its compute reads the first store",
}


@pytest.mark.parametrize("name", sorted(KNOWN_REFERENCE_FAULTS))
def test_known_reference_faults_are_real(name):
    reads = {}
    for which in ROOTS:
        da = importlib.import_module(ROOTS[which])
        first, second = RecordingStore((100, 100), (10, 10)), RecordingStore((100, 100), (10, 10))
        a, b = da.from_array(first)[15:25, 35:45], da.from_array(second)[15:25, 35:45]
        np.testing.assert_array_equal(np.asarray(b.compute()), second.data[15:25, 35:45])
        after_second = (len(first.calls), len(second.calls))
        np.testing.assert_array_equal(np.asarray(a.compute()), first.data[15:25, 35:45])
        reads[which] = after_second, (len(first.calls), len(second.calls))
    assert reads["port"] == ((0, 1), (1, 1))  # the port reads each store it is given
    assert reads["jax"] == ((1, 0), (1, 0))  # the JAX package reads the first store only


def test_the_default_grid_keeps_to_granules():
    tda = importlib.import_module(ROOTS["port"])
    st = RecordingStore((100, 60), (10, 20))
    d = tda.from_array(st, chunks=(25, 25))  # an explicit grid wins
    assert d.chunks == ((25,) * 4, (25, 25, 10))
    d = tda.from_array(RecordingStore((4096, 64), (100, 64)), chunks="auto")
    assert all(c % 100 == 0 for c in d.chunks[0][:-1])


def test_a_slice_reads_one_region_only():
    tda = importlib.import_module(ROOTS["port"])
    st = RecordingStore((100, 100), (10, 10))
    y = tda.from_array(st)[15:25, 35:45]
    np.testing.assert_array_equal(y.compute(), st.data[15:25, 35:45])
    assert [_norm(c) for c in st.calls] == [((15, 25, 1), (35, 45, 1))]


def test_a_store_without_array_protocol_is_not_coerced():
    """Before the store was kept, ``np.asarray`` of such a store made an
    object array and raised ``dtype object has no torch counterpart``."""
    tda = importlib.import_module(ROOTS["port"])
    st = RecordingStore((6, 4), (3, 2), dtype="i4")
    d = tda.from_array(st)
    assert d.dtype == np.int32
    np.testing.assert_array_equal(d.compute(), st.data)


def test_the_full_signature():
    tda = importlib.import_module(ROOTS["port"])
    x = np.arange(12.0).reshape(3, 4)
    d = tda.from_array(x, chunks=2, name="named", lock=True, asarray=False, fancy=False, meta=np.empty((0, 0)),
                       inline_array=True)
    assert d.name == "named"
    np.testing.assert_array_equal(d.compute(), x)


def test_numpy_input_keeps_its_path(tmp_path):
    """A numpy array (a memmap too) is held as numpy, read whole or by
    region as before."""
    tda = importlib.import_module(ROOTS["port"])
    FromArray = importlib.import_module(f"{ROOTS['port']}.ops._from_array").FromArray
    x = np.arange(24.0).reshape(4, 6)
    d = tda.from_array(x, chunks=(2, 3))
    assert isinstance(d.expr, FromArray) and type(d.expr.source) is np.ndarray
    mm = np.lib.format.open_memmap(str(tmp_path / "m.npy"), mode="w+", dtype="f8", shape=(4, 6))
    mm[:] = x
    assert type(tda.from_array(mm).expr.source) is np.ndarray
    np.testing.assert_array_equal(d[1:3].compute(), x[1:3])
    np.testing.assert_array_equal(tda.from_array(mm, chunks=2)[1:3].compute(), x[1:3])


def test_h5py_datasets_read_what_the_jax_package_reads(tmp_path):
    h5py = pytest.importorskip("h5py")
    x = np.arange(120 * 90, dtype="f4").reshape(120, 90)
    fn = str(tmp_path / "d.h5")
    with h5py.File(fn, "w") as f:
        f.create_dataset("x", data=x, chunks=(12, 30))

    class Recorded:
        def __init__(self, dset):
            self.dset, self.calls = dset, []
            self.shape, self.dtype, self.chunks, self.ndim = dset.shape, dset.dtype, dset.chunks, dset.ndim

        def __getitem__(self, sl):
            self.calls.append(_norm(sl))
            return self.dset[sl]

    programs = [
        lambda da, s: da.from_array(s),
        lambda da, s: da.from_array(s)[13:50, 31:61],
        lambda da, s: da.from_array(s, chunks=(12, 30)).rechunk((24, 90)),
        lambda da, s: da.from_array(s, chunks=(12, 30)).rechunk((5, 7)),
    ]
    with h5py.File(fn, "r") as f:
        for build in programs:
            seen = {}
            for which in ROOTS:
                da = importlib.import_module(ROOTS[which])
                rec = Recorded(f["x"])
                arr = build(da, rec)
                seen[which] = (arr.chunks, np.asarray(arr.compute()), rec.calls)
            assert seen["port"][0] == seen["jax"][0]
            np.testing.assert_array_equal(seen["port"][1], seen["jax"][1])
            assert seen["port"][2] == seen["jax"][2]
        # the dataset itself (it has __array__): a slice reads its region
        tda = importlib.import_module(ROOTS["port"])
        np.testing.assert_array_equal(tda.from_array(f["x"])[100:, :10].compute(), x[100:, :10])
