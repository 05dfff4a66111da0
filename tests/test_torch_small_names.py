"""The port's small missing names, on the CPU, beside the JAX package.

``creation`` (the submodule alias), the ``chunk`` namespace (with
``arange``, ``linspace``, ``topk_aggregate`` and ``argtopk_aggregate``),
``barrier``, ``_test_utils.assert_eq``, the docstrings numpy lends to
undocumented public functions (``utils/_derived.py``), and the public
names: the JAX package's 323 non-module names less the one the port
still misses (``register_chunk_type``, S9).

Tolerance: exact (integer and float64 values from the same numpy
functions; linspace's float64 grid to 1 ulp).
"""

import importlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu import chunk as jchunk
from dask_array_tpu_torch import chunk as tchunk
from dask_array_tpu_torch import config as tconfig

torch.set_num_threads(1)

STILL_MISSING = []


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


def test_the_public_names_less_nine():
    """Counted as the JAX package is: non-module names of ``dir()``, each
    package imported in a fresh process.  Nine were missing before the
    diagnostics were ported; ``STILL_MISSING`` holds what is left."""
    code = ("import json, sys, types; m = __import__(sys.argv[1]); print(json.dumps(sorted("
            "n for n in dir(m) if not n.startswith('_') and not isinstance(getattr(m, n), types.ModuleType))))")
    import json

    names = {}
    for root in ("dask_array_tpu", "dask_array_tpu_torch"):
        out = subprocess.run([sys.executable, "-c", code, root], capture_output=True, text=True, check=True,
                             env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
        names[root] = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert len(names["dask_array_tpu"]) == 323
    assert sorted(names["dask_array_tpu"] - names["dask_array_tpu_torch"]) == STILL_MISSING


@pytest.mark.parametrize("name", ["io", "xarray", "chunk", "creation", "fft", "linalg", "random"])
def test_submodules_are_bound(name):
    assert isinstance(getattr(tda, name), types.ModuleType)
    assert getattr(tda, name) is importlib.import_module(f"dask_array_tpu_torch.{name}")


@pytest.mark.parametrize("name", ["store", "to_zarr", "to_hdf5", "to_tiledb", "to_delayed"])
def test_array_io_methods(name):
    assert callable(getattr(tda.ones(3), name))
    assert callable(getattr(jda.ones(3), name))


def test_star_import_binds_no_submodules():
    ns = {}
    exec("from dask_array_tpu_torch import *", ns)
    assert "io" not in ns and "xarray" not in ns and "store" in ns and "from_zarr" in ns


def test_creation_alias_matches_the_jax_package():
    tcreation = importlib.import_module("dask_array_tpu_torch.creation")
    jcreation = importlib.import_module("dask_array_tpu.creation")
    public = {n for n in dir(jcreation) if not n.startswith("_") and callable(getattr(jcreation, n))
              and getattr(getattr(jcreation, n), "__module__", "").startswith("dask_array_tpu.ops.creation")}
    assert public and all(hasattr(tcreation, n) for n in public), sorted(n for n in public if not hasattr(tcreation, n))
    for name, args, kw in [("arange", (3, 20, 4), {"chunks": 2}), ("linspace", (0, 1, 11), {"chunks": 4}),
                           ("eye", (5,), {"chunks": 2}), ("tri", (4, 6), {"k": 1, "chunks": 3}),
                           ("full", ((3, 4), 7.5), {"chunks": 2}), ("ones", ((2, 3),), {"dtype": "i4"})]:
        got = np.asarray(getattr(tcreation, name)(*args, **kw).compute())
        want = np.asarray(getattr(jcreation, name)(*args, **kw).compute())
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


CHUNK_NAMES = ["arange", "argtopk", "argtopk_aggregate", "astype", "coarsen", "concat", "flatten", "getitem",
               "keepdims_wrapper", "linspace", "topk", "topk_aggregate", "trim"]


def test_chunk_names():
    for name in CHUNK_NAMES:
        assert callable(getattr(tchunk, name)) and callable(getattr(jchunk, name)), name
    assert tda.chunk is tchunk


@pytest.mark.parametrize("args", [(0, 10, 1, 10, "i8"), (2.5, 9.5, 0.5, 14, "f8"), (-3, 3, 2, 3, "f4")])
def test_chunk_arange(args):
    got = tchunk.arange(*args)
    want = np.asarray(jchunk.arange(*args))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.arange(args[0], args[1], args[2], dtype=args[4])[: args[3]])


@pytest.mark.parametrize("args", [(0.0, 1.0, 11, True, "f8"), (-2, 5, 7, False, None), (1, 2, 1, True, "f4")])
def test_chunk_linspace(args):
    got = tchunk.linspace(*args).numpy()
    want = np.linspace(args[0], args[1], args[2], endpoint=args[3], dtype=args[4])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # the JAX package's grid to an ulp of its range (its 0 of -2..5 is -2.2e-16)
    np.testing.assert_allclose(np.asarray(jchunk.linspace(*args)), want, rtol=2**-52, atol=2**-52 * 8)


@pytest.mark.parametrize("k", [3, -2])
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_chunk_topk_and_its_aggregates(k, kind):
    rng = np.random.default_rng(5)
    a = rng.permutation(40).reshape(5, 8).astype("f8")
    x = a if kind == "numpy" else torch.from_numpy(a)
    got = tchunk.topk(x, k, 1)
    want = np.asarray(jchunk.topk(a, k, 1))
    np.testing.assert_array_equal(np.asarray(got), want)
    np.testing.assert_array_equal(np.asarray(tchunk.topk_aggregate(x, k, 1)), want)
    idx = tchunk.argtopk(x, k, 1)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(jchunk.argtopk(a, k, 1)))
    # argtopk_aggregate: (values, their global indices) -> the indices of the top k
    glob = np.arange(40).reshape(5, 8) + 100
    pair = (x, glob if kind == "numpy" else torch.from_numpy(glob))
    got = np.asarray(tchunk.argtopk_aggregate(pair, k, 1))
    np.testing.assert_array_equal(got, np.asarray(jchunk.argtopk_aggregate((a, glob), k, 1)))


def test_chunk_misc_match_the_jax_package():
    a = np.arange(24.0).reshape(4, 6)
    t = torch.from_numpy(a)
    np.testing.assert_array_equal(np.asarray(tchunk.trim(t, 1)), np.asarray(jchunk.trim(a, 1)))
    np.testing.assert_array_equal(np.asarray(tchunk.concat([[t[:2]], [t[2:]]])), a)
    np.testing.assert_array_equal(np.asarray(tchunk.coarsen(np.sum, a, {0: 2, 1: 3})),
                                  np.asarray(jchunk.coarsen(np.sum, a, {0: 2, 1: 3})))
    assert tchunk.astype(t, "i4").dtype == torch.int32 and tchunk.astype(a, "i4").dtype == np.int32
    assert list(tchunk.flatten([[1, [2]], [3]])) == [1, 2, 3]
    assert tchunk.getitem(a, (1, 2)) == a[1, 2]
    kmax = tchunk.keepdims_wrapper(np.max)
    assert kmax(a, axis=1, keepdims=True).shape == jchunk.keepdims_wrapper(np.max)(a, axis=1, keepdims=True).shape


# ---------------------------------------------------------------------------
# barrier
# ---------------------------------------------------------------------------


def test_barrier_values_match_the_jax_package():
    x = np.random.default_rng(3).standard_normal((12, 10))
    t = tda.barrier(tda.from_array(x, chunks=(4, 5)) * 2 + 1)
    j = jda.barrier(jda.from_array(x, chunks=(4, 5)) * 2 + 1)
    assert t.chunks == j.chunks == ((4, 4, 4), (5, 5))
    np.testing.assert_array_equal(np.asarray(t.compute()), x * 2 + 1)
    np.testing.assert_allclose(np.asarray((t.sum(0) - 1).compute()), np.asarray((j.sum(0) - 1).compute()),
                               rtol=1e-12)


def test_the_optimizer_keeps_a_slice_above_the_barrier():
    from dask_array_tpu_torch._materialize import Barrier
    from dask_array_tpu_torch._slicing import Slice
    from dask_array_tpu_torch.ops._from_array import FromArray

    x = np.arange(120.0).reshape(12, 10)
    inner = tda.from_array(x, chunks=(4, 5)) + 1
    y = tda.barrier(inner)[2:5, 3:9]
    opt = y.expr.optimize()
    assert isinstance(opt, Slice) and isinstance(opt.array, Barrier)
    # below the barrier the leaf keeps its whole extent: no slice was pushed
    leafs = [n for n in opt.array.array.walk() if isinstance(n, FromArray)]
    assert leafs and all(n.region is None and n.chunks == ((4, 4, 4), (5, 5)) for n in leafs)
    np.testing.assert_array_equal(y.compute(), x[2:5, 3:9] + 1)
    # nor a rechunk
    r = tda.barrier(inner).rechunk((6, 10)).expr.optimize()
    assert any(isinstance(n, Barrier) and n.chunks == ((4, 4, 4), (5, 5)) for n in r.walk())


def test_barrier_computes_its_subtree_in_a_walk_of_its_own():
    from dask_array_tpu_torch import _executor

    x = np.arange(6.0)
    b = tda.barrier(tda.from_array(x, chunks=3) * 3)
    leaves = _executor.collect_leaves((b + 1).expr.optimize())
    assert [k for k, _ in leaves] == [b.expr._leaf_key]  # the subtree's leaf is not collected
    assert isinstance(leaves[0][1], torch.Tensor)
    np.testing.assert_array_equal((b + 1).compute(), x * 3 + 1)


# ---------------------------------------------------------------------------
# assert_eq and the derived docstrings
# ---------------------------------------------------------------------------


def test_assert_eq():
    from dask_array_tpu_torch._test_utils import assert_eq

    x = np.arange(12.0).reshape(3, 4)
    assert assert_eq(tda.from_array(x, chunks=2) + 1, x + 1)
    with pytest.raises(AssertionError):
        assert_eq(tda.from_array(x, chunks=2), x + 1)
    with pytest.raises(AssertionError, match="dtype"):
        assert_eq(tda.from_array(x, chunks=2), x.astype("f4"))
    with pytest.raises(AssertionError, match="shape"):
        assert_eq(tda.from_array(x, chunks=2), x[:2])
    assert assert_eq(tda.from_array(x.astype("i4"), chunks=2), x.astype("i4"))


def test_derived_docstrings():
    assert "numpy.argwhere" in tda.argwhere.__doc__ and "non-zero" in tda.argwhere.__doc__
    assert "numpy.linalg.cholesky" in tda.cholesky.__doc__
    assert "numpy.fft.fftshift" in tda.fft.fftshift.__doc__
    assert "dask_array_tpu_torch" in tda.sum.__doc__
    # a written docstring is kept
    assert tda.from_array.__doc__.startswith("Create a lazy Array from a numpy array or an array-like store.")
    import inspect

    undocumented = [n for n in tda.__all__ if callable(getattr(tda, n)) and not inspect.isclass(getattr(tda, n))
                    and not inspect.getdoc(getattr(tda, n))]
    assert undocumented == [], undocumented


def test_derive_docstrings_never_overwrites():
    from dask_array_tpu_torch.utils._derived import derive_docstrings

    def sum():  # noqa: A001 - shadows numpy's name on purpose
        """Mine."""

    def mean():
        pass

    def not_in_numpy():
        pass

    ns = {"sum": sum, "mean": mean, "not_in_numpy": not_in_numpy}
    left = derive_docstrings(ns, list(ns), [("", np)])
    assert sum.__doc__ == "Mine."
    assert "numpy.mean" in mean.__doc__
    assert left == ["not_in_numpy"]
