"""The first half of the routines through the port on the CPU: ``where``,
``round``, ``isclose``/``allclose``, ``select``, ``piecewise``,
``choose``, ``tril``/``triu``, ``count_nonzero``, ``ptp``, ``average``,
``diff``, ``ediff1d``, ``nonzero``/``flatnonzero``/``argwhere``,
``compress``, ``extract``, the ``tril_indices`` family,
``broadcast_arrays``, ``unify_chunks``, ``insert``/``delete``/``append``
and numpy's dispatch (``np.where(X, ...)``) to them.

Each program runs on arrays of several chunks made from a numpy seed,
through the port, the JAX package and numpy.  Tolerance: exact for integer,
bool and layout results and for ``round``/``where``/``select``/``tril``
(they move or round values); floats otherwise to rtol 1e-6 (float32) or
1e-12 (float64) for the reductions (``average``, summed in another order).
Data-dependent results (``nonzero``, masks) go through
``compute_chunk_sizes`` too.  Where the JAX package differs from numpy
(``KNOWN_REFERENCE_FAULTS``) the port pins numpy.
"""

import warnings

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch._blockwise import FusedBlockwise

torch.set_num_threads(1)

CHUNKS = (4, 5)


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


def base(dtype="float64", seed=0, shape=(9, 11)):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape) * 10
    if np.dtype(dtype).kind == "f":
        a.ravel()[:4] = [np.nan, np.inf, -0.0, 2.5]
    return a.astype(dtype) if np.dtype(dtype).kind != "b" else a > 0


def quiet(fn, *args, **kwargs):
    with warnings.catch_warnings(), np.errstate(all="ignore"):
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


def same(got, want, rtol=0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    if rtol:
        np.testing.assert_allclose(got, want, rtol=rtol, equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want)


def value(out):
    if isinstance(out, (tuple, list)):
        return type(out)(value(o) for o in out)
    return out.compute() if hasattr(out, "compute") else out


def run(prog, mod, a):
    x = a if mod is np else mod.from_array(a, chunks=CHUNKS)
    return value(quiet(prog, x, mod))


def lazy(mod, a, chunks=3):
    return np.asarray(a) if mod is np else mod.from_array(np.asarray(a), chunks=chunks)


# name -> (program of (x, module), dtypes, rtol)
PROGRAMS = {
    "where": (lambda x, m: m.where(x > 0, x, 0), ["float32", "int8", "uint64", "complex64"], 0),
    "where_scalars": (lambda x, m: m.where(x > 0, 1.5, -2), ["float32", "int16"], 0),
    "where_out_of_range_int": (lambda x, m: m.where(x > 0, x, 300), ["int8"], 0),
    "where_numpy_scalar": (lambda x, m: m.where(x > 0, x, np.int64(300)), ["int8"], 0),
    "where_scalar_condition": (lambda x, m: m.where(True, x, 0.5), ["int16", "float32"], 0),
    "round0": (lambda x, m: m.round(x), ["float16", "float32", "complex128", "int32", "bool"], 0),
    "round2": (lambda x, m: m.round(x, 2), ["float16", "float32", "float64", "complex64"], 0),
    "round_negative": (lambda x, m: m.round(x, -1), ["int8", "int64", "uint16", "float64"], 0),
    "around_method": (lambda x, m: x.round(1), ["float32"], 0),
    "isclose": (lambda x, m: m.isclose(x, x + 1e-7 * x), ["float32", "float64", "complex128"], 0),
    "isclose_mixed": (lambda x, m: m.isclose(x, 3), ["int8", "float16"], 0),
    "isclose_equal_nan": (lambda x, m: m.isclose(x, x, equal_nan=True), ["float64"], 0),
    "allclose": (lambda x, m: m.allclose(x, x * (1 + 1e-9)), ["float64"], 0),
    "select": (lambda x, m: m.select([x > 5, x < -5], [x, -x], 7), ["float32", "int32"], 0),
    "choose": (lambda x, m: m.choose(lazy(m, np.arange(11) % 3), [x[0], x[1] * 2, 100]), ["int64", "float32"], 0),
    "tril": (lambda x, m: m.tril(x), ["float32", "bool", "uint32"], 0),
    "triu_k": (lambda x, m: m.triu(x, 2), ["float64", "int8"], 0),
    "tril_negative_k": (lambda x, m: m.tril(x, -3), ["float32"], 0),
    "count_nonzero": (lambda x, m: m.count_nonzero(x), ["float32", "int8", "bool"], 0),
    "count_nonzero_axis": (lambda x, m: m.count_nonzero(x, axis=0), ["float32", "complex64"], 0),
    "ptp": (lambda x, m: m.ptp(x, axis=1), ["int16", "float64"], 0),
    "average": (lambda x, m: m.average(x), ["float64"], 1e-12),
    "average_weights": (lambda x, m: m.average(x, axis=1, weights=np.arange(11.0)), ["float32", "float64"], 1e-6),
    "average_returned": (lambda x, m: m.average(x, axis=0, returned=True), ["float64"], 1e-12),
    "diff": (lambda x, m: m.diff(x), ["float32", "int8", "uint8", "bool"], 0),
    "diff_axis0_n2": (lambda x, m: m.diff(x, n=2, axis=0), ["float64", "int32"], 0),
    "diff_prepend_append": (lambda x, m: m.diff(x, prepend=0, append=x[:, :1]), ["float32"], 0),
    "ediff1d": (lambda x, m: m.ediff1d(x, to_begin=[7], to_end=8), ["float64", "int16"], 0),
    "nonzero": (lambda x, m: m.nonzero(x > 3), ["float32", "int8"], 0),
    "nonzero_method": (lambda x, m: (x > 3).nonzero(), ["float64"], 0),
    "flatnonzero": (lambda x, m: m.flatnonzero(x), ["int16", "bool"], 0),
    "argwhere": (lambda x, m: m.argwhere(x > 2), ["float32"], 0),
    "where_one_argument": (lambda x, m: m.where(x < -4), ["float64"], 0),
    "compress": (lambda x, m: m.compress([True, False, True, True], x, axis=0), ["float32", "uint64"], 0),
    "compress_flat": (lambda x, m: m.compress(np.arange(20) % 3 == 0, x), ["int8"], 0),
    "extract": (lambda x, m: m.extract(x > 0, x), ["float64", "int32"], 0),
    "insert_scalar": (lambda x, m: m.insert(x, 2, 5, axis=1), ["float32", "int8"], 0),
    "insert_many": (lambda x, m: m.insert(x, [1, 1, 4], 0, axis=0), ["float64"], 0),
    "insert_flat": (lambda x, m: m.insert(x, 3, [1, 2]), ["int16"], 0),
    "delete": (lambda x, m: m.delete(x, [0, -1], axis=1), ["float32", "uint16"], 0),
    "delete_slice": (lambda x, m: m.delete(x, slice(1, 6, 2), axis=0), ["float64"], 0),
    "append": (lambda x, m: m.append(x, x[:2], axis=0), ["float32"], 0),
    "append_flat": (lambda x, m: m.append(x, [1, 2]), ["int8"], 0),
    "broadcast_arrays": (lambda x, m: m.broadcast_arrays(x[:, :1], x[:1]), ["float32"], 0),
}

CASES = [(name, dt) for name, (_, dts, _) in sorted(PROGRAMS.items()) for dt in dts]

# the JAX package's results that differ from numpy's, the port pinning
# numpy: jnp.round's own rounding of x * 10**d (float16/32, complex64) and
# its refusal of bool and of integers at d < 0; insert and ediff1d promote
# the inserted values instead of casting them; diff of bool subtracts
KNOWN_REFERENCE_FAULTS = {
    ("around_method", "float32"), ("round2", "float16"), ("round2", "float32"), ("round2", "complex64"),
    ("round0", "bool"), ("round_negative", "int8"), ("round_negative", "int64"), ("round_negative", "uint16"),
    ("insert_scalar", "float32"), ("insert_scalar", "int8"), ("insert_flat", "int16"), ("ediff1d", "int16"),
    ("diff", "bool"),
    # its plans of where(m, x, 300) and where(m, x, np.int64(300)) share one
    # token: whichever runs first serves both
    ("where_out_of_range_int", "int8"), ("where_numpy_scalar", "int8"),
}


@pytest.mark.parametrize("name, dtype", CASES)
def test_routine(name, dtype):
    prog, _, rtol = PROGRAMS[name]
    a = base(dtype)
    want = run(prog, np, a)
    got = run(prog, tda, a)
    for g, w in zip(got, want) if isinstance(want, (tuple, list)) else [(got, want)]:
        same(g, w, rtol)
    if (name, dtype) in KNOWN_REFERENCE_FAULTS:
        return
    ref = run(prog, jda, a)
    for r, w in zip(ref, want) if isinstance(want, (tuple, list)) else [(ref, want)]:
        same(r, w, rtol or 1e-12 if np.asarray(w).dtype.kind in "fc" else 0)


def test_numpy_dispatch_reaches_the_port():
    a = base("float32")
    x = tda.from_array(a, chunks=CHUNKS)
    for fn, args in ((np.where, (x > 0, x, 0)), (np.round, (x, 1)), (np.isclose, (x, x)), (np.diff, (x,)),
                     (np.tril, (x,)), (np.take, (x, [1, 2])), (np.clip, (x, 0, 1)), (np.count_nonzero, (x,))):
        out = fn(*args)
        assert isinstance(out, tda.Array), fn
        np_args = [a if arg is x else (a > 0 if arg is args[0] and fn is np.where else arg) for arg in args]
        same(value(out), quiet(fn, *np_args))
    nz = np.nonzero(x > 0)
    same(value(nz[0]), np.nonzero(a > 0)[0])
    with pytest.raises(TypeError):
        np.unique(x)  # not ported: no numpy fallback on the host


def test_tril_and_triu_hold_after_fusion_on_several_chunks():
    a = base("float32")
    x = tda.from_array(a, chunks=(2, 3))
    cases = [(tda.tril(x[1:, :]), np.tril(a[1:, :])), (tda.triu(x + 1, 1), np.triu(a + 1, 1)),
             (tda.tril(x * 2, -1) + 1, np.tril(a * 2, -1) + 1)]
    for lazy_out, want in cases:
        plan = lazy_out.optimize()
        assert any(isinstance(n, FusedBlockwise) for n in plan.expr.walk())
        same(plan.compute(), want)
        same(lazy_out.compute(), want)


def test_nonzero_on_unknown_chunks_through_compute_chunk_sizes():
    a = base("float64")
    x = tda.from_array(a, chunks=CHUNKS)
    m = x[x > 0]  # unknown chunks
    idx = tda.nonzero(m > 5)[0]
    want = np.nonzero(a[a > 0] > 5)[0]
    same(idx.compute(), want)
    idx.compute_chunk_sizes()
    assert sum(idx.chunks[0]) == want.size
    same(idx.compute(), want)
    r, c = tda.nonzero(x > 2)
    r.compute_chunk_sizes()
    assert len(r.chunks[0]) == len(x.chunks[0])  # one block per block along axis 0
    same(r.compute(), np.nonzero(a > 2)[0])
    same(tda.argwhere(x > 2).compute(), np.argwhere(a > 2))


def test_compress_and_extract_with_lazy_conditions():
    a = base("float32")
    x = tda.from_array(a, chunks=CHUNKS)
    cond = np.arange(9) % 2 == 0
    same(tda.compress(tda.from_array(cond, chunks=4), x, axis=0).compute(), np.compress(cond, a, axis=0))
    same(tda.compress(tda.from_array(cond[:5], chunks=4), x, axis=0).compute(), np.compress(cond[:5], a, axis=0))
    same(tda.extract(x > 0, x).compute(), np.extract(a > 0, a))


def test_choose_refuses_an_index_out_of_range():
    x = tda.from_array(np.array([0, 1, 3]), chunks=2)
    with pytest.raises(ValueError, match="invalid entry"):
        tda.choose(x, [np.arange(3), np.arange(3)]).compute()


def test_piecewise():
    a = base("float64")
    x = tda.from_array(a, chunks=CHUNKS)
    funcs = [lambda v: -v, lambda v: v * 2, 0.5]
    same(tda.piecewise(x, [x < 0, x > 1], funcs).compute(), quiet(np.piecewise, a, [a < 0, a > 1], funcs))
    same(tda.piecewise(x, [x < 0], [1.0]).compute(), quiet(np.piecewise, a, [a < 0], [1.0]))


@pytest.mark.parametrize("fn", ["tril_indices", "triu_indices"])
@pytest.mark.parametrize("k", [-1, 0, 2])
def test_index_builders(fn, k):
    for g, w, r in zip(getattr(tda, fn)(6, k, 8), getattr(np, fn)(6, k, 8), getattr(jda, fn)(6, k, 8)):
        same(g.compute(), w)
        same(r.compute(), w)
    a = base("float32", shape=(5, 7))
    for g, w in zip(getattr(tda, fn + "_from")(tda.from_array(a), k), getattr(np, fn + "_from")(a, k)):
        same(g.compute(), w)


def test_unify_chunks_and_the_small_helpers():
    a = tda.from_array(np.ones((6, 8)), chunks=(2, 4))
    b = tda.from_array(np.ones((8, 3)), chunks=(3, 3))
    chunks, (a2, b2) = tda.unify_chunks(a, "ij", b, "jk")
    ref_chunks, _ = jda.unify_chunks(jda.from_array(np.ones((6, 8)), chunks=(2, 4)), "ij",
                                     jda.from_array(np.ones((8, 3)), chunks=(3, 3)), "jk")
    assert chunks == ref_chunks and a2.chunks[1] == b2.chunks[0] == chunks["j"]
    x = tda.from_array(base("complex64"), chunks=CHUNKS)
    assert tda.iscomplexobj(x) and not tda.iscomplexobj(np.ones(3))
    assert tda.result_type(x, np.float64) == np.result_type(np.complex64, np.float64)
    assert tda.ndim(x) == 2 and tda.shape(x) == (9, 11) and tda.shape([1, 2]) == (2,)
    f = tda.from_array(base("float32"), chunks=CHUNKS)
    same(tda.isnull(f).compute(), np.isnan(base("float32")))
    same(tda.notnull(tda.from_array(np.arange(4))).compute(), np.ones(4, bool))
    assert tda.from_array(np.array([3.5])).item() == 3.5
    assert tda.from_array(np.arange(3)).tolist() == [0, 1, 2]
    same(tda.from_array(np.arange(3), chunks=2).repeat(2).compute(), np.arange(3).repeat(2))
    same(tda.from_array(np.array([0, 2, 1])).choose([np.arange(3) * 10, 7, np.ones(3, int)]).compute(),
         np.choose([0, 2, 1], [np.arange(3) * 10, 7, np.ones(3, int)]))
