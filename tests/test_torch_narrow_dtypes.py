"""ml_dtypes' narrow types through the port on the CPU: ``int2``, ``uint2``,
``int4``, ``uint4``, ``float4_e2m1fn``, ``float8_e3m4``, ``float8_e4m3``,
``float8_e4m3b11fnuz`` and ``float8_e8m0fnu``.

A block holds each one's bit patterns in a uint8 carrier
(``dask_array_tpu_torch/_narrow.py``).  First the codec: the decode table
and the encode against ml_dtypes' own ``astype`` for every pattern and a
wide sample of float32, float64 and int64 values.  Then each op through
``from_array`` -> op -> ``compute()`` in the port, the JAX package and
numpy with ml_dtypes, on the same seeded input:

- The port equals numpy with ml_dtypes bit for bit (dtype too), and
  refuses the casts numpy refuses, except in ``NUMPY_ACCUMULATES``: numpy
  sums a narrow float in its own type, rounding at each step, where the
  port (as the JAX package) accumulates in float32 and rounds once; there
  the port equals numpy's float64 sum of the values rounded once to the
  type, bit for bit.  No float tolerance is used anywhere.
- The port equals the JAX package bit for bit, except in
  ``KNOWN_REFERENCE_FAULTS`` (checked to differ:
  ``test_known_reference_faults_are_real``) and in ``JAX_ABORTS``, the
  cases whose XLA compile aborts the process (never run).

Then three more groups: the 1-byte float scans (the narrow floats and
torch's float8 types) against numpy; torch's float8 contractions against
numpy and the JAX package; and under a mesh of 8 CPU slots, both lanes
and a narrow leaf held sharded against the walk without a mesh.

Every comparison of a narrow result is of its bytes (but a scan's NaN
sign, stated there); a float result of a regular dtype is compared with
NaN equal to NaN.
"""

from __future__ import annotations

import ml_dtypes
import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu_torch import _narrow
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch._chunks import torch_dtype
from dask_array_tpu_torch._collection import Persisted, new_collection
from dask_array_tpu_torch.parallel import Mesh, use_mesh
from dask_array_tpu_torch.parallel._sharded import ShardedTensor
from dask_array_tpu_torch.parallel.partition import PARTITIONED
from dask_array_tpu_torch.parallel.shardlane import ENGAGED

torch.set_num_threads(1)

NARROW = ["int2", "uint2", "int4", "uint4", "float4_e2m1fn", "float8_e3m4", "float8_e4m3", "float8_e4m3b11fnuz",
          "float8_e8m0fnu"]
INTS = {"int2", "uint2", "int4", "uint4"}
# torch's own float8 types: computed in float32 and encoded by their formats
TORCH_FLOAT8 = ["float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz", "float8_e5m2fnuz"]
FORMATS = {**_narrow.FORMATS, **_narrow.HELD}
BF16 = np.dtype(ml_dtypes.bfloat16)


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


def dt_of(name):
    return np.dtype(getattr(ml_dtypes, name))


def sample(name, shape=(6, 8), seed=0):
    """Seeded values over the type's range: every integer value; floats of
    both signs around 1 with a zero, and powers of two for e8m0 (no zero,
    no sign)."""
    rng = np.random.default_rng(seed)
    dt = dt_of(name)
    if name in INTS:
        info = ml_dtypes.iinfo(dt)
        return rng.integers(info.min, info.max + 1, shape).astype(dt)
    if name == "float8_e8m0fnu":
        return (2.0 ** rng.integers(-6, 7, shape)).astype(np.float32).astype(dt)
    a = (rng.standard_normal(shape) * 2).astype(np.float32)
    a.flat[1] = 0.0
    return a.astype(dt)


def same(got, want):
    """Equal dtype, shape and bytes (a regular float's NaN equal to NaN)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape, want.dtype, want.shape)
    if got.dtype.kind == "V":  # ml_dtypes' types: their bytes
        return np.array_equal(got.view(np.uint8), want.view(np.uint8))
    return np.array_equal(got, want, equal_nan=got.dtype.kind in "fc")


# -- the codec ------------------------------------------------------------------------


@pytest.mark.parametrize("name", NARROW + TORCH_FLOAT8)
def test_decode_table_is_ml_dtypes(name):
    """The 256-entry table built from the format's parameters is what
    ml_dtypes reads each byte as, bit for bit (NaN's sign too)."""
    fmt = FORMATS[name]
    patterns = np.arange(256, dtype=np.uint8)
    want = patterns.view(dt_of(name)).astype(np.float32 if fmt.is_float else np.int32)
    got = _narrow.decode(torch.from_numpy(patterns), fmt).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _encode_inputs(name, rng):
    tab = _narrow.decode_table(name).astype(np.float64)
    bits = rng.integers(0, 2**32, 400_000, dtype=np.uint64).astype(np.uint32).view(np.float32)
    if name in INTS:
        return np.concatenate([bits, (rng.standard_normal(20000) * 20).astype(np.float32),
                               np.arange(-40, 40, 0.25, dtype=np.float32)])
    fin = np.unique(tab[np.isfinite(tab)])
    mids = ((fin[:-1] + fin[1:]) / 2).astype(np.float32)
    near = np.concatenate([mids, np.nextafter(mids, np.float32(np.inf)), np.nextafter(mids, np.float32(-np.inf))])
    spread = (rng.standard_normal(50000) * fin.max()).astype(np.float32)
    special = np.array([0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-45, -1e-45, 2.0**-126, 2.0**-127],
                       np.float32)
    return np.concatenate([bits, near, -near, tab.astype(np.float32), spread, special])


@pytest.mark.parametrize("name", NARROW + TORCH_FLOAT8)
def test_encode_is_ml_dtypes(name):
    """Encoding float32, float64 and int64 values gives ml_dtypes'
    ``astype`` patterns: round to nearest (ties by the format's rule),
    overflow, NaN, zero and sign rules, integer wrap."""
    fmt = FORMATS[name]
    rng = np.random.default_rng(7)
    dt = dt_of(name)
    x32 = _encode_inputs(name, rng)
    x64 = rng.standard_normal(20000) * (20 if name in INTS else float(np.nanmax(np.abs(_narrow.decode_table(name)))))
    ints = rng.integers(-(2**62), 2**62, 20000)
    ints[:200] = np.arange(-100, 100)
    with np.errstate(all="ignore"):
        for x in (x32, x64, ints):
            want = x.astype(dt).view(np.uint8)
            got = _narrow.encode(torch.from_numpy(x), fmt).numpy()
            bad = np.flatnonzero(got != want)
            assert bad.size == 0, (x.dtype, x[bad[:4]], got[bad[:4]], want[bad[:4]])


@pytest.mark.parametrize("name", NARROW)
def test_every_pattern_round_trips(name):
    """All 256 bytes through ``from_array`` -> ``compute()``, the executor's
    ``tensor_of``/``array_of`` and a persisted leaf: the same bytes."""
    from dask_array_tpu_torch._chunks import array_of, tensor_of

    dt = dt_of(name)
    src = np.arange(256, dtype=np.uint8).view(dt).reshape(16, 16)
    t = tensor_of(src)
    assert t.dtype == torch.uint8 and np.array_equal(array_of(t, dt).view(np.uint8), src.view(np.uint8))
    x = tda.from_array(src, chunks=(5, 7))
    out = x.compute()
    assert out.dtype == dt and np.array_equal(out.view(np.uint8), src.view(np.uint8))
    held = x.persist().compute()
    assert held.dtype == dt and np.array_equal(held.view(np.uint8), src.view(np.uint8))
    assert x.compute_device().dtype == torch.uint8


@pytest.mark.parametrize("name", NARROW)
def test_chunk_helpers_take_the_narrow_types(name):
    """``_chunks``' dtype helpers: the carrier, the compute dtype, the key,
    floatness; the codec's ``compute_dtype`` agrees."""
    from dask_array_tpu_torch import _chunks

    dt = dt_of(name)
    fmt = _narrow.FORMATS[name]
    assert _chunks.torch_dtype(dt) == torch.uint8
    assert _chunks.compute_dtype(dt) == _narrow.compute_dtype(fmt) == (torch.int32 if name in INTS else torch.float32)
    assert _chunks.is_ml_dtype(dt) and not _chunks.host_only_dtype(dt)
    assert _chunks.is_float_dtype(dt) == (name not in INTS)
    assert np.dtype(_chunks.dtype_key(dt)) == dt
    assert _narrow.format_of(dt) is fmt and _narrow.format_of(np.uint8) is None


@pytest.mark.parametrize("name", ["float6_e2m3fn", "float6_e3m2fn"])
def test_float6_types_stay_refused(name):
    """The float6 types have no route (the JAX package cannot compute them
    either)."""
    with pytest.raises(TypeError, match=f"ml_dtypes.{name}"):
        tda.from_array(np.zeros(4, dtype=getattr(ml_dtypes, name)), chunks=2)


# -- ops through the three --------------------------------------------------------------


def _where(m, v):
    return m.where(v.astype(np.float32) > 0, v, v[::-1])


OPS = {
    # elementwise: each op rounds to its result dtype, as numpy's loops do
    "add": lambda m, v: v + v,
    "add_int": lambda m, v: v + 1,
    "chain": lambda m, v: v * 2 + 1,
    "sub_flip": lambda m, v: v - v[::-1],
    "mul": lambda m, v: v * v,
    "negative": lambda m, v: -v,
    "absolute": lambda m, v: abs(v),
    "true_divide": lambda m, v: v / 3,
    "greater": lambda m, v: v > 0,
    "equal": lambda m, v: v == v[::-1],
    "maximum": lambda m, v: m.maximum(v, v[::-1]),
    "where": _where,
    "where_scalar": lambda m, v: m.where(v.astype(np.float32) > 0, v, 1),
    # reductions
    "sum": lambda m, v: v.sum(),
    "sum_axis0": lambda m, v: v.sum(axis=0),
    "mean": lambda m, v: v.mean(),
    "prod_axis1": lambda m, v: v[:, :3].prod(axis=1),
    "max": lambda m, v: v.max(),
    "min_axis0": lambda m, v: v.min(axis=0),
    "argmax_axis0": lambda m, v: v.argmax(axis=0),
    "argmin": lambda m, v: v.argmin(),
    "cumsum_axis0": lambda m, v: v.cumsum(axis=0),
    "cumprod_axis1": lambda m, v: v[:, :3].cumprod(axis=1),
    # contractions
    "matmul": lambda m, v: v @ v.T,
    "tensordot": lambda m, v: m.tensordot(v, v.T, axes=1),
    "dot": lambda m, v: m.dot(v, v.T),
    # casts
    "astype_float32": lambda m, v: v.astype(np.float32),
    "astype_float64": lambda m, v: v.astype(np.float64),
    "astype_int8": lambda m, v: v.astype(np.int8),
    "astype_uint8": lambda m, v: v.astype(np.uint8),
    "astype_bool": lambda m, v: v.astype(bool),
    "astype_float16": lambda m, v: v.astype(np.float16),
    "astype_bfloat16": lambda m, v: v.astype(BF16),
    "astype_float8_e4m3fn": lambda m, v: v.astype(ml_dtypes.float8_e4m3fn),
    "astype_int4": lambda m, v: v.astype(ml_dtypes.int4),
    "astype_float8_e4m3": lambda m, v: v.astype(ml_dtypes.float8_e4m3),
    "from_float64": lambda m, v: (v.astype(np.float64) * 1.7).astype(v.dtype),
    "from_int64": lambda m, v: (v.astype(np.int64) * 3 - 5).astype(v.dtype),
    # layout: the patterns move as they are
    "transpose": lambda m, v: v.T,
    "slice": lambda m, v: v[::2, 1:],
    "take": lambda m, v: v[1:5, [0, 2, 3]],
    "mask": lambda m, v: v[v.astype(np.float32) > 0],
    "reshape": lambda m, v: v.reshape(4, 12),
    "concatenate": lambda m, v: m.concatenate([v, v[:2]], axis=0),
    "stack": lambda m, v: m.stack([v, v]),
    "view_uint8": lambda m, v: v.view(np.uint8),
    "view_int8": lambda m, v: v.view(np.int8),
    "view_back": lambda m, v: v.view(np.uint8).view(v.dtype),
    "tril": lambda m, v: m.tril(v),
    "pad_constant": lambda m, v: m.pad(v, 1, constant_values=1),
    "pad_edge": lambda m, v: m.pad(v, 1, mode="edge"),
}

# numpy with ml_dtypes sums (and averages) a narrow float in that type,
# rounding at each step; the port, as the JAX package, in float32
NUMPY_ACCUMULATES = {(n, op) for n in NARROW if n not in INTS for op in ("sum", "sum_axis0", "mean", "prod_axis1")}

FLOAT8S = ("float8_e3m4", "float8_e4m3", "float8_e4m3b11fnuz")
SUB_BYTE = ("int2", "uint2", "int4", "uint4", "float4_e2m1fn")


def _cases(ops, names):
    return {(n, op) for op in ops.split() for n in names}


# the JAX package's results that differ from numpy with ml_dtypes (and so
# from the port), each checked to differ (or raise) below
KNOWN_REFERENCE_FAULTS = (
    # a Python number meets the narrow type weakly in JAX: the op runs in
    # the narrow type (or the promoted one rounds on the way), where numpy
    # promotes to int8/float32 and computes there
    _cases("add_int true_divide", ("float4_e2m1fn", *FLOAT8S, "int2", "uint2"))
    | _cases("add_int chain negative", ("uint4",)) | _cases("chain negative", ("int2", "uint2"))
    | _cases("chain", ("float4_e2m1fn",))
    | _cases("true_divide", ("float8_e8m0fnu",))
    # numpy's matmul of a narrow type is int8 or float32; the JAX package
    # keeps the narrow type (int2/uint2 raise: no dot for U2/S2)
    | _cases("matmul", NARROW) | _cases("dot tensordot argmax_axis0 argmin", ("int2", "uint2"))
    # a narrow float to uint8 through a signed int in XLA (negatives
    # saturate), numpy wraps
    | _cases("astype_uint8", ("float4_e2m1fn", *FLOAT8S))
    # the integer types' mean: numpy sums in the type (wrapping), then
    # divides; float64 to a narrow integer truncates through int32 in
    # numpy, saturates in XLA; uint2/uint4 to int4 and abs differ too
    | _cases("mean from_float64", ("int2", "uint2", "int4", "uint4"))
    | _cases("astype_int4", ("uint2", "uint4")) | _cases("absolute", ("int2", "int4"))
    # views of a sub-byte type: XLA packs them, numpy's are a byte each
    | _cases("view_uint8 view_int8 view_back", SUB_BYTE)
    # e8m0 in XLA: its order, its zero and its casts differ from ml_dtypes'
    # (numpy refuses e8m0 to any other 8-bit float or narrow integer)
    | _cases("argmax_axis0 argmin greater max min_axis0 cumsum_axis0 tril astype_float8_e4m3 astype_int4 "
             "astype_float8_e4m3fn", ("float8_e8m0fnu",))
)

# the JAX package's cases whose XLA compile aborts the process
JAX_ABORTS = _cases("mask", ("int2", "uint2"))


def _run(m, name, op, a=None):
    a = sample(name) if a is None else a
    if m is np:
        with np.errstate(all="ignore"):
            return np.asarray(OPS[op](np, a))
    return np.asarray(OPS[op](m, m.from_array(a, chunks=(4, 3))).compute())


def _outcome(m, name, op):
    """The result, or ``TypeError`` where the package refuses the case
    (numpy refuses some casts between narrow types: uint4 to int4, e8m0 to
    float8_e4m3)."""
    try:
        return _run(m, name, op)
    except TypeError:
        return TypeError


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("name", NARROW)
def test_op_against_references(name, op):
    got = _outcome(tda, name, op)
    want = _outcome(np, name, op)
    if want is TypeError:
        assert got is TypeError  # numpy refuses the cast: so does the port
    elif (name, op) in NUMPY_ACCUMULATES:
        # numpy's own sum rounds at each step: hold the port to the sum of
        # the values in float64, rounded once to the type
        exact = _run(np, name, op, sample(name).astype(np.float64)).astype(want.dtype)
        assert same(got, exact), (got, exact)
    else:
        assert same(got, want), (got, want)
    if (name, op) in KNOWN_REFERENCE_FAULTS | JAX_ABORTS:
        return
    assert same(got, _run(jda, name, op))


@pytest.mark.parametrize("name, op", sorted(KNOWN_REFERENCE_FAULTS))
def test_known_reference_faults_are_real(name, op):
    got = _outcome(tda, name, op)
    try:
        ref = _run(jda, name, op)
    except Exception:  # the JAX package refuses the case: a fault too
        return
    assert got is TypeError or ref.dtype != got.dtype or ref.shape != got.shape or not same(got, ref)


@pytest.mark.parametrize("name", NARROW)
@pytest.mark.parametrize("maker", ["zeros", "ones", "full", "empty", "arange", "zeros_like", "ones_like",
                                   "full_like", "empty_like"])
def test_creation(name, maker):
    """Creation in each narrow type: numpy's values (zeros and empty are
    zero bytes, as numpy's: e8m0 has no zero, so its zeros are its
    smallest value), the JAX package's dtype and shape."""
    dt = dt_of(name)
    like = sample(name, (4, 5))
    make = {
        "zeros": lambda m: m.zeros((4, 5), dtype=dt, **kw(m)),
        "ones": lambda m: m.ones((4, 5), dtype=dt, **kw(m)),
        "full": lambda m: m.full((4, 5), 3, dtype=dt, **kw(m)),
        "empty": lambda m: m.empty((4, 5), dtype=dt, **kw(m)),
        "arange": lambda m: m.arange(1, 7, dtype=dt, **kw(m)),
        "zeros_like": lambda m: m.zeros_like(src(m)),
        "ones_like": lambda m: m.ones_like(src(m)),
        "full_like": lambda m: m.full_like(src(m), 2),
        "empty_like": lambda m: m.empty_like(src(m)),
    }[maker]

    def kw(m):
        return {} if m is np else {"chunks": 2}

    def src(m):
        return like if m is np else m.from_array(like, chunks=2)

    got = np.asarray(make(tda).compute())
    want = make(np)
    ref = np.asarray(make(jda).compute())
    assert got.dtype == want.dtype == ref.dtype == dt and got.shape == want.shape == ref.shape
    if not maker.startswith("empty"):
        assert same(got, want)


# -- histograms: K2's byte route on the card, its plain version here ------------------

HIST_CASES = [(n, "edges") for n in NARROW] + [(n, "auto") for n in sorted(INTS)] + [(n, "weighted") for n in NARROW]
# the JAX package's histograms of these types differ from numpy's of their
# values (it bins in the narrow type itself), and it refuses weights with
# any narrow type (no implicit promotion)
HIST_REFERENCE_FAULTS = {(n, b) for n in ("int2", "uint2", "float4_e2m1fn", *FLOAT8S, "float8_e8m0fnu")
                         for b in ("edges", "auto")} | {(n, "weighted") for n in NARROW}


def _histogram(m, name, bins):
    a = sample(name, (40, 50), seed=3)
    edges = np.linspace(-4, 4, 17)
    w = np.random.default_rng(4).standard_normal(a.shape)
    kw = {"bins": 8} if bins == "auto" else {"bins": edges}
    if bins == "weighted":
        kw["weights"] = w if m is np else m.from_array(w, chunks=(8, 10))
    if m is np:
        # numpy's histogram of the values (numpy's own on e8m0 loses counts)
        return np.histogram(a if bins == "auto" else a.astype(np.float64), **kw)[0]
    return np.asarray(m.histogram(m.from_array(a, chunks=(8, 10)), **kw)[0].compute())


def _hist_same(got, want, bins):
    """Counts bit for bit; weight sums (float64, summed in another order
    than numpy's) to ``WEIGHT_RTOL``."""
    if bins != "weighted":
        return same(got, want)
    return got.dtype == want.dtype and np.allclose(got, want, rtol=WEIGHT_RTOL, atol=WEIGHT_RTOL)


WEIGHT_RTOL = 1e-12


@pytest.mark.parametrize("name, bins", HIST_CASES)
def test_histogram(name, bins):
    """numpy's histogram of the values over float64 edges (and integer
    types' autodetected ones), counts or float64 weight sums: the byte
    route's plain version, equal to numpy's."""
    got = _histogram(tda, name, bins)
    assert _hist_same(got, _histogram(np, name, bins), bins)
    if (name, bins) not in HIST_REFERENCE_FAULTS:
        assert _hist_same(got, _histogram(jda, name, bins), bins)


@pytest.mark.parametrize("name, bins", sorted(HIST_REFERENCE_FAULTS & set(HIST_CASES)))
def test_histogram_reference_faults_are_real(name, bins):
    got = _histogram(tda, name, bins)
    try:
        ref = _histogram(jda, name, bins)
    except Exception:  # weights: the JAX package refuses to promote the narrow type
        return
    assert not _hist_same(got, ref, bins)


REFUSING = {
    "unique": lambda x: tda.unique(x),
    "searchsorted": lambda x: tda.searchsorted(tda.from_array(np.arange(4.0), chunks=2), x.ravel()),
    "median": lambda x: tda.median(x, axis=0),
    "map_blocks": lambda x: x.map_blocks(lambda b: b, dtype=x.dtype),
    "map_overlap": lambda x: tda.map_overlap(lambda b: b, x, depth=1, boundary="none"),
}


@pytest.mark.parametrize("what", sorted(REFUSING))
@pytest.mark.parametrize("name", ["int4", "float8_e4m3"])
def test_nodes_that_do_not_decode_refuse_narrow_types(name, what):
    """A node whose build would read a carrier's patterns as uint8 numbers
    (sorts, searches, quantiles, a user's block function) raises, naming
    the type, rather than answer wrongly (``ArrayExpr.takes_narrow``)."""
    with pytest.raises(NotImplementedError, match=f"ml_dtypes.{name}"):
        REFUSING[what](tda.from_array(sample(name), chunks=(4, 3))).compute()


# -- under a mesh ---------------------------------------------------------------------

# the reduced and contracted axis 0 is the one the mesh shards
MESH_OPS = {
    "max_axis0": lambda x: x.max(axis=0),
    "min_axis0": lambda x: x.min(axis=0),
    "sum_axis0": lambda x: x.sum(axis=0),
    "mean_axis0": lambda x: x.mean(axis=0),
    "argmax_axis0": lambda x: x.argmax(axis=0),
    "argmin": lambda x: x.argmin(),
    "cumsum_axis0": lambda x: x.cumsum(axis=0),
    "tensordot_axis0": lambda x: tda.tensordot(x, x, axes=([0], [0])),
    "matmul": lambda x: x.T @ x,
}
# two narrow types (an integer and a float) and one of torch's float8 types
MESH_TYPES = ["int4", "float8_e4m3", "float8_e4m3fn"]
# the nodes whose partitioned rules may take narrow data: they move patterns
PATTERN_RULES = {"Transpose", "Slice", "ChunksFreeze", "Rechunk", "Shuffle"}


def ring8():
    return Mesh(np.array(["cpu"] * 8, dtype=object), ("r",))


@pytest.mark.parametrize("lane", ["gspmd", "auto"])
@pytest.mark.parametrize("op", sorted(MESH_OPS))
@pytest.mark.parametrize("name", MESH_TYPES)
def test_mesh_lanes_equal_the_walk_without_one(name, op, lane):
    """Under 8 CPU slots each lane's result equals the walk without a mesh,
    bit for bit.  The shard lane declines every program with narrow data
    (its typed combines would order bit patterns as numbers, or round once
    a part)."""
    x = tda.from_array(sample(name, (64, 12), seed=3), chunks=(8, 12))
    want = MESH_OPS[op](x).compute()
    engaged = ENGAGED["count"]
    with use_mesh(ring8()), tconfig.set({"execution-lane": lane}):
        got = MESH_OPS[op](x).compute()
    assert same(got, want)
    assert ENGAGED["count"] == engaged


@pytest.mark.parametrize("op", sorted(MESH_OPS))
@pytest.mark.parametrize("name", MESH_TYPES)
def test_sharded_narrow_leaf_takes_the_dense_builds(name, op):
    """A narrow leaf held sharded (a persisted carrier under the mesh)
    reaches the partitioned walk's rules.  Only the rules that move
    patterns run per slot; every reduction, scan and contraction takes its
    dense build from the gathered operand, and the result equals the walk
    without a mesh, bit for bit."""
    arr = sample(name, (64, 12), seed=4)
    want = MESH_OPS[op](tda.from_array(arr, chunks=(8, 12))).compute()
    mesh = ring8()
    with use_mesh(mesh), tconfig.set({"execution-lane": "gspmd"}):
        carrier = tda.from_array(arr.view(np.uint8), chunks=(8, 12)).persist()
        st = carrier._expr.buffer
        assert isinstance(st, ShardedTensor) and st.spec[0] is not None
        held = ShardedTensor(mesh, st.spec, [t.view(torch_dtype(arr.dtype)) for t in st.shards], st.global_shape,
                             st.bounds)
        x = new_collection(Persisted(held, carrier.chunks, f"sharded-{name}", arr.dtype))
        before = PARTITIONED.snapshot()
        got = MESH_OPS[op](x).compute()
        delta = PARTITIONED.delta(before)
    assert same(got, want)
    assert delta["bound"] == {"Persisted": 1}
    assert set(delta.get("slots", {})) <= PATTERN_RULES, delta
    assert delta["gathered"], delta



# -- contractions of torch's float8 types ------------------------------------------------

CONTRACTIONS = {
    "matmul": lambda m, a, b: m.matmul(a, b),
    "dot": lambda m, a, b: m.dot(a, b),
    "tensordot": lambda m, a, b: m.tensordot(a, b, axes=1),
}


@pytest.mark.parametrize("op", sorted(CONTRACTIONS))
@pytest.mark.parametrize("name", TORCH_FLOAT8)
def test_torch_float8_contractions(name, op):
    """torch computes in none of its float8 types, so a contraction of
    them decodes to float32 as a narrow type's does.  The port equals numpy
    bit for bit: ``matmul`` is float32, ``dot`` and ``tensordot`` keep the
    type.  It equals the JAX package too, except that the JAX package's
    ``matmul`` keeps the float8 type (a known fault of the reference,
    checked to differ here)."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((8, 6)).astype(dt_of(name))
    b = rng.standard_normal((6, 5)).astype(dt_of(name))
    want = CONTRACTIONS[op](np, a, b)
    got = CONTRACTIONS[op](tda, tda.from_array(a, chunks=(4, 3)), tda.from_array(b, chunks=(3, 5))).compute()
    ref = CONTRACTIONS[op](jda, jda.from_array(a, chunks=(4, 3)), jda.from_array(b, chunks=(3, 5))).compute()
    assert same(got, want)
    if op == "matmul":
        assert np.asarray(ref).dtype == dt_of(name) != np.asarray(got).dtype
    else:
        assert same(got, ref)


# -- scans of 1-byte floats -----------------------------------------------------------

SCANS = ("cumsum", "cumprod", "nancumsum", "nancumprod")
SCAN_TYPES = TORCH_FLOAT8 + [n for n in NARROW if n not in INTS]


def _nan_signless(a):
    """The bytes of a 1-byte float array with every NaN as one pattern."""
    return np.where(np.isnan(a.astype(np.float32)), -1, a.view(np.uint8).astype(np.int16))


@pytest.mark.parametrize("shape,axis", [((40, 3), 0), ((5, 37), 1), ((60,), 0), ((4, 5, 6), 1), ((0, 3), 0)])
@pytest.mark.parametrize("kind", SCANS)
@pytest.mark.parametrize("name", SCAN_TYPES)
def test_byte_float_scans_equal_numpy(name, kind, shape, axis):
    """numpy rounds a 1-byte float's scan to the type after every step (and
    its nan-scans replace no NaN of an ml_dtypes type); the port's table
    scan (``reductions.byte_scan``) equals it, on values that overflow the
    type and with a NaN among them.  A NaN's sign is left out of the
    comparison: where both operands of a step are NaN, which one's sign
    the float32 result keeps is the host's choice."""
    rng = np.random.default_rng(11)
    a = (rng.standard_normal(shape) * 64).astype(dt_of(name))
    if a.size > 7:
        a.flat[7] = np.nan
    with np.errstate(all="ignore"):
        want = getattr(np, kind)(a, axis=axis)
    got = np.asarray(getattr(tda, kind)(tda.from_array(a, chunks=3), axis=axis).compute())
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(_nan_signless(got), _nan_signless(want))

