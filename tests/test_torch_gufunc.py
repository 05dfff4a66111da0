"""Generalized ufuncs (``apply_gufunc``, ``gufunc``, ``as_gufunc``) and
``shuffle`` through the port on the CPU.

Each case runs data made from a numpy seed (``from_array``, several
chunkings) through the port (torch functions), the JAX package (the same
functions written with jnp) and numpy (``np.vectorize`` of the signature,
or a numpy expression).  Tolerance: layout results (``shuffle``, moved
axes, transposes) and integer results equal numpy's exactly, dtype and
shape included; float reductions to rtol 1e-12 in float64, and to rtol
1e-5 with atol 1e-5 in float32 (sums of values near 10 that cancel).
Chunks are compared with the JAX package's where both define them (a
gufunc's loop axes, a shuffle's merged groups).
"""

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch._shuffle import Shuffle

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


def base(dtype="float64", shape=(6, 5, 8), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 10).astype(dtype)


def same(got, want, rtol=0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    if rtol:
        # float32 sums of values near 10 may cancel: an absolute 1e-5 too
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 if got.dtype == np.float32 else 0)
    else:
        np.testing.assert_array_equal(got, want)


def _jnp():
    import jax.numpy as jnp

    return jnp


# name -> (signature, torch function, jnp function, numpy reference of the
# inputs, keyword arguments, input shapes, dtype of the results or None)
GUFUNCS = {
    "sum": ("(i)->()", lambda x: x.sum(-1), lambda x: x.sum(-1), lambda x: x.sum(-1), {}, [(6, 5, 8)], None),
    "inner": ("(i),(i)->()", lambda x, y: (x * y).sum(-1), lambda x, y: (x * y).sum(-1),
              lambda x, y: (x * y).sum(-1), {}, [(6, 5, 8), (5, 8)], None),
    "scan": ("(i)->(i)", lambda x: torch.cumsum(x, -1), lambda x: _jnp().cumsum(x, -1), lambda x: np.cumsum(x, -1),
             {}, [(6, 5, 8)], None),
    "transpose": ("(m,n)->(n,m)", lambda x: x.transpose(-1, -2), lambda x: _jnp().swapaxes(x, -1, -2),
                  lambda x: np.swapaxes(x, -1, -2), {}, [(6, 5, 8)], None),
    "outer": ("(i),(j)->(i,j)", lambda x, y: x[..., :, None] * y[..., None, :],
              lambda x, y: x[..., :, None] * y[..., None, :], lambda x, y: x[..., :, None] * y[..., None, :], {},
              [(6, 5, 8), (6, 1, 3)], None),
    "new_core": ("()->(k)", lambda x: torch.stack([x, 2 * x, 3 * x], -1), lambda x: _jnp().stack([x, 2 * x, 3 * x], -1),
                 lambda x: np.stack([x, 2 * x, 3 * x], -1), {"output_sizes": {"k": 3}}, [(6, 5, 8)], None),
    "axis": ("(i)->()", lambda x: x.amax(-1), lambda x: x.max(-1), lambda x: x.max(1), {"axis": 1}, [(6, 5, 8)], None),
    "axis_keepdims": ("(i)->()", lambda x: x.amin(-1), lambda x: x.min(-1), lambda x: x.min(0, keepdims=True),
                      {"axis": 0, "keepdims": True}, [(6, 5, 8)], None),
    "axes": ("(i,j)->(j)", lambda x: x.sum(-2), lambda x: x.sum(-2), lambda x: x.sum(0),
             {"axes": [(0, 2), (1,)]}, [(6, 5, 8)], None),
    "dtype": ("(i)->()", lambda x: (x > 0).sum(-1), lambda x: (x > 0).sum(-1), lambda x: (x > 0).sum(-1),
              {"output_dtypes": np.int64}, [(6, 5, 8)], None),
}


@pytest.mark.parametrize("name", sorted(GUFUNCS))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("chunks", [2, 3, 8])
def test_apply_gufunc(name, dtype, chunks):
    sig, tfn, jfn, nfn, kw, shapes, _ = GUFUNCS[name]
    arrays = [base(dtype, s, seed=i) for i, s in enumerate(shapes)]
    want = nfn(*arrays)
    rtol = (1e-12 if dtype == "float64" else 1e-5) if want.dtype.kind == "f" else 0
    got = tda.apply_gufunc(tfn, sig, *[tda.from_array(a, chunks=chunks) for a in arrays], allow_rechunk=True, **kw)
    same(got.compute(), want, rtol)
    if chunks == 3:
        ref = jda.apply_gufunc(jfn, sig, *[jda.from_array(a, chunks=chunks) for a in arrays], allow_rechunk=True,
                               **kw)
        same(ref.compute(), want, rtol)
        if "axes" not in kw:
            assert got.chunks == ref.chunks


@pytest.mark.parametrize("chunks", [2, 5])
def test_several_outputs(chunks):
    a = base("float64")
    x = tda.from_array(a, chunks=chunks)
    lo, hi = tda.apply_gufunc(lambda t: (t.amin(-1), t.amax(-1)), "(i)->(),()", x, allow_rechunk=True,
                              output_dtypes=[np.float64, np.float64])
    same(lo.compute(), a.min(-1))
    same(hi.compute(), a.max(-1))
    q, r = tda.apply_gufunc(lambda t: (t // 3, t % 3), "()->(),()", tda.from_array(np.arange(20), chunks=6))
    same(q.compute(), np.arange(20) // 3)
    same(r.compute(), np.arange(20) % 3)
    jlo, jhi = jda.apply_gufunc(lambda t: (t.min(-1), t.max(-1)), "(i)->(),()", jda.from_array(a, chunks=chunks),
                                allow_rechunk=True, output_dtypes=[np.float64, np.float64])
    same(jhi.compute(), a.max(-1))


@pytest.mark.parametrize("sig, fn, nfn, shapes", [
    ("(i)->()", lambda v: torch.dot(v, v), lambda v: v @ v, [(6, 5, 8)]),
    ("(i),(i)->()", lambda v, w: (v * w).sum(), lambda v, w: (v * w).sum(), [(6, 5, 8), (8,)]),
    ("()->()", lambda v: v * 2 + 1, lambda v: v * 2 + 1, [(6, 5)]),
    ("(i)->(i)", lambda v: v.flip(0), lambda v: v[::-1], [(4, 8)]),
])
def test_vectorize_is_vmap(sig, fn, nfn, shapes):
    arrays = [base("float64", s, seed=i) for i, s in enumerate(shapes)]
    want = np.vectorize(nfn, signature=sig)(*arrays)
    got = tda.apply_gufunc(fn, sig, *[tda.from_array(a, chunks=3) for a in arrays], vectorize=True,
                           allow_rechunk=True, output_dtypes=np.float64)
    same(got.compute(), want, 1e-12)


def test_gufunc_and_as_gufunc():
    a = base("float32")
    x = tda.from_array(a, chunks=(3, 5, 8))
    g = tda.gufunc(lambda t: t.mean(-1), signature="(i)->()", output_dtypes=np.float32)
    same(g(x).compute(), a.mean(-1), 1e-6)

    @tda.as_gufunc("(i),(i)->()", output_dtypes=np.float32, allow_rechunk=True)
    def dot(u, v):
        return (u * v).sum(-1)

    y = tda.from_array(a, chunks=2)
    same(dot(y, y).compute(), (a * a).sum(-1), 1e-5)
    assert g.__name__ == "<lambda>" and dot.signature == "(i),(i)->()"


def test_gufunc_refusals():
    x = tda.from_array(base("float64"), chunks=3)
    with pytest.raises(ValueError, match="allow_rechunk"):
        tda.apply_gufunc(lambda t: t.sum(-1), "(i)->()", x)
    with pytest.raises(ValueError, match="Not a valid gufunc signature"):
        tda.apply_gufunc(lambda t: t, "(i)->>()", x)
    with pytest.raises(ValueError, match="output_sizes"):
        tda.apply_gufunc(lambda t: t, "(i)->(k)", x, allow_rechunk=True)
    with pytest.raises(ValueError, match="inconsistent"):
        tda.apply_gufunc(lambda t, u: t, "(i),(i)->()", x, tda.ones(3, chunks=3), allow_rechunk=True)
    with pytest.raises(ValueError, match="both axis= and axes="):
        tda.apply_gufunc(lambda t: t, "(i)->()", x, axis=0, axes=[(0,)])


SHUFFLES = [
    ([[1, 2], [0, 5, 3], [4]], 0),
    ([[4, 3, 2, 1, 0], [5]], 0),
    ([[0], [1], [2], [3], [4]], 1),
    ([[7, 0, 3], [6, 1], [2, 5, 4]], 2),
    ([[0, 0, 5], [5, 1]], 0),
]


@pytest.mark.parametrize("indexer, axis", SHUFFLES)
@pytest.mark.parametrize("dtype", ["float64", "int8", "uint16", "uint64", "bool", "complex64"])
@pytest.mark.parametrize("chunks", [1, 2, (6, 5, 8)])
def test_shuffle(indexer, axis, dtype, chunks):
    a = base("float64")
    a = (a > 0) if dtype == "bool" else (a * (1 + 1j) if dtype == "complex64" else np.abs(a)).astype(dtype)
    flat = np.concatenate([np.asarray(g, dtype=np.int64) for g in indexer])
    want = np.take(a, flat, axis=axis)
    got = tda.shuffle(tda.from_array(a, chunks=chunks), indexer, axis=axis)
    same(got.compute(), want)
    ref = jda.shuffle(jda.from_array(a, chunks=chunks), indexer, axis=axis)
    assert got.chunks == ref.chunks
    if dtype == "float64":
        same(ref.compute(), want)


def test_shuffle_pushdown_method_and_refusals():
    a = base("float64")
    x = tda.from_array(a, chunks=2)
    y = x.shuffle([[3, 1], [0, 2, 5, 4]], axis=0)[:, 1:4, 2:]
    plan = y.expr.simplify()
    assert isinstance(plan, Shuffle) and plan.array.shape == (6, 3, 6)  # the slice went below
    same(y.compute(), a[[3, 1, 0, 2, 5, 4]][:, 1:4, 2:])
    assert tda.shuffle(x, [[0, 1], [2, 3], [4, 5]]).expr.simplify() is x.expr.simplify()  # identity goes
    with pytest.raises(IndexError, match="out of bounds"):
        tda.shuffle(x, [[0, 6]])
    with pytest.raises(ValueError, match="list of lists"):
        tda.shuffle(x, [1, 2])
