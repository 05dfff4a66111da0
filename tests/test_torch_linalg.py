"""The port's contractions and the flagship pipelines against the JAX
package and numpy.

``einsum`` with the specs ``tests/test_linalg_*.py`` use, ``tensordot``,
``dot`` and ``matmul`` (including integer and bool operands, which take
the exact integer route), slice pushdown through free labels, the
``matmul-precision`` knob, and ``normalize_contract``, ``blocked_matmul``
and ``reduction_tree`` as wholes at small sizes.  Inputs come from a numpy
seed and go through both packages.

Tolerances: float64 rtol 1e-10 (the sums run in another order than
numpy's); float32 rtol 1e-5 with an atol of 2^-20 times the sum of
|products| (contractions of a few dozen terms); integers and bools exact.
"""

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.models import pipelines as tpipes

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def both(fn, *arrays, chunks):
    """``fn`` applied to the arrays wrapped by the port and by the JAX
    package; returns (port Array, JAX Array)."""
    t = fn(tda, *[tda.from_array(a, chunks=c) for a, c in zip(arrays, chunks)])
    j = fn(jda, *[jda.from_array(a, chunks=c) for a, c in zip(arrays, chunks)])
    return t, j


def check(t, j, want, rtol=1e-10, atol=0.0):
    assert t.dtype == want.dtype
    assert t.shape == want.shape
    assert t.chunks == j.chunks
    got = np.asarray(t.compute())
    ref = np.asarray(j.compute())
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


SPECS = [
    ("ij,jk->ik", [(12, 9), (9, 7)]),
    ("ij->ji", [(12, 9)]),
    ("ij->", [(12, 9)]),
    ("ij,ij->i", [(12, 9), (12, 9)]),
    ("ij,jk", [(12, 9), (9, 7)]),
    ("...ij,jk->...ik", [(3, 12, 9), (9, 7)]),
    ("ii->i", [(9, 9)]),
    ("ijk,kj->i", [(4, 6, 5), (5, 6)]),
]


@pytest.mark.parametrize("dtype", ["float64", "float32", "int32", "int64", "bool"])
@pytest.mark.parametrize("spec, shapes", SPECS, ids=[s for s, _ in SPECS])
def test_einsum(spec, shapes, dtype, rng):
    if dtype == "bool":
        arrays = [rng.random(s) < 0.5 for s in shapes]
    elif dtype.startswith("int"):
        arrays = [rng.integers(-50, 50, size=s).astype(dtype) for s in shapes]
    else:
        arrays = [rng.standard_normal(s).astype(dtype) for s in shapes]
    chunks = [tuple(max(1, n // 2) for n in s) for s in shapes]
    want = np.einsum(spec, *arrays)
    t, j = both(lambda m, *xs: m.einsum(spec, *xs), *arrays, chunks=chunks)
    if t.dtype.kind in "biu":
        assert t.expr.exact
    atol = 2.0**-20 * float(np.einsum(spec, *[np.abs(a.astype("f8")) for a in arrays]).max())
    check(t, j, want, rtol=1e-5 if dtype == "float32" else 1e-10, atol=atol if dtype == "float32" else 0.0)


def test_integer_contraction_is_exact_beyond_float_precision(rng):
    # products near 2^60: float64 would round them, numpy's einsum does not
    a = np.array([[2**30 + 1, 3], [5, 7]], dtype="i8")
    b = np.array([[2**30 - 1, 1], [2, 2**29 + 3]], dtype="i8")
    got = (tda.from_array(a, chunks=1) @ tda.from_array(b, chunks=1)).compute()
    np.testing.assert_array_equal(got, a @ b)
    # int32 results wrap as numpy's do
    c = np.full((4, 4), 60000, dtype="i4")
    np.testing.assert_array_equal((tda.from_array(c, chunks=2) @ tda.from_array(c, chunks=2)).compute(), c @ c)


@pytest.mark.parametrize(
    "lshape, rshape, axes",
    [((6, 5), (5, 4), 1), ((6, 5, 4), (5, 3, 6), ((1, 0), (0, 2))), ((4, 3, 5), (5, 3, 2), ([2, 1], [0, 1])),
     ((6, 5), (6, 5), 2)],
)
def test_tensordot(lshape, rshape, axes, rng):
    a, b = rng.standard_normal(lshape), rng.standard_normal(rshape)
    t, j = both(lambda m, x, y: m.tensordot(x, y, axes=axes), a, b, chunks=[2, 3])
    check(t, j, np.tensordot(a, b, axes=axes))


@pytest.mark.parametrize("lshape, rshape", [((7, 5), (5, 4)), ((7, 5), (5,)), ((5,), (5, 4)), ((5,), (5,)),
                                            ((3, 7, 5), (3, 5, 4)), ((3, 7, 5), (5, 4))])
def test_matmul_and_dot(lshape, rshape, rng):
    a, b = rng.standard_normal(lshape), rng.standard_normal(rshape)
    t, j = both(lambda m, x, y: x @ y, a, b, chunks=[3, 2])
    check(t, j, a @ b)
    if len(lshape) <= 2 and len(rshape) <= 2:
        t, j = both(lambda m, x, y: m.dot(x, y), a, b, chunks=[3, 2])
        check(t, j, np.dot(a, b))
        t, j = both(lambda m, x, y: x.dot(y), a, b, chunks=[3, 2])
        check(t, j, np.dot(a, b))
    assert np.allclose((a @ tda.from_array(b, chunks=2)).compute(), a @ b)


def test_matmul_rejects_scalars_and_dot_scales(rng):
    a = rng.standard_normal((4, 3))
    with pytest.raises(ValueError, match="scalars"):
        tda.matmul(tda.from_array(a, chunks=2), 2.0)
    np.testing.assert_allclose(tda.dot(tda.from_array(a, chunks=2), 3.0).compute(), a * 3.0)


def test_einsum_dtype_and_casting(rng):
    a, b = rng.standard_normal((5, 4)), rng.standard_normal((4, 3))
    ta, tb = tda.from_array(a, chunks=2), tda.from_array(b, chunks=2)
    got = tda.einsum("ij,jk->ik", ta, tb, dtype="f4", casting="unsafe")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got.compute(), np.einsum("ij,jk->ik", a, b, dtype="f4", casting="unsafe"), rtol=1e-5)
    with pytest.raises(TypeError, match="casting"):
        tda.einsum("ij,jk->ik", ta, tb, dtype="i4")
    with pytest.raises(ValueError, match="order"):
        tda.einsum("ij,jk->ik", ta, tb, order="Z")
    i = rng.integers(0, 9, size=(5, 4)).astype("i4")
    got = tda.einsum("ij,jk->ik", tda.from_array(i, chunks=2), tb)
    assert got.dtype == np.float64 and not got.expr.exact
    np.testing.assert_allclose(got.compute(), i @ b, rtol=1e-10)


def test_einsum_slice_pushdown(rng):
    a, b = rng.standard_normal((20, 8)), rng.standard_normal((8, 30))
    y = (tda.from_array(a, chunks=5) @ tda.from_array(b, chunks=5))[2:7, 10:25]
    plan = y.optimize().expr.tree_repr()
    assert plan.splitlines()[0].startswith("Einsum")
    assert "Slice" not in plan and "region=(slice(2, 7, 1), slice(None" in plan
    np.testing.assert_allclose(y.compute(), (a @ b)[2:7, 10:25], rtol=1e-10)
    jy = (jda.from_array(a, chunks=5) @ jda.from_array(b, chunks=5))[2:7, 10:25]
    assert y.chunks == jy.chunks


def test_matmul_precision_is_scoped(monkeypatch, rng):
    from dask_array_tpu_torch.ops.linalg import matmul_precision

    seen = []
    real = torch.einsum

    def spy(*args, **kw):
        seen.append(torch.get_float32_matmul_precision())
        return real(*args, **kw)

    a = rng.standard_normal((6, 6)).astype("f4")
    x = tda.from_array(a, chunks=3)
    saved = torch.get_float32_matmul_precision()
    monkeypatch.setattr(torch, "einsum", spy)
    try:
        torch.set_float32_matmul_precision("high")  # a caller's global TF32
        (x @ x).compute()  # default "highest": full f32 inside, whatever outside
        assert seen[-1] == "highest"
        assert torch.get_float32_matmul_precision() == "high"
        with tconfig.set({"matmul-precision": "default"}):
            (x @ x + 1).compute()
        assert seen[-1] == "high"
        torch.set_float32_matmul_precision("highest")
        with tconfig.set({"matmul-precision": "high"}):
            (x @ x + 2).compute()
        assert seen[-1] == "high" and torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.set_float32_matmul_precision(saved)
    with pytest.raises(ValueError, match="matmul-precision"):
        with matmul_precision("bogus"):
            pass
    assert tconfig.get("matmul-precision") == "highest"
    assert tconfig.from_reference({"tpu.matmul-precision": "default"}) == {"matmul-precision": "default"}


# ---------------------------------------------------------------------------
# the pipelines as wholes, at small sizes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_normalize_contract(dtype, rng):
    from dask_array_tpu.models.pipelines import normalize_contract as jax_normalize_contract

    a = rng.standard_normal((64, 48)).astype(dtype) * 3 + 1
    b = rng.standard_normal((20, 48)).astype(dtype)
    got = tpipes.normalize_contract(tda.from_array(a, chunks=(16, 16)), tda.from_array(b, chunks=8))
    ref = jax_normalize_contract(jda.from_array(a, chunks=(16, 16)), jda.from_array(b, chunks=8))
    a64 = a.astype("f8")
    y = ((a64 - a64.mean(0)) / (a64.std(0) + 1e-6)) @ b.astype("f8").T
    want = (y * y).sum(1)
    assert got.dtype == np.dtype(dtype) == ref.dtype
    assert got.chunks == ref.chunks
    rtol = 1e-5 if dtype == "float32" else 1e-10
    np.testing.assert_allclose(got.compute(), want, rtol=rtol)
    np.testing.assert_allclose(got.compute(), np.asarray(ref.compute()), rtol=rtol)


def test_blocked_matmul(rng):
    a = rng.standard_normal((64, 64)).astype("f4")
    b = rng.standard_normal((64, 64)).astype("f4")
    got = tpipes.blocked_matmul(chunk=16, a_np=a, b_np=b)
    ref = jda.from_array(a, chunks=16) @ jda.from_array(b, chunks=8)
    assert got.chunks == ref.chunks == ((16,) * 4, (8,) * 8)
    want = a.astype("f8") @ b.astype("f8")
    atol = 2.0**-20 * float((np.abs(a.astype("f8")) @ np.abs(b.astype("f8"))).max())
    np.testing.assert_allclose(got.compute(), want, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got.compute(), np.asarray(ref.compute()), rtol=1e-5, atol=atol)


def test_reduction_tree_through_one_kernel_call(rng):
    from dask_array_tpu_torch.kernels import mstat

    x = (rng.standard_normal((120, 90)) + 50).astype("f4")
    s, m, sd = tpipes.reduction_tree(chunk=25, split_every=4, x_np=x)
    jx = jda.from_array(x, chunks=25)
    refs = jda.compute(jx.sum(axis=0, split_every=4), jx.mean(axis=1, split_every=4), jx.std(split_every=4))
    x64 = x.astype("f8")
    joint = tda.compute(s, m, sd)
    apart = (s.compute(), m.compute(), sd.compute())
    for got in (joint, apart):
        np.testing.assert_allclose(got[0], x64.sum(0), rtol=1e-5, atol=2.0**-20 * 120 * 51)
        np.testing.assert_allclose(got[1], x64.mean(1), rtol=1e-5)
        np.testing.assert_allclose(got[2], x64.std(), rtol=1e-4)
        for g, r in zip(got, refs):
            np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-3)
    # computed together, the three read x once through the kernel's route
    # (here its plain version: the tensors lie on the CPU)
    launches = mstat.LAUNCHES
    from dask_array_tpu_torch._materialize import optimize_expr
    from dask_array_tpu_torch.ops._multistat import MultiStat, fuse_multi_stat

    fused = fuse_multi_stat([s.expr, m.expr, sd.expr])
    stats = {n._name for e in fused for n in optimize_expr(e).walk() if isinstance(n, MultiStat)}
    assert len(stats) == 1
    assert not any(isinstance(n, MultiStat) for n in optimize_expr(s.expr).walk())
    assert mstat.LAUNCHES == launches  # no kernel on the CPU
