"""The port's decompositions against the JAX package and numpy, on the CPU.

``svd``/``svd_flip``, ``tsqr``, ``qr`` (TSQR, single block, ``sfqr``,
``BlockedQR``), ``lu`` (block-local pivots, the strip form, in-core),
``cholesky``, ``solve``, ``solve_triangular``, ``inv``, ``lstsq`` and
``norm``.  The port has one algorithm per operation (the JAX package's
defaults); its QR and SVD are held against the JAX package under each of
that package's method keys.  Inputs are seeded numpy arrays through
``from_array`` into both packages; numpy breaks ties (where the JAX package
differs from numpy, the port follows numpy).

Tolerances:
- float64 values: rtol 1e-10 (atol 1e-10 times the largest magnitude);
- float32 singular values: rtol 1e-4; float32 vectors and factors: atol
  1e-4 times the largest magnitude (CholeskyQR3 in another order);
- reconstruction ``|U S Vh - X| / |X|`` and orthogonality ``|U^H U - I|``:
  20 * eps * n of the dtype, n the small dimension;
- before ``svd_flip``, U and Vh agree with the JAX package only up to a
  sign per column (LAPACK's and XLA's eigenvector signs), so those tests
  compare magnitudes; after it, the values themselves;
- permutations, ranks and shapes: exact.
"""

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu.ops import linalg_decomp as jld
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.models import pipelines as tpipes
from dask_array_tpu_torch.ops import linalg_decomp as tld

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


def sample(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def spd(n, dtype, seed=0):
    a = sample((n, n), dtype, seed)
    return (a @ a.conj().T + n * np.eye(n)).astype(dtype)


def eps(dtype):
    return float(np.finfo(np.dtype(dtype)).eps)


def close(got, want, dtype, what=""):
    """Values at the file's tolerance for their dtype."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-300)
    if np.dtype(dtype) in (np.float32, np.complex64):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * scale, err_msg=what)


def close_s(got, want, dtype):
    rtol = 1e-4 if np.dtype(dtype) in (np.float32, np.complex64) else 1e-10
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.max(want)))


def check_svd(u, s, vh, x):
    """Reconstruction, orthogonality and the singular values against numpy."""
    n = min(x.shape)
    tol = 20 * eps(u.dtype) * n
    assert np.linalg.norm((u * s) @ vh - x) / np.linalg.norm(x) < tol
    assert np.abs(u.conj().T @ u - np.eye(n)).max() < tol
    assert np.abs(vh @ vh.conj().T - np.eye(n)).max() < tol
    close_s(s, np.linalg.svd(x.astype(np.complex128 if x.dtype.kind == "c" else np.float64), compute_uv=False),
            u.dtype)


# the JAX package's method keys; the port's one algorithm matches each
METHODS = [
    {},
    {"tpu.qr-method": "householder"},
    {"tpu.svd-method": "jacobi"},
    {"tpu.tsqr-svd": "barrier"},
    {"tpu.qr-gram": "eigh-clamp"},
    {"tpu.qr-method": "householder", "tpu.svd-method": "jacobi"},
    {"tpu.gram-precision": "high"},
]


# -- svd --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("form", ["tall", "short-fat"])
def test_svd_against_jax_and_numpy(dtype, form):
    x = sample((2000, 16), dtype, seed=1)
    chunks = (250, 16)
    if form == "short-fat":
        x, chunks = x.T.copy(), (16, 250)
    t = tda.linalg.svd(tda.from_array(x, chunks=chunks))
    j = jda.linalg.svd(jda.from_array(x, chunks=chunks))
    for a, b in zip(t, j):
        assert a.chunks == b.chunks and a.dtype == b.dtype
    tu, ts, tvh = tda.compute(*t)
    ju, js, jvh = jda.compute(*j)
    check_svd(tu, ts, tvh, x)
    close_s(ts, js, dtype)
    # svd_flip fixes the signs: the vectors themselves agree
    close(tu, ju, dtype, "u")
    close(tvh, jvh, dtype, "vh")
    assert (tvh.sum(axis=1) >= 0).all()


@pytest.mark.parametrize("values", METHODS, ids=lambda v: ",".join(f"{k[4:]}={w}" for k, w in v.items()) or "default")
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_svd_methods_without_sign_fix(values, dtype):
    x = sample((2000, 16), dtype, seed=2)
    t = tda.compute(*tda.linalg.svd(tda.from_array(x, chunks=(250, 16)), coerce_signs=False))
    with jda.config.set(values):
        j = jda.compute(*jda.linalg.svd(jda.from_array(x, chunks=(250, 16)), coerce_signs=False))
    check_svd(*t, x)
    close_s(t[1], j[1], dtype)
    close(np.abs(t[0]), np.abs(j[0]), dtype, "|u|")
    close(np.abs(t[2]), np.abs(j[2]), dtype, "|vh|")


def test_svd_single_block_complex_and_integer():
    # complex without svd_flip, held against the JAX package by magnitude
    xc = sample((60, 7), "complex128", seed=3)
    t = tda.linalg.svd(tda.from_array(xc, chunks=(60, 7)), coerce_signs=False)
    assert [a.dtype for a in t] == [np.complex128, np.float64, np.complex128]  # numpy's dtypes
    u, s, vh = tda.compute(*t)
    check_svd(u, s, vh, xc)
    ju, js, jvh = jda.compute(*jda.linalg.svd(jda.from_array(xc, chunks=(60, 7)), coerce_signs=False))
    close_s(s, js, "complex128")
    close(np.abs(u), np.abs(ju), "complex128", "|u|")
    xi = np.random.default_rng(4).integers(-9, 9, size=(400, 6))
    t = tda.linalg.svd(tda.from_array(xi, chunks=(100, 6)))
    assert t[0].dtype == np.float64
    tu, ts, tvh = tda.compute(*t)
    check_svd(tu, ts, tvh, xi.astype(np.float64))
    ju, js, jvh = jda.compute(*jda.linalg.svd(jda.from_array(xi, chunks=(100, 6))))
    close(tu, ju, "float64", "u")


def test_svd_tall_complex_uses_the_hermitian_gram():
    x = sample((400, 6), "complex128", seed=5)
    u, s, vh = tda.compute(*tda.linalg.svd(tda.from_array(x, chunks=(100, 6)), coerce_signs=False))
    check_svd(u, s, vh, x)
    js = jda.linalg.svd(jda.from_array(x, chunks=(100, 6)), coerce_signs=False)[1].compute()
    close_s(s, js, "complex128")


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
@pytest.mark.parametrize("chunks", [(60, 7), (15, 7)], ids=["single-block", "tsqr"])
def test_svd_flip_of_complex_singular_vectors(dtype, chunks):
    """Complex svd with its default svd_flip (numpy's complex order decides
    the sign of each pair): numpy's magnitudes and singular values, a
    reconstruction, and every row of vh summing to a value >= 0 in numpy's
    order."""
    x = sample((60, 7), dtype, seed=11)
    u, s, vh = tda.compute(*tda.linalg.svd(tda.from_array(x, chunks=chunks)))
    check_svd(u, s, vh, x)
    nu, ns, nvh = np.linalg.svd(x.astype(np.complex128), full_matrices=False)
    close(np.abs(u), np.abs(nu), dtype, "|u|")
    close(np.abs(vh), np.abs(nvh), dtype, "|vh|")
    assert np.greater_equal(vh.sum(axis=1), 0).all()
    # u-based: each column of u sums to a value >= 0
    fu, fvh = tda.compute(*tda.linalg.svd_flip(tda.from_array(u, chunks=(15, 7)), tda.from_array(vh, chunks=7),
                                               u_based_decision=True))
    assert np.greater_equal(fu.sum(axis=0), 0).all()
    check_svd(fu, s, fvh, x)


def test_svd_compute_uv_false_and_errors():
    x = sample((200, 8), "float64", seed=6)
    s = tda.linalg.svd(tda.from_array(x, chunks=(50, 8)), compute_uv=False)
    close_s(s.compute(), np.linalg.svd(x, compute_uv=False), "float64")
    s2 = tda.linalg.svd(tda.from_array(x, chunks=(50, 8)), full_matrices=True, compute_uv=False)
    close_s(s2.compute(), np.linalg.svd(x, compute_uv=False), "float64")
    with pytest.raises(ValueError, match="must be 2D"):
        tda.linalg.svd(tda.from_array(np.ones(5), chunks=5))
    with pytest.raises(NotImplementedError, match="full_matrices=True"):
        tda.linalg.svd(tda.from_array(x, chunks=(50, 8)), full_matrices=True)
    with pytest.raises(NotImplementedError, match="chunked along both axes"):
        tda.linalg.svd(tda.from_array(x, chunks=(50, 4)))


def test_svd_flip_u_based_and_v_based():
    x = sample((300, 5), "float64", seed=7)
    u, s, vh = np.linalg.svd(x, full_matrices=False)
    for based in (False, True):
        tu, tv = tda.linalg.svd_flip(tda.from_array(u, chunks=(100, 5)), tda.from_array(vh, chunks=5),
                                     u_based_decision=based)
        ju, jv = jld.svd_flip(jda.from_array(u, chunks=(100, 5)), jda.from_array(vh, chunks=5),
                              u_based_decision=based)
        tu, tv = tda.compute(tu, tv)
        np.testing.assert_array_equal(tu, ju.compute())
        np.testing.assert_array_equal(tv, jv.compute())
        side = tu.sum(axis=0) if based else tv.sum(axis=1)
        assert (side >= 0).all()


def test_svd_unknown_row_chunks():
    x = sample((64, 8), "float64", seed=8)
    nan = float("nan")
    t = tda.map_blocks(lambda b: b, tda.from_array(x, chunks=(16, 8)), chunks=((nan,) * 4, (8,)), dtype=x.dtype)
    j = jda.map_blocks(lambda b: b, jda.from_array(x, chunks=(16, 8)), chunks=((nan,) * 4, (8,)), dtype=x.dtype)
    tq, tr = tda.linalg.qr(t)
    jq, jr = jda.linalg.qr(j)
    assert tq.chunks == jq.chunks == ((nan,), (8,)) or np.isnan(tq.chunks[0][0])
    assert tr.chunks == ((8,), (8,))
    q, r = tda.compute(tq, tr)
    close(q, jq.compute(), "float64", "q")
    close(r, jr.compute(), "float64", "r")
    tu = tda.linalg.svd(t)[0]
    assert len(tu.chunks[0]) == 1 and np.isnan(tu.chunks[0][0])
    check_svd(*tda.compute(*tda.linalg.svd(t)), x)


def test_one_compute_factors_once():
    x = sample((2000, 16), "float32", seed=9)
    u, s, vh = tpipes.tall_skinny_svd(chunk_rows=250, x_np=x)
    before = tld.FACTORIZATIONS
    tda.compute(u, s, vh)
    assert tld.FACTORIZATIONS - before == 1
    q, r = tda.linalg.qr(tda.from_array(x, chunks=(250, 16)))
    before = tld.FACTORIZATIONS
    tda.compute(q, r)
    assert tld.FACTORIZATIONS - before == 1
    a = sample((48, 48), "float64", seed=10)
    p, l, uu = tda.linalg.lu(tda.from_array(a, chunks=16))
    before = tld.FACTORIZATIONS
    tda.compute(p, l, uu)
    assert tld.FACTORIZATIONS - before == 1
    before = tld.FACTORIZATIONS
    tda.compute(*tda.linalg.lstsq(tda.from_array(a, chunks=48), tda.from_array(a[:, 0], chunks=48)))
    assert tld.FACTORIZATIONS - before == 1
    # each output alone factors again: the sharing is per walk
    before = tld.FACTORIZATIONS
    s.compute()
    vh.compute()
    assert tld.FACTORIZATIONS - before == 2


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tall_skinny_svd_pipeline(dtype):
    x = sample((2000, 16), dtype, seed=11)
    t = tda.compute(*tpipes.tall_skinny_svd(chunk_rows=250, x_np=x))
    j = jda.compute(*jda.linalg.svd(jda.from_array(x, chunks=(250, 16))))
    check_svd(*t, x)
    close_s(t[1], j[1], dtype)
    close(t[0], j[0], dtype, "u")
    close(t[2], j[2], dtype, "vh")


# -- qr ---------------------------------------------------------------------------


@pytest.mark.parametrize("values", METHODS[:2] + [METHODS[4]], ids=["cholqr2", "householder", "eigh-clamp"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tsqr_against_jax(values, dtype):
    x = sample((2000, 16), dtype, seed=12)
    tq, tr = tda.compute(*tda.linalg.tsqr(tda.from_array(x, chunks=(250, 16))))
    # qr of a row-chunked array is this tsqr
    qq, qr_ = tda.compute(*tda.linalg.qr(tda.from_array(x, chunks=(250, 16))))
    with jda.config.set(values):
        jq, jr = jda.compute(*jda.linalg.tsqr(jda.from_array(x, chunks=(250, 16))))
    # R with a non-negative diagonal is unique: the factors agree as values
    close(tq, jq, dtype, "q")
    close(tr, jr, dtype, "r")
    np.testing.assert_array_equal(qq, tq)
    np.testing.assert_array_equal(qr_, tr)
    tol = 20 * eps(dtype) * 16
    assert np.linalg.norm(tq @ tr - x) / np.linalg.norm(x) < tol
    assert np.abs(tq.T @ tq - np.eye(16)).max() < tol
    np.testing.assert_array_equal(np.tril(tr, -1), 0)


def test_tsqr_short_tail_block():
    # 37 rows in blocks of 16: the JAX package's householder method slices
    # its stacked Q at cumulative offsets; CholeskyQR3 sees one panel
    x = sample((37, 8), "float64", seed=13)
    tq, tr = tda.compute(*tda.linalg.tsqr(tda.from_array(x, chunks=(16, 8))))
    with jda.config.set({"tpu.qr-method": "householder"}):
        jq, jr = jda.compute(*jda.linalg.tsqr(jda.from_array(x, chunks=(16, 8))))
    close(tq, jq, "float64", "q")
    close(tr, jr, "float64", "r")


@pytest.mark.parametrize("cond", [1e4, 1e8, 1e12], ids=lambda c: f"cond{c:.0e}")
def test_tsqr_ill_conditioned_stays_orthogonal(cond):
    # shifted CholeskyQR3 keeps Q orthogonal up to cond ~ 1/eps, so the port
    # needs no Householder method for such panels
    rng = np.random.default_rng(33)
    u, _ = np.linalg.qr(rng.standard_normal((2000, 16)))
    v, _ = np.linalg.qr(rng.standard_normal((16, 16)))
    x = (u * np.logspace(0, -np.log10(cond), 16)) @ v.T
    tq, tr = tda.compute(*tda.linalg.tsqr(tda.from_array(x, chunks=(250, 16))))
    tol = 20 * eps("float64") * 16
    assert np.abs(tq.T @ tq - np.eye(16)).max() < tol
    assert np.linalg.norm(tq @ tr - x) / np.linalg.norm(x) < tol
    with jda.config.set({"tpu.qr-method": "householder"}):
        jq, jr = jda.compute(*jda.linalg.tsqr(jda.from_array(x, chunks=(250, 16))))
    close(tr, jr, "float64", "r")


def test_tsqr_short_input_and_full_vh():
    x = sample((8, 16), "float64", seed=14)
    tq, tr = tda.compute(*tda.linalg.tsqr(tda.from_array(x, chunks=(4, 16))))
    np.testing.assert_allclose(tq @ tr, x, atol=1e-12)
    np.testing.assert_allclose(tq.T @ tq, np.eye(8), atol=1e-12)
    t = tda.linalg.tsqr(tda.from_array(x, chunks=(4, 16)), compute_svd=True)
    assert [a.shape for a in t] == [(8, 8), (8,), (16, 16)]
    u, s, vh = tda.compute(*t)
    assert vh.shape == (16, 16)  # the full right factor, as the metadata says
    np.testing.assert_allclose(vh @ vh.T, np.eye(16), atol=1e-12)
    np.testing.assert_allclose((u * s) @ vh[:8], x, atol=1e-12)
    js = jda.linalg.tsqr(jda.from_array(x, chunks=(4, 16)), compute_svd=True)[1].compute()
    close_s(s, js, "float64")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_qr_paths(dtype):
    # single block, sfqr (one row block), BlockedQR (a 2-D grid)
    cases = [((48, 20), (48, 20)), ((16, 200), (16, 50)), ((64, 48), (16, 16))]
    for shape, chunks in cases:
        x = sample(shape, dtype, seed=15)
        t = tda.linalg.qr(tda.from_array(x, chunks=chunks))
        j = jda.linalg.qr(jda.from_array(x, chunks=chunks))
        for a, b in zip(t, j):
            assert a.chunks == b.chunks and a.dtype == b.dtype and a.expr._name.split("-")[0]
        tq, tr = tda.compute(*t)
        jq, jr = jda.compute(*j)
        k = min(shape)
        tol = 20 * eps(dtype) * k
        assert np.linalg.norm(tq @ tr - x) / np.linalg.norm(x) < tol
        assert np.abs(tq.T @ tq - np.eye(k)).max() < tol
        # LAPACK's Householder signs may differ from XLA's: fix R's diagonal
        ts = np.sign(np.diagonal(tr))
        js = np.sign(np.diagonal(jr))
        close(tq * ts, jq * js, dtype, f"q {shape}")
        close(tr * ts[:, None], jr * js[:, None], dtype, f"r {shape}")


def test_qr_errors():
    x = sample((64, 48), "float64")
    with pytest.raises(ValueError, match="2-D"):
        tda.linalg.qr(tda.from_array(np.ones(4), chunks=2))
    with pytest.raises(NotImplementedError, match="mode='complete'"):
        tda.linalg.qr(tda.from_array(x, chunks=16), mode="complete")
    with pytest.raises(NotImplementedError, match="SHORT-FAT"):
        tda.linalg.qr(tda.from_array(x.T.copy(), chunks=16))
    with pytest.raises(ValueError, match="one column block"):
        tda.linalg.tsqr(tda.from_array(x, chunks=16))
    with pytest.raises(ValueError, match="single row block"):
        tda.linalg.sfqr(tda.from_array(x.T.copy(), chunks=16))


# -- lu, cholesky ---------------------------------------------------------------------


def lu_forward_bound(l, u, dtype):
    """Entrywise bounds on the distance between two computed LU factors of
    one matrix with the same pivots.  Each computation is exact for A + E
    with |E| <= gamma_n |L||U| (gamma_n = n eps / (1 - n eps)); to first
    order dL = L tril(L^-1 dA U^-1, -1) and dU = triu(L^-1 dA U^-1) U, so
    with dA = E1 - E2 the bounds are |L| tril(M, -1) and triu(M) |U| for
    M = |L^-1| 2 gamma_n |L||U| |U^-1|, computed in float64.  Block-local
    pivoting (4x4 strips) lets L grow to hundreds, and the bound grows with
    it, where a fixed share of max|L| does not."""
    l, u = np.asarray(l, np.float64), np.asarray(u, np.float64)
    n = l.shape[0]
    gamma = n * eps(dtype) / (1 - n * eps(dtype))
    m = np.abs(np.linalg.inv(l)) @ (2 * gamma * np.abs(l) @ np.abs(u)) @ np.abs(np.linalg.inv(u))
    return np.abs(l) @ np.tril(m, -1), np.triu(m) @ np.abs(u)


@pytest.mark.parametrize(
    "n, chunks",
    [(48, (16, 16)), (48, (48, 48)), (68, (4, 4)), (54, ((2,) * 17 + (20,),) * 2), (40, ((10, 30), (20, 20)))],
    ids=["blocked", "in-core", "strips", "irregular-in-core", "misaligned"],
)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lu_against_jax(n, chunks, dtype):
    a = sample((n, n), dtype, seed=16)
    t = tda.linalg.lu(tda.from_array(a, chunks=chunks))
    j = jda.linalg.lu(jda.from_array(a, chunks=chunks))
    for x, y in zip(t, j):
        assert x.chunks == y.chunks and x.dtype == y.dtype
    tp, tl, tu = tda.compute(*t)
    jp, jl, ju = jda.compute(*j)
    np.testing.assert_array_equal(tp, jp)  # block-local pivots: P exact
    bl, bu = lu_forward_bound(jl, ju, dtype)
    assert np.all(np.abs(tl.astype(np.float64) - jl) <= bl), "l"
    assert np.all(np.abs(tu.astype(np.float64) - ju) <= bu), "u"
    np.testing.assert_allclose(tp @ tl @ tu, a, atol=200 * eps(dtype) * n * float(np.abs(a).max()))
    np.testing.assert_array_equal(np.triu(tl, 1), 0)
    np.testing.assert_array_equal(np.tril(tu, -1), 0)


def test_lu_errors_and_pivoted_lu():
    with pytest.raises(ValueError, match="square"):
        tda.linalg.lu(tda.from_array(np.ones((4, 6)), chunks=2))
    a = sample((12, 12), "float64", seed=17)
    p, l, u = tld._pivoted_lu(torch.from_numpy(a))
    jp, jl, ju = (np.asarray(v) for v in jld._pivoted_lu(jda.asarray(a).compute()))
    np.testing.assert_array_equal(p.numpy(), jp)
    close(l.numpy(), jl, "float64", "l")
    close(u.numpy(), ju, "float64", "u")
    lp, ll, lu_ = torch.linalg.lu(torch.from_numpy(a))
    np.testing.assert_array_equal(p.numpy(), lp.numpy())
    # float16 blocks take the plain-torch LU
    assert tld._lu_block_fn(torch.float16) is tld._pivoted_lu
    assert tld._lu_block_fn(torch.float64) is torch.linalg.lu


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64", "complex128"])
def test_cholesky_against_jax(lower, dtype):
    a = spd(40, dtype, seed=18)
    t = tda.linalg.cholesky(tda.from_array(a, chunks=20), lower=lower)
    j = jda.linalg.cholesky(jda.from_array(a, chunks=20), lower=lower)
    assert t.dtype == j.dtype and t.shape == j.shape
    got = t.compute()
    close(got, j.compute(), dtype, "chol")
    want = np.linalg.cholesky(a.astype(np.complex128 if dtype == "complex128" else np.float64))
    close(got, want if lower else want.conj().T, dtype, "numpy")


def test_cholesky_not_positive_definite_is_nan_and_errors():
    a = -np.eye(6)
    t = tda.linalg.cholesky(tda.from_array(a, chunks=3), lower=True).compute()
    j = jda.linalg.cholesky(jda.from_array(a, chunks=3), lower=True).compute()
    # JAX's value: NaN on and below the diagonal, 0 above
    np.testing.assert_array_equal(t, np.asarray(j))
    assert np.isnan(t[np.tril_indices(6)]).all() and (np.triu(t, 1) == 0).all()
    with pytest.raises(ValueError, match="square"):
        tda.linalg.cholesky(tda.from_array(np.ones((4, 6)), chunks=2))


# -- solve, solve_triangular, inv, lstsq -----------------------------------------------


@pytest.mark.parametrize("kind", ["gen", "pos", "blocked"])
@pytest.mark.parametrize("rhs", ["vector", "matrix"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_solve_against_jax(kind, rhs, dtype):
    n = 48
    a = spd(n, dtype, seed=19) if kind == "pos" else sample((n, n), dtype, seed=19) + n * np.eye(n, dtype=dtype)
    b = sample((n,) if rhs == "vector" else (n, 3), dtype, seed=20)
    chunks = 16 if kind == "blocked" else n
    bchunks = (chunks,) if rhs == "vector" else (chunks, 3)
    kw = {"assume_a": "pos"} if kind == "pos" else {}
    t = tda.linalg.solve(tda.from_array(a, chunks=chunks), tda.from_array(b, chunks=bchunks), **kw)
    j = jda.linalg.solve(jda.from_array(a, chunks=chunks), jda.from_array(b, chunks=bchunks), **kw)
    assert t.dtype == j.dtype and t.shape == j.shape
    got = t.compute()
    close(got, j.compute(), dtype, "x")
    close(got, np.linalg.solve(a.astype(np.float64), b.astype(np.float64)), dtype, "numpy")


@pytest.mark.parametrize("trans", [0, 1, 2, "T", "C"])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("chunks", [16, 48], ids=["blocked", "single"])
def test_solve_triangular_against_jax(trans, lower, unit, chunks):
    n = 48
    dtype = "complex128"
    a = sample((n, n), dtype, seed=21) / np.sqrt(n) + 2 * np.eye(n)  # well conditioned
    a = np.tril(a) if lower else np.triu(a)
    b = sample((n, 2), dtype, seed=22)
    t = tda.linalg.solve_triangular(tda.from_array(a, chunks=chunks), tda.from_array(b, chunks=(chunks, 2)),
                                    lower=lower, trans=trans, unit_diagonal=unit)
    j = jda.linalg.solve_triangular(jda.from_array(a, chunks=chunks), jda.from_array(b, chunks=(chunks, 2)),
                                    lower=lower, trans=trans, unit_diagonal=unit)
    got = t.compute()
    close(got, j.compute(), dtype, "x")
    m = a.copy()
    if unit:
        np.fill_diagonal(m, 1)
    op = {0: m, 1: m.T, 2: m.conj().T, "T": m.T, "C": m.conj().T}[trans]
    close(op @ got, b, dtype, "residual")


def test_solve_triangular_vector_rhs_real():
    a = np.triu(sample((30, 30), "float64", seed=23)) + 5 * np.eye(30)
    b = sample((30,), "float64", seed=24)
    for chunks in (10, 30):
        got = tda.linalg.solve_triangular(tda.from_array(a, chunks=chunks), tda.from_array(b, chunks=chunks)).compute()
        close(got, np.linalg.solve(a, b), "float64", "x")


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex128", "int64"])
def test_inv_against_jax(dtype):
    rng = np.random.default_rng(25)
    if dtype == "int64":
        a = rng.integers(-3, 4, size=(20, 20)) + 20 * np.eye(20, dtype=np.int64)
    else:
        a = sample((20, 20), dtype, seed=25) + 8 * np.eye(20)
    t = tda.linalg.inv(tda.from_array(a, chunks=10))
    j = jda.linalg.inv(jda.from_array(a, chunks=10))
    assert t.dtype == j.dtype
    got = t.compute()
    out_dt = "float64" if dtype == "int64" else dtype
    close(got, j.compute(), out_dt, "inv")
    close(got, np.linalg.inv(a), out_dt, "numpy")
    with pytest.raises(ValueError, match="square"):
        tda.linalg.inv(tda.from_array(np.ones((4, 6)), chunks=2))


@pytest.mark.parametrize("rank_deficient", [False, True])
@pytest.mark.parametrize("rhs", ["vector", "matrix"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lstsq_all_four_outputs(rank_deficient, rhs, dtype):
    a = sample((60, 8), dtype, seed=26)
    if rank_deficient:
        a[:, 7] = a[:, 0] + a[:, 1]
    b = sample((60,) if rhs == "vector" else (60, 3), dtype, seed=27)
    t = tda.linalg.lstsq(tda.from_array(a, chunks=(20, 8)), tda.from_array(b, chunks=20))
    j = jda.linalg.lstsq(jda.from_array(a, chunks=(20, 8)), jda.from_array(b, chunks=20))
    for x, y in zip(t, j):
        assert x.dtype == y.dtype and x.shape == y.shape
    x, resid, rank, sv = tda.compute(*t)
    jx, jresid, jrank, jsv = jda.compute(*j)
    nx, nresid, nrank, nsv = np.linalg.lstsq(a, b, rcond=None)
    assert x.dtype == nx.dtype and sv.dtype == nsv.dtype
    assert int(rank) == int(nrank)
    if dtype == "float64":
        assert int(rank) == (7 if rank_deficient else 8)
    close_s(sv, nsv, dtype)
    close_s(sv, jsv, dtype)
    if not rank_deficient:
        close(x, nx, dtype, "x")
        close(x, jx, dtype, "x jax")
        assert int(rank) == int(jrank)
    elif dtype == "float64":
        # rank 7 of 8: the minimum-norm solution
        close(x, nx, dtype, "x")
        close(x, jx, dtype, "x jax")
    if nresid.size:
        close(resid, nresid, dtype, "numpy residuals")
    else:
        # numpy gives none for a rank-deficient system: |b - a x|^2 of its x
        want = np.linalg.norm(b.reshape(60, -1) - a @ nx.reshape(8, -1), axis=0) ** 2
        close(resid, want, dtype, "residuals")


# -- norm ---------------------------------------------------------------------------------


VECTOR_ORDS = [None, 2, np.inf, -np.inf, 0, 1, 3, -1]
MATRIX_ORDS = [None, "fro", "nuc", 2, -2, 1, -1, np.inf, -np.inf]


@pytest.mark.parametrize("ord", VECTOR_ORDS, ids=str)
@pytest.mark.parametrize("keepdims", [False, True])
def test_norm_vector_ords(ord, keepdims):
    x = sample((30, 20), "float64", seed=28)
    x[3, 4] = 0.0
    t = tda.linalg.norm(tda.from_array(x, chunks=(10, 5)), ord=ord, axis=1, keepdims=keepdims)
    j = jda.linalg.norm(jda.from_array(x, chunks=(10, 5)), ord=ord, axis=1, keepdims=keepdims)
    got = t.compute()
    assert got.dtype == j.dtype
    close(got, j.compute(), "float64", "jax")
    close(got, np.linalg.norm(x, ord=ord, axis=1, keepdims=keepdims), "float64", "numpy")


@pytest.mark.parametrize("ord", MATRIX_ORDS, ids=str)
@pytest.mark.parametrize("chunks", [(10, 20), (10, 5)], ids=["row-chunked", "grid"])
@pytest.mark.parametrize("keepdims", [False, True])
def test_norm_matrix_ords(ord, chunks, keepdims):
    x = sample((30, 20), "float64", seed=29)
    t = tda.linalg.norm(tda.from_array(x, chunks=chunks), ord=ord, axis=(0, 1), keepdims=keepdims)
    j = jda.linalg.norm(jda.from_array(x, chunks=chunks), ord=ord, axis=(0, 1), keepdims=keepdims)
    got = np.asarray(t.compute())
    close(got, np.asarray(j.compute()), "float64", "jax")
    close(got, np.linalg.norm(x, ord=ord, axis=(0, 1), keepdims=keepdims), "float64", "numpy")


def test_norm_defaults_and_errors():
    x = sample((4, 5, 6), "float64", seed=30)
    d = tda.from_array(x, chunks=2)
    close(tda.linalg.norm(d).compute(), np.linalg.norm(x), "float64", "all")
    close(tda.linalg.norm(d, ord="fro", axis=(1, 2)).compute(), np.linalg.norm(x, ord="fro", axis=(1, 2)),
          "float64", "stacked fro")
    close(tda.linalg.norm(d[0], ord=2).compute(), np.linalg.norm(x[0], ord=2), "float64", "2-D, axis None")
    close(tda.linalg.norm(d[0], ord=np.inf, keepdims=True).compute(),
          np.linalg.norm(x[0], ord=np.inf, keepdims=True), "float64", "2-D inf, keepdims")
    v = sample((50,), "float32", seed=31)
    close(tda.linalg.norm(tda.from_array(v, chunks=10), ord=1).compute(), np.linalg.norm(v, ord=1), "float32", "1")
    with pytest.raises(ValueError, match="Invalid norm order"):
        tda.linalg.norm(d[0], ord="bad", axis=(0, 1))
    with pytest.raises(ValueError, match="Improper number of dimensions"):
        tda.linalg.norm(d, ord=2, axis=(0, 1, 2))
    with pytest.raises(NotImplementedError, match="stacked matrices"):
        tda.linalg.norm(d, ord="nuc", axis=(1, 2))


def int_norm_data(dtype):
    """Integers whose squares overflow their dtype (and int64): up to 2**30
    for 32-bit types, 2**61 for 64-bit."""
    rng = np.random.default_rng(32)
    top = 2**30 if np.dtype(dtype).itemsize == 4 else 2**61
    lo = 0 if np.dtype(dtype).kind == "u" else -top
    return rng.integers(lo, top, (6, 5), dtype=np.int64 if lo else np.uint64).astype(dtype)


@pytest.mark.parametrize("dtype", ["int32", "int64", "uint32", "uint64"])
@pytest.mark.parametrize("ord, axis", [(o, (0, 1)) for o in MATRIX_ORDS] + [(o, 1) for o in VECTOR_ORDS] +
                         [(None, None)], ids=str)
def test_norm_of_integers_in_float64_like_numpy(dtype, ord, axis):
    """numpy converts integers to float64 before any square or sum: every
    ord gives float64 (``ord=1``/``inf`` too), nothing wraps.  The JAX
    package computes in the integers: it agrees with numpy on the count
    (``ord=0``) and differs, or refuses a negative power, on every other
    ord (each checked)."""
    x = int_norm_data(dtype)
    want = np.linalg.norm(x, ord=ord, axis=axis)
    got = np.asarray(tda.linalg.norm(tda.from_array(x, chunks=(4, 2)), ord=ord, axis=axis).compute())
    assert got.dtype == want.dtype == np.float64
    close(got, want, "float64", "numpy")
    try:
        ref = np.asarray(jda.linalg.norm(jda.from_array(x, chunks=(4, 2)), ord=ord, axis=axis).compute())
    except TypeError:
        assert ord == -1 and axis == 1
        return
    agrees = ref.dtype == want.dtype and np.allclose(ref, want, rtol=1e-10)
    assert agrees == (ord == 0 and axis == 1)


# -- config ------------------------------------------------------------------------------


def test_config_from_reference_drops_the_decomposition_keys():
    values = {"tpu.qr-method": "householder", "tpu.svd-method": "jacobi", "tpu.qr-gram": "eigh-clamp",
              "tpu.tsqr-svd": "barrier", "tpu.gram-precision": "high", "tpu.prng-impl": "rbg"}
    assert tconfig.from_reference(values) == {}
    for key in ("qr-method", "svd-method", "qr-gram", "tsqr-svd", "gram-precision"):
        assert tconfig.get(key) is None
