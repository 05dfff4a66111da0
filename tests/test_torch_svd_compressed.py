"""The port's randomized SVD against the JAX package and numpy, on the CPU.

``svd_compressed`` samples a range panel from ``da.random``, so the port's
panel is not the JAX package's.  On an input of exact rank k with distinct
singular values the range is found exactly either way, and after
``svd_flip`` the top k triplets are unique: there the port's u, s and vh
equal the JAX package's and numpy's at rtol 1e-8 (relative to each
factor's largest magnitude), for both iterators with ``n_power_iter`` 0
and 2.  An input of rank r < k has only r unique triplets; the rest of s
is rounding (under 1e-8 of s_max).

In float32, with singular values spread over 10^2, the port's s error
against numpy (float64) is no worse than the JAX package's, up to
float32's rounding: port error <= max(JAX error, 2**-20) relative to
s_max.  Power iteration conditions the panel by the spread to the power
2p + 1, so those cases are the ones float32 can keep: ``n_power_iter`` 0
with either iterator, and 2 with the QR iterator, which re-orthonormalizes
every half step.

The svd that ``chip_smoke.py`` holds svd_compressed against, of a float32
panel of rank 8 plus 1e-4 noise, keeps every singular value within rtol
1e-3 of numpy's (float64), where the JAX package's small ones are
rounding noise (``KNOWN_REFERENCE_FAULTS``); and a panel with an exactly
zero column, where a CholeskyQR pass fails, factors through Householder's
QR to numpy's values (rtol 1e-12 in float64, 1e-5 in float32), where the
JAX package's factors are NaN.
"""

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.ops import _fancy_indexing

torch.set_num_threads(1)

M, N, K = 2000, 300, 10


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


def low_rank(svals, dtype, seed=0, m=M, n=N):
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, len(svals))))
    v, _ = np.linalg.qr(rng.standard_normal((n, len(svals))))
    return ((u * svals) @ v.T).astype(dtype)


def flipped_numpy_svd(x):
    """numpy's thin SVD with the port's sign rule: each row of vh sums >= 0."""
    u, s, vh = np.linalg.svd(x.astype(np.float64), full_matrices=False)
    signs = np.where(vh.sum(axis=1) >= 0, 1.0, -1.0)
    return u * signs, s, vh * signs[:, None]


def close(got, want, rtol, what):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()), err_msg=what)


def run(mod, x, k, **kw):
    return mod.compute(*mod.linalg.svd_compressed(mod.from_array(x, chunks=(250, x.shape[1])), k, **kw))


@pytest.mark.parametrize("iterator", ["power", "QR"])
@pytest.mark.parametrize("n_power_iter", [0, 2])
def test_exact_rank_k_equals_the_reference_and_numpy(iterator, n_power_iter):
    x = low_rank(np.linspace(10.0, 1.0, K), np.float64)
    want = [w[..., :K] if i == 0 else w[:K] for i, w in enumerate(flipped_numpy_svd(x))]
    got = run(tda, x, K, iterator=iterator, n_power_iter=n_power_iter, seed=0)
    ref = run(jda, x, K, iterator=iterator, n_power_iter=n_power_iter, seed=0)
    for name, g, r, w in zip(("u", "s", "vh"), got, ref, want):
        assert g.dtype == np.float64 and r.dtype == np.float64
        close(g, w, 1e-8, f"port {name}")
        close(r, w, 1e-8, f"JAX package {name}")
        close(g, r, 1e-8, f"port against JAX package {name}")


@pytest.mark.parametrize("iterator", ["power", "QR"])
def test_rank_below_k_keeps_its_unique_triplets(iterator):
    r = 6
    x = low_rank(np.linspace(8.0, 2.0, r), np.float64, seed=3)
    u, s, vh = run(tda, x, K, iterator=iterator, n_power_iter=1, seed=2)
    wu, ws, wvh = flipped_numpy_svd(x)
    assert u.shape == (M, K) and s.shape == (K,) and vh.shape == (K, N)
    close(s[:r], ws[:r], 1e-8, "s")
    close(u[:, :r], wu[:, :r], 1e-8, "u")
    close(vh[:r], wvh[:r], 1e-8, "vh")
    assert np.abs(s[r:]).max() <= 1e-8 * ws[0]


@pytest.mark.parametrize("iterator, n_power_iter", [("power", 0), ("QR", 0), ("QR", 2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_float32_is_no_worse_than_the_reference(iterator, n_power_iter, seed):
    x = low_rank(np.logspace(2.0, 0.0, K), np.float32, seed=1)
    want = np.linalg.svd(x.astype(np.float64), compute_uv=False)[:K]
    errors = {}
    for mod in (tda, jda):
        u, s, vh = run(mod, x, K, iterator=iterator, n_power_iter=n_power_iter, seed=seed)
        assert u.dtype == s.dtype == vh.dtype == np.float32
        errors[mod.__name__] = float(np.abs(s - want).max() / want[0])
    assert errors["dask_array_tpu_torch"] <= max(errors["dask_array_tpu"], 2.0**-20), errors


@pytest.mark.parametrize("n", [5, 20, 40, 300])
@pytest.mark.parametrize("q", [1, 5, 10, 25])
@pytest.mark.parametrize("n_oversamples, min_subspace_size", [(10, 20), (0, 0), (3, 8)])
def test_compression_level_equals_the_reference(n, q, n_oversamples, min_subspace_size):
    got = tda.linalg.compression_level(n, q, n_oversamples=n_oversamples, min_subspace_size=min_subspace_size)
    assert got == jda.linalg.compression_level(n, q, n_oversamples=n_oversamples,
                                               min_subspace_size=min_subspace_size)


@pytest.mark.parametrize("iterator, n_power_iter", [("power", 0), ("power", 1), ("QR", 2)])
def test_compression_matrix_has_orthonormal_rows(iterator, n_power_iter):
    x = low_rank(np.linspace(5.0, 1.0, 30), np.float64, seed=4)
    cm = tda.linalg.compression_matrix(tda.from_array(x, chunks=(250, N)), 12, iterator=iterator,
                                       n_power_iter=n_power_iter, seed=1)
    ref = jda.linalg.compression_matrix(jda.from_array(x, chunks=(250, N)), 12, iterator=iterator,
                                        n_power_iter=n_power_iter, seed=1)
    assert cm.shape == ref.shape == (22, M) and cm.dtype == ref.dtype
    q = cm.compute()
    np.testing.assert_allclose(q @ q.T, np.eye(22), rtol=0, atol=1e-12)


def test_a_bad_iterator_raises_the_reference_error():
    x = tda.from_array(low_rank(np.ones(3), np.float64), chunks=(250, N))
    with pytest.raises(ValueError, match="must be 'power' or 'QR', got 'lanczos'"):
        tda.linalg.svd_compressed(x, 3, iterator="lanczos")
    with pytest.raises(ValueError, match="must be 'power' or 'QR', got 'lanczos'"):
        jda.linalg.svd_compressed(jda.from_array(low_rank(np.ones(3), np.float64), chunks=(250, N)), 3,
                                  iterator="lanczos")


def test_a_grid_chunked_along_both_axes_and_the_signs():
    """A 2-D grid of blocks goes through the same pipeline; without
    ``coerce_signs`` the triplets agree with the flipped ones up to one
    sign each."""
    x = low_rank(np.linspace(4.0, 1.0, 8), np.float64, seed=5, n=120)
    d = tda.from_array(x, chunks=(500, 40))
    u, s, vh = tda.compute(*tda.svd_compressed(d, 8, n_power_iter=1, seed=0))
    uf, sf, vhf = tda.compute(*tda.svd_compressed(d, 8, n_power_iter=1, seed=0, coerce_signs=False))
    wu, ws, wvh = flipped_numpy_svd(x)
    close(s, ws[:8], 1e-8, "s")
    close(u, wu[:, :8], 1e-8, "u")
    close(np.abs(vhf), np.abs(wvh[:8]), 1e-8, "|vh| unflipped")
    assert np.all(vh.sum(axis=1) >= 0)


def test_names_are_exported():
    for name in ("svd_compressed", "compression_level", "compression_matrix"):
        assert callable(getattr(tda.linalg, name)) and hasattr(jda.linalg, name)
    assert tda.svd_compressed is tda.linalg.svd_compressed


# the JAX package's differences from numpy that this file proves
KNOWN_REFERENCE_FAULTS = {
    # float32 svd of a numerically rank-deficient tall panel: the eigh of
    # R's Gram in float32 squares cond(R) past 1/eps, so the small singular
    # values come out as rounding noise (74x off here); the port takes
    # that small eigh in float64
    "svd_float32_rank_deficient": "small singular values",
    # svd and qr of a panel with an exactly zero column: the unshifted
    # third CholeskyQR pass fails and every factor is NaN; numpy factors it
    "svd_zero_column": "NaN",
    # svd_compressed of complex input: the JAX package transposes where the
    # conjugate transpose belongs (its s off by a third of s_max here)
    "svd_compressed_complex": "s off",
}


def rank_deficient_float32():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((20000, 8)) @ rng.standard_normal((8, 256)) + 1e-4 * rng.standard_normal((20000, 256))
    return x.astype(np.float32)


def test_svd_of_a_numerically_rank_deficient_float32_panel():
    """A rank-8 float32 panel plus 1e-4 noise.  Every singular value within rtol 1e-3 of numpy's
    (float64), the noise ones included; the top 8 within 2**-20."""
    x = rank_deficient_float32()
    want = np.linalg.svd(x.astype(np.float64), compute_uv=False)
    u, s, vh = tda.compute(*tda.linalg.svd(tda.from_array(x, chunks=(2500, 256))))
    assert s.dtype == np.float32 and np.isfinite(u).all() and np.isfinite(vh).all()
    rel = np.abs(s - want) / want
    assert rel[:8].max() <= 2.0**-20 and rel.max() <= 1e-3, (rel[:8].max(), rel.max())
    got = tda.compute(*tda.svd_compressed(tda.from_array(x, chunks=(2500, 256)), 8, n_power_iter=2, seed=0))[1]
    assert (np.abs(got - s[:8]) / s[:8]).max() <= 1e-3


def zero_column(dtype):
    x = np.random.default_rng(1).standard_normal((2000, 16))
    x[:, 5] = 0.0
    return x.astype(dtype)


@pytest.mark.parametrize("dtype, tol", [("float64", 1e-12), ("float32", 1e-5)])
def test_svd_and_qr_of_a_panel_with_a_zero_column(dtype, tol):
    """A pass's Cholesky fails on the exactly singular Gram; the
    factorization falls back to Householder's QR after one host read of
    R (counted), and gives numpy's singular values."""
    x = zero_column(dtype)
    d = tda.from_array(x, chunks=(500, 16))
    _fancy_indexing.SYNCS = 0
    u, s, vh = tda.compute(*tda.linalg.svd(d))
    assert _fancy_indexing.SYNCS == 1
    want = np.linalg.svd(x.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(s, want, rtol=0, atol=tol * want[0])
    np.testing.assert_allclose((u * s) @ vh, x, rtol=0, atol=tol * want[0])
    q, r = tda.compute(*tda.linalg.qr(d))
    assert np.isfinite(q).all() and (np.diagonal(r) >= 0).all() and np.allclose(np.triu(r), r)
    np.testing.assert_allclose(q @ r, x, rtol=0, atol=tol * want[0])
    np.testing.assert_allclose(q.T @ q, np.eye(16), rtol=0, atol=tol * 16)


@pytest.mark.parametrize("name", sorted(KNOWN_REFERENCE_FAULTS))
def test_known_reference_faults_are_real(name):
    if name == "svd_compressed_complex":
        z = complex_panel()
        ref = jda.svd_compressed(jda.from_array(z, chunks=(10, 12)), 4, n_power_iter=2, seed=0)[1].compute()
        want = np.linalg.svd(z, compute_uv=False)
        assert np.abs(ref - want[:4]).max() > 1e-3 * want[0]
        return
    if name == "svd_zero_column":
        ref = jda.linalg.svd(jda.from_array(zero_column("float64"), chunks=(500, 16)))[1].compute()
        assert np.isnan(ref).all()
        return
    x = rank_deficient_float32()
    want = np.linalg.svd(x.astype(np.float64), compute_uv=False)
    ref = jda.linalg.svd(jda.from_array(x, chunks=(2500, 256)))[1].compute()
    assert (np.abs(ref[8:] - want[8:]) / want[8:]).max() > 1.0


def complex_panel():
    rng = np.random.default_rng(40)
    return rng.standard_normal((40, 12)) + 1j * rng.standard_normal((40, 12))


@pytest.mark.parametrize("k", [3, 8, 12])
@pytest.mark.parametrize("n_power_iter, iterator", [(0, "power"), (2, "power"), (1, "QR")])
def test_svd_compressed_of_complex_input(k, n_power_iter, iterator):
    """Conjugate transposes: the top k singular values of a 40 x 12
    complex128 matrix to rtol 1e-10 of numpy's, and at k = 12 the factors
    rebuild the input to 1e-10 of its largest value."""
    z = complex_panel()
    u, s, vh = tda.compute(*tda.svd_compressed(tda.from_array(z, chunks=(10, 12)), k, iterator=iterator,
                                               n_power_iter=n_power_iter, seed=0))
    want = np.linalg.svd(z, compute_uv=False)
    assert u.dtype == vh.dtype == np.complex128 and s.dtype == np.float64
    np.testing.assert_allclose(s, want[:k], rtol=1e-10)
    if k == 12:
        assert np.abs((u * s) @ vh - z).max() <= 1e-10 * np.abs(z).max()
    c = tda.linalg.compression_matrix(tda.from_array(z, chunks=(10, 12)), k, seed=0).compute()
    assert c.shape == (min(12, max(20, k + 10)), 40)
    np.testing.assert_allclose(c @ c.conj().T, np.eye(c.shape[0]), atol=1e-12)
