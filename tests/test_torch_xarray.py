"""The xarray chunk manager through the port on the CPU, beside the JAX
package's.

xarray is not installed, so, as the JAX package's tests do, these drive
the manager class (built on the vendored stand-in for xarray's
``ChunkManagerEntrypoint``) through the method surface xarray calls.
Every case of the JAX package's ``tests/test_xarray_manager.py`` and
``tests/test_xarray_scenarios.py`` runs through both packages (the ``pkg``
fixture).  The manager hands numpy callables to ``reduction``, ``scan``,
``map_blocks``, ``blockwise`` and ``apply_gufunc``: in the port they run
in the host lane (``_host.py``), and its ``HOST_CALLS`` is checked
against the blocks they ran on.

Tolerance: float64 values rtol 1e-12 where the JAX test states one, else
``assert_eq``'s (rtol 1e-6); a numpy function on the same blocks gives the
same bytes through both packages.
"""

import importlib

import numpy as np
import pytest
import torch

from dask_array_tpu_torch import _host
from dask_array_tpu_torch import config as tconfig

torch.set_num_threads(1)

ROOTS = {"port": "dask_array_tpu_torch", "jax": "dask_array_tpu"}


class Pkg:
    def __init__(self, which):
        self.which = which
        self.root = ROOTS[which]
        self.da = importlib.import_module(self.root)
        self.assert_eq = importlib.import_module(f"{self.root}._test_utils").assert_eq
        self.Array = self.mod("_collection").Array
        self.manager = self.mod("_xarray").make_manager_class()()

    def mod(self, path):
        return importlib.import_module(f"{self.root}.{path}")


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


@pytest.fixture(params=sorted(ROOTS))
def pkg(request):
    return Pkg(request.param)


@pytest.fixture
def rng():
    return np.random.default_rng(31)


def _contains_expr_type(expr, typ):
    return any(isinstance(n, typ) for n in expr.walk())


# ---------------------------------------------------------------------------
# tests/test_xarray_manager.py
# ---------------------------------------------------------------------------


def test_manager_constructible_without_xarray(pkg):
    assert pkg.manager.array_cls is pkg.Array
    assert pkg.manager.available


def test_manager_names_its_package():
    assert type(Pkg("port").manager).__name__ == "DaskArrayTpuTorchManager"


def test_is_chunked_array(pkg, rng):
    x = rng.standard_normal((4, 4))
    assert not pkg.manager.is_chunked_array(x)
    assert pkg.manager.is_chunked_array(pkg.da.from_array(x, chunks=2))


def test_chunk_sequence(pkg, rng):
    m = pkg.manager
    x = rng.standard_normal((12, 8))
    norm = m.normalize_chunks((4, "auto"), shape=x.shape, dtype=x.dtype)
    assert norm[0] == (4, 4, 4)
    d = m.from_array(x, norm)
    assert m.is_chunked_array(d) and m.chunks(d) == norm
    pkg.assert_eq(d, x)


def test_rechunk_and_compute(pkg, rng):
    m = pkg.manager
    x = rng.standard_normal((8, 8))
    r = m.rechunk(m.from_array(x, ((4, 4), (8,))), ((8,), (4, 4)))
    assert m.chunks(r) == ((8,), (4, 4))
    (out,) = m.compute(r + 1)
    np.testing.assert_allclose(out, x + 1)
    a, b = m.compute(r, np.float64(3.0))
    np.testing.assert_allclose(a, x)
    assert b == 3.0


def test_persist(pkg, rng):
    m = pkg.manager
    x = rng.standard_normal((6,))
    (p,) = m.persist(m.from_array(x, ((3, 3),)) * 2)
    assert m.is_chunked_array(p)
    pkg.assert_eq(p, x * 2)


def test_apply_gufunc_parallelized(pkg, rng):
    x = rng.standard_normal((6, 10))
    d = pkg.manager.from_array(x, ((3, 3), (10,)))
    _host.HOST_CALLS = 0
    out = pkg.manager.apply_gufunc(lambda a: np.mean(a, axis=-1), "(i)->()", d, output_dtypes=["f8"])
    pkg.assert_eq(out, x.mean(axis=-1))
    if pkg.which == "port":
        assert _host.HOST_CALLS == 2  # one a block


def test_reduction_protocol(pkg, rng):
    x = rng.standard_normal((8, 6))
    d = pkg.manager.from_array(x, ((4, 4), (6,)))
    _host.HOST_CALLS = 0
    out = pkg.manager.reduction(d, np.sum, combine_func=np.sum, aggregate_func=np.sum, axis=(0,), dtype="f8",
                                keepdims=False)
    pkg.assert_eq(out, x.sum(axis=0))
    if pkg.which == "port":
        assert _host.HOST_CALLS == 2 + 1  # a chunk call a block, one aggregate


def test_scan_protocol(pkg, rng):
    x = rng.standard_normal((4, 12))
    d = pkg.manager.from_array(x, ((4,), (4, 4, 4)))
    pkg.assert_eq(pkg.manager.scan(np.cumsum, np.add, 0, d, axis=1, dtype="f8"), np.cumsum(x, axis=1))

    def cummax_f(b, axis=None):
        return np.maximum.accumulate(b, axis=axis)

    _host.HOST_CALLS = 0
    out2 = pkg.manager.scan(cummax_f, np.maximum, -np.inf, d, axis=1)
    pkg.assert_eq(out2, np.maximum.accumulate(x, axis=1))
    if pkg.which == "port":
        assert _host.HOST_CALLS == 3 + 2  # the scan a block, the carry into blocks 1 and 2


def test_map_blocks_and_blockwise(pkg, rng):
    m = pkg.manager
    x = rng.standard_normal((6, 6))
    d = m.from_array(x, ((3, 3), (6,)))
    pkg.assert_eq(m.map_blocks(lambda b: b * 2, d, dtype="f8"), x * 2)
    pkg.assert_eq(m.blockwise(lambda a, b: a + b, "ij", d, "ij", d, "ij", dtype="f8"), x * 2)


def test_unify_chunks(pkg, rng):
    m = pkg.manager
    x = rng.standard_normal((8, 8))
    a = m.from_array(x, ((4, 4), (8,)))
    b = m.from_array(x, ((2,) * 4, (8,)))
    _, (ua, ub) = m.unify_chunks(a, "ij", b, "ij")
    assert ua.chunks == ub.chunks
    pkg.assert_eq(ua + ub, 2 * x)


def test_store_to_zarr(pkg, rng, tmp_path):
    x = rng.standard_normal((8, 4))
    d = pkg.manager.from_array(x, ((4, 4), (4,)))
    z = pkg.mod("io._zarr_lite").open_array(str(tmp_path / "x.zarr"), mode="w", shape=(8, 4), dtype="f8",
                                            chunks=(4, 4))
    pkg.manager.store([d], [z])
    np.testing.assert_array_equal(z[0:8, 0:4], x)


def test_rolling_mean_pipeline(pkg, rng):
    x = rng.standard_normal((5, 40))
    d = pkg.manager.from_array(x, ((5,), (10,) * 4))
    out = pkg.da.sliding_window_view(d, 7, axis=1).mean(axis=-1)
    pkg.assert_eq(out, np.lib.stride_tricks.sliding_window_view(x, 7, axis=1).mean(axis=-1))


def test_groupby_like_pipeline(pkg, rng):
    m = pkg.manager
    x = rng.standard_normal((100,))
    labels = rng.integers(0, 3, size=100)
    d = m.from_array(x, ((25,) * 4,))
    means = [float(d[m.from_array(labels == g, ((25,) * 4,))].mean().compute()) for g in range(3)]
    np.testing.assert_allclose(means, [x[labels == g].mean() for g in range(3)])


def test_register_requires_real_xarray(pkg):
    try:
        import xarray  # noqa: F401

        pytest.skip("real xarray installed; registration covered elsewhere")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="xarray"):
        pkg.mod("xarray").register()


# ---------------------------------------------------------------------------
# tests/test_xarray_scenarios.py
# ---------------------------------------------------------------------------


def _np_rolling(data, window, func, min_count=1, axis=0):
    """bottleneck's rolling: a trailing window ending at each index, NaN
    until ``min_count`` non-NaN values are in view."""
    data = np.moveaxis(data, axis, 0)
    out = np.full(data.shape, np.nan, dtype="f8")
    for i in range(data.shape[0]):
        win = data[max(0, i - window + 1):i + 1]
        cnt = np.sum(~np.isnan(win), axis=0)
        with np.errstate(invalid="ignore"):
            val = func(win, axis=0)
        out[i] = np.where(cnt >= min_count, val, np.nan)
    return np.moveaxis(out, 0, axis)


def test_rolling_full_time_chunk_avoids_padding_rechunk(pkg):
    Rechunk = pkg.mod("_rechunk").Rechunk
    move_sum = pkg.mod("ops._sliding").move_sum
    x = pkg.da.ones((100, 6, 8), chunks=(100, 3, 4))
    r = pkg.da.nanmax(move_sum((x > 0).astype("f8"), 72, min_count=72, axis=0), axis=0)
    assert not _contains_expr_type(r.expr.optimize(), Rechunk)
    np.testing.assert_allclose(r.compute(), np.full((6, 8), 72.0))


def test_rolling_short_first_chunk(pkg, rng):
    n = 30
    data = rng.random((n - 1 + 2 * n, 4))
    x = pkg.da.from_array(data, chunks=((n - 1, n, n), (4,)))
    got = pkg.mod("ops._sliding").move_sum(x, n, min_count=1, axis=0).compute()
    np.testing.assert_allclose(got, _np_rolling(data, n, np.nansum), rtol=1e-12)


@pytest.mark.parametrize("op,np_func", [("sum", np.nansum), ("mean", np.nanmean), ("min", np.nanmin),
                                        ("max", np.nanmax)])
def test_rolling_long_window_keeps_native_chunks(pkg, rng, op, np_func):
    sliding = pkg.mod("ops._sliding")
    Rechunk = pkg.mod("_rechunk").Rechunk
    data = rng.normal(size=(13 * 96, 4))
    data[rng.random(data.shape) < 0.15] = np.nan
    x = pkg.da.from_array(data, chunks=(96, 4))
    window = 480
    lazy = getattr(sliding, f"move_{op}")(x, window, min_count=window, axis=0)
    optimized = lazy.expr.optimize()
    assert _contains_expr_type(optimized, sliding.MovingWindowReduction)
    assert not _contains_expr_type(optimized, Rechunk)
    assert optimized.chunks == x.chunks
    got = lazy.compute()
    want = _np_rolling(data, window, np_func, min_count=window)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10, equal_nan=True)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


def test_rolling_head_slice_inside_first_window(pkg, rng):
    n = 30
    data = rng.random((5 * n, 4))
    x = pkg.da.from_array(data, chunks=((n,) * 5, (4,)))
    got = pkg.mod("ops._sliding").move_sum(x, n, min_count=1, axis=0)[: n - 1].compute()
    np.testing.assert_allclose(got, _np_rolling(data, n, np.nansum)[: n - 1], rtol=1e-12)


def test_rolling_day_slice_rechunk_map_blocks_full_block(pkg):
    """A numpy block function with ``block_info`` sees one full-day block
    (its shape asserted inside); in the port it runs in the host lane."""
    move_sum = pkg.mod("ops._sliding").move_sum
    samples_per_day = 8
    n = 13 * samples_per_day
    step = np.timedelta64(86400 // samples_per_day, "s")
    time = (np.datetime64("2026-06-17") + step + np.arange(n) * step).astype("datetime64[ns]")
    x = pkg.da.ones((n, 2), chunks=(samples_per_day, 2))
    adv = move_sum(x, 5 * samples_per_day, min_count=1, axis=0) * 0.2 + pkg.da.ones((n, 2), chunks=(samples_per_day, 2))
    sel = np.flatnonzero((time >= np.datetime64("2026-06-29")) & (time <= np.datetime64("2026-06-29T23:59:59")))
    arr = adv[sel[0]:sel[-1] + 1][:samples_per_day].rechunk((samples_per_day, 2))

    def write_sentinel(block, block_info=None):
        assert block.shape == (samples_per_day, 2)
        return np.array([[1]], dtype="uint8")

    _host.HOST_CALLS = 0
    out = arr.map_blocks(write_sentinel, dtype="uint8", chunks=((1,), (1,)), meta=np.array((), dtype="uint8"))
    assert arr.chunks == ((samples_per_day,), (2,))
    assert out.chunks == ((1,), (1,))
    np.testing.assert_array_equal(out.compute(), np.array([[1]], dtype="uint8"))
    if pkg.which == "port":
        assert _host.HOST_CALLS == 1


def test_rolling_construct_multi_axis(pkg, rng):
    data = rng.random((12, 10))
    v = pkg.da.sliding_window_view(pkg.da.from_array(data, chunks=(6, 5)), (3, 4), axis=(0, 1))
    want = np.lib.stride_tricks.sliding_window_view(data, (3, 4), axis=(0, 1)).mean(axis=(-2, -1))
    np.testing.assert_allclose(v.mean(axis=(-2, -1)).compute(), want, rtol=1e-12)


def test_groupby_label_means(pkg, rng):
    data = rng.random((24, 5))
    labels = np.repeat(np.arange(4), 6)
    x = pkg.da.from_array(data, chunks=(8, 5))
    outs = []
    for g in range(4):
        mask = pkg.da.from_array((labels == g).astype("f8")[:, None], chunks=(8, 1))
        outs.append((x * mask).sum(axis=0) / mask.sum(axis=0))
    got = np.stack([o.compute() for o in outs])
    np.testing.assert_allclose(got, np.stack([data[labels == g].mean(axis=0) for g in range(4)]), rtol=1e-12)


def test_dataset_multi_variable_one_program(pkg, rng):
    data = rng.random((16, 8))
    x = pkg.da.from_array(data, chunks=(8, 4))
    gu, gv, gw = pkg.da.compute(x.mean(axis=0), x.std(axis=0), (x * 2).sum(axis=1))
    np.testing.assert_allclose(gu, data.mean(axis=0), rtol=1e-12)
    np.testing.assert_allclose(gv, data.std(axis=0), rtol=1e-10)
    np.testing.assert_allclose(gw, (data * 2).sum(axis=1), rtol=1e-12)


def test_manager_conversion_never_computes(pkg, rng, monkeypatch):
    ex = pkg.mod("_executor")

    def boom(*a, **k):
        raise AssertionError("conversion must not compute")

    for name in ("execute", "execute_many", "execute_views"):
        if hasattr(ex, name):
            monkeypatch.setattr(ex, name, boom)
    m = pkg.manager
    out = m.map_blocks(lambda b: b + 1, m.from_array(rng.random((8, 4)), chunks=(4, 2)), dtype="f8")
    _ = m.rechunk(out, (8, 4)) + 1  # graph building only


def test_apply_ufunc_parallelized_multi_output(pkg, rng):
    """Two outputs through ``apply_gufunc``; the function is duck-typed
    (methods of its block), so the port's runs it on torch tensors, where
    ``std``'s correction is spelled out as numpy's."""
    data = rng.random((12, 6))
    arr = pkg.manager.from_array(data, chunks=(6, 6))
    if pkg.which == "port":
        def mean_and_std(block):
            return block.mean(axis=-1), block.std(axis=-1, correction=0)
    else:
        def mean_and_std(block):
            return block.mean(axis=-1), block.std(axis=-1)
    m, s = pkg.manager.apply_gufunc(mean_and_std, "(i)->(),()", arr, output_dtypes=("f8", "f8"))
    np.testing.assert_allclose(np.asarray(pkg.manager.compute(m)[0]), data.mean(axis=1), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(pkg.manager.compute(s)[0]), data.std(axis=1), rtol=1e-10)


def test_apply_ufunc_parallelized_multi_output_of_numpy_functions(pkg, rng):
    """The same with numpy's functions: the port runs them in the host lane
    and gives numpy's bytes, as the JAX package does."""
    data = rng.random((12, 6))
    arr = pkg.manager.from_array(data, chunks=(6, 6))

    def mean_and_std(block):
        return np.mean(block, axis=-1), np.std(block, axis=-1)

    _host.HOST_CALLS = 0
    m, s = pkg.manager.apply_gufunc(mean_and_std, "(i)->(),()", arr, output_dtypes=("f8", "f8"))
    gm, gs = pkg.da.compute(m, s)
    # the JAX package hands numpy its own arrays, which compute their mean
    # and std in XLA: to rtol 1e-12 there, numpy's bytes in the port
    rtol = 0 if pkg.which == "port" else 1e-12
    np.testing.assert_allclose(gm, np.concatenate([np.mean(data[:6], -1), np.mean(data[6:], -1)]), rtol=rtol, atol=0)
    np.testing.assert_allclose(gs, np.concatenate([np.std(data[:6], -1), np.std(data[6:], -1)]), rtol=rtol, atol=0)
    if pkg.which == "port":
        assert _host.HOST_CALLS == 2 * 2  # each output's node, a call a block


def test_zarr_region_write_roundtrip(pkg, rng, tmp_path):
    base = rng.random((12, 8))
    p = str(tmp_path / "region.zarr")
    pkg.da.to_zarr(pkg.da.from_array(base, chunks=(4, 4)), p)
    patch = rng.random((4, 8))
    pkg.da.to_zarr(pkg.da.from_array(patch, chunks=(4, 4)), p, region=(slice(4, 8), slice(0, 8)))
    want = base.copy()
    want[4:8] = patch
    np.testing.assert_array_equal(pkg.da.from_zarr(p).compute(), want)


def test_zarr_day_region_pipeline(pkg, rng, tmp_path):
    p = str(tmp_path / "days.zarr")
    days = [rng.random((4, 6)) for _ in range(3)]
    pkg.da.to_zarr(pkg.da.zeros((12, 6), chunks=(4, 6)), p)
    for i, d in enumerate(days):
        pkg.da.to_zarr(pkg.da.from_array(d, chunks=(4, 6)), p, region=(slice(4 * i, 4 * (i + 1)), slice(0, 6)))
    np.testing.assert_array_equal(pkg.da.from_zarr(p).compute(), np.concatenate(days))


def test_manager_rechunk_metadata(pkg, rng):
    data = rng.random((12, 6))
    out = pkg.manager.rechunk(pkg.manager.from_array(data, chunks=(4, 3)), (6, 6))
    assert out.chunks == ((6, 6), (6,))
    np.testing.assert_array_equal(np.asarray(pkg.manager.compute(out)[0]), data)


# ---------------------------------------------------------------------------
# the manager's numpy callables: the same bytes as the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("func", ["nansum", "sum", "max", "nanmean"])
def test_manager_reduction_of_numpy_functions_matches_the_jax_package(func, rng):
    x = rng.standard_normal((9, 10))
    x[rng.random(x.shape) < 0.1] = np.nan
    f = getattr(np, func)
    got = {}
    for which in ROOTS:
        p = Pkg(which)
        d = p.manager.from_array(x, ((4, 4, 1), (3, 3, 4)))
        got[which] = np.asarray(p.manager.reduction(d, f, combine_func=f, aggregate_func=f, axis=(1,),
                                                    dtype="f8").compute())
    np.testing.assert_array_equal(got["port"], got["jax"])
    partials = np.stack([f(x[:, a:b], axis=1) for a, b in ((0, 3), (3, 6), (6, 10))], axis=1)
    np.testing.assert_array_equal(got["port"], f(partials, axis=1))
