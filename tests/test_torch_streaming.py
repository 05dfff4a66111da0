"""The out-of-core lane through the port on the CPU, beside the JAX package.

Every case of the JAX package's ``tests/test_streaming.py`` runs through
both packages under the same configuration (the JAX package's keys, mapped
by ``config.from_reference``): the values must agree (exactly for
elementwise and layout programs, to rtol 1e-12 for float64 reductions,
whose order of summation differs between torch and XLA; 1e-5 for the
float32 matmul, with atol 1e-5), each package's values must match numpy as the reference
test asks, and the ``STREAMED`` deltas (``count``, ``panels``, ``pinned``)
must be equal.  A masked leaf declines the lane in both packages, and its
mask comes back.

Then the port's own: ``BandStencil``'s slice pushdown at every boundary
mode the band-stencil kernel takes (arbitrary slices and streamed panel
seams equal to numpy and to the in-core result, byte for byte), the
``"auto"`` budget on the CPU, the byte accounting, and the pinned-copy
pieces (``_hostcopy._pieces``) over contiguous and strided arrays.
"""

import importlib

import numpy as np
import pytest
import torch

from dask_array_tpu_torch import config as tconfig

torch.set_num_threads(1)

ROOTS = {"port": "dask_array_tpu_torch", "jax": "dask_array_tpu"}
KEYS = ("count", "panels", "pinned")


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


class Pkg:
    def __init__(self, which):
        self.which = which
        self.da = importlib.import_module(ROOTS[which])
        self.streaming = importlib.import_module(f"{ROOTS[which]}._streaming")

    def config(self, values):
        if self.which == "port":
            return tconfig.set(tconfig.from_reference(values))
        return self.da.config.set(values)

    def force(self):
        return self.config({"tpu.out-of-core": "force"})

    def spy(self, fn):
        st = self.streaming.STREAMED
        before = {k: st[k] for k in KEYS}
        out = fn()
        return out, {k: st[k] - before[k] for k in KEYS}

    def laplace(self):
        if self.which == "port":
            roll = torch.roll
        else:
            import jax.numpy as jnp

            roll = jnp.roll

        def laplace(blk):
            return roll(blk, 1, 0) + roll(blk, -1, 0) + roll(blk, 1, 1) + roll(blk, -1, 1) - 4 * blk

        return laplace


# ---------------------------------------------------------------------------
# the reference's cases: each returns (value, deltas) and checks itself
# ---------------------------------------------------------------------------


def map_stream_elemwise_values_and_panels(p):
    src = np.random.default_rng(0).standard_normal((64, 6))
    x = p.da.from_array(src, chunks=(8, 6))
    with p.force():
        out, d = p.spy(lambda: (x * 2 + 1).compute())
    assert d["count"] == 1 and d["panels"] >= 2
    np.testing.assert_allclose(out, src * 2 + 1, rtol=1e-12)
    assert isinstance(out, np.ndarray)
    return out, d


def map_stream_budget_bounds_panel_height(p):
    src = np.arange(64 * 8, dtype="f8").reshape(64, 8)
    x = p.da.from_array(src, chunks=(4, 8))
    with p.config({"tpu.out-of-core": "force", "tpu.memory-budget": 1536}):
        out, d = p.spy(lambda: (x + 1).compute())
    assert d["panels"] >= 4
    np.testing.assert_array_equal(out, src + 1)
    return out, d


def auto_engages_only_above_budget(p):
    src = np.ones((32, 4))
    x = p.da.from_array(src, chunks=(4, 4))
    with p.config({"tpu.out-of-core": "auto", "tpu.memory-budget": "1 GiB"}):
        _, d0 = p.spy(lambda: (x * 3).compute())
    assert d0["count"] == 0
    with p.config({"tpu.out-of-core": "auto", "tpu.memory-budget": 512}):
        out, d = p.spy(lambda: (x * 3).compute())
    assert d["count"] == 1
    np.testing.assert_array_equal(out, src * 3)
    return out, {k: (d0[k], d[k]) for k in KEYS}


def off_never_engages(p):
    x = p.da.from_array(np.ones((32, 4)), chunks=(4, 4))
    with p.config({"tpu.out-of-core": "off", "tpu.memory-budget": 64}):
        out, d = p.spy(lambda: (x * 3).compute())
    assert d["count"] == 0
    return out, d


def map_stream_matmul_panel_sweep_pins_rhs(p):
    rng = np.random.default_rng(1)
    a_np = rng.standard_normal((96, 24)).astype(np.float32)
    b_np = rng.standard_normal((24, 5)).astype(np.float32)
    a = p.da.from_array(a_np, chunks=(8, 24))
    with p.force():
        out, d = p.spy(lambda: (a @ b_np).compute())
    assert d["count"] == 1 and d["panels"] >= 2 and d["pinned"] >= 1
    np.testing.assert_allclose(out, a_np @ b_np, rtol=1e-4, atol=1e-4)
    return out, d


def map_stream_reduction_over_other_axis(p):
    src = np.random.default_rng(2).standard_normal((48, 16))
    x = p.da.from_array(src, chunks=(6, 8))
    with p.force():
        out, d = p.spy(lambda: x.sum(axis=1).compute())
    assert d["count"] == 1 and d["panels"] >= 2
    np.testing.assert_allclose(out, src.sum(axis=1), rtol=1e-10)
    return out, d


def map_stream_stencil_halos_read_correctly(p):
    src = np.random.default_rng(3).standard_normal((40, 12)).astype("f4")
    x = p.da.from_array(src, chunks=(5, 12))
    st = p.da.map_overlap(p.laplace(), x, depth=1, boundary="reflect", dtype="f4")
    with p.force():
        out, d = p.spy(lambda: st.compute())
    assert d["count"] == 1 and d["panels"] >= 2
    pad = np.pad(src, 1, mode="symmetric")
    want = pad[:-2, 1:-1] + pad[2:, 1:-1] + pad[1:-1, :-2] + pad[1:-1, 2:] - 4 * src
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)
    return out, d


def map_stream_tail_panel(p):
    src = np.random.default_rng(4).standard_normal((30, 4))
    x = p.da.from_array(src, chunks=((8, 8, 8, 6), 4))
    with p.force():
        out, d = p.spy(lambda: (x - 1).compute())
    assert d["count"] == 1
    np.testing.assert_allclose(out, src - 1, rtol=1e-12)
    return out, d


def _reduce_stream_full(kind, np_fn):
    def case(p):
        src = np.random.default_rng(5).standard_normal((40, 6)) * 0.9
        x = p.da.from_array(src, chunks=(5, 6))
        with p.force():
            out, d = p.spy(lambda: getattr(x, kind)().compute())
        assert d["count"] == 1 and d["panels"] >= 2
        np.testing.assert_allclose(float(out), np_fn(src), rtol=1e-8)
        return out, d

    return case


def _reduce_stream_nan_kinds(kind, np_fn):
    def case(p):
        src = np.random.default_rng(6).standard_normal((40, 6))
        src[::3, ::2] = np.nan
        src[0:5] = np.nan  # an all-NaN panel: its partial must lose the combine
        x = p.da.from_array(src, chunks=(5, 6))
        with p.force():
            out, d = p.spy(lambda: getattr(p.da, kind)(x).compute())
        assert d["count"] == 1 and d["panels"] >= 2
        np.testing.assert_allclose(float(out), np_fn(src), rtol=1e-8)
        return out, d

    return case


def reduce_stream_any_all(p):
    src = np.zeros((24, 4), dtype=bool)
    src[17, 2] = True
    x = p.da.from_array(src, chunks=(4, 4))
    with p.force():
        o1, d1 = p.spy(lambda: x.any().compute())
        o2, d2 = p.spy(lambda: x.all().compute())
    assert d1["count"] == 1 and d2["count"] == 1
    assert bool(o1) is True and bool(o2) is False
    return (o1, o2), {k: (d1[k], d2[k]) for k in KEYS}


def reduce_stream_axis0_keeps_columns(p):
    src = np.random.default_rng(7).standard_normal((40, 8))
    x = p.da.from_array(src, chunks=(5, 8))
    with p.force():
        out, d = p.spy(lambda: x.sum(axis=0).compute())
    assert d["count"] == 1 and d["panels"] >= 2
    np.testing.assert_allclose(out, src.sum(axis=0), rtol=1e-10)
    return out, d


def reduce_stream_mean_elemwise_tree(p):
    src = np.random.default_rng(8).standard_normal((36, 4))
    x = p.da.from_array(src, chunks=(6, 4))
    with p.force():
        out, d = p.spy(lambda: ((x * x) + 1).mean().compute())
    assert d["count"] == 1
    np.testing.assert_allclose(float(out), ((src * src) + 1).mean(), rtol=1e-8)
    return out, d


def irregular_grid_declines_but_computes(p):
    src = np.random.default_rng(9).standard_normal((30, 30))
    x = p.da.from_array(src, chunks=((7, 11, 3, 9), (13, 4, 9, 4)))
    with p.force():
        out, d = p.spy(lambda: (x + 2).compute())
    assert d["count"] == 0
    np.testing.assert_allclose(out, src + 2, rtol=1e-12)
    return out, d


def unknown_chunks_decline(p):
    src = np.arange(40.0)
    x = p.da.from_array(src, chunks=(5,))
    with p.force():
        out, d = p.spy(lambda: x[x > 10].compute())
    assert d["count"] == 0
    np.testing.assert_array_equal(out, src[src > 10])
    return out, d


def masked_declines(p):
    src = np.ma.masked_array(np.arange(24.0), np.arange(24) % 5 == 0)
    x = p.da.from_array(src, chunks=(4,))
    with p.force():
        out, d = p.spy(lambda: (x + 1).compute())
    return out, d


def barrier_splits_stream_inside_not_across(p):
    src = np.random.default_rng(10).standard_normal((32, 4))
    x = p.da.from_array(src, chunks=(4, 4))
    y = p.da.barrier(x * 2) + 1
    with p.force():
        assert p.streaming.maybe_stream(y.expr) is None
        out, d = p.spy(lambda: y.compute())
    np.testing.assert_allclose(out, src * 2 + 1, rtol=1e-12)
    return out, d


def var_declines_but_computes(p):
    src = np.random.default_rng(11).standard_normal((32, 4))
    x = p.da.from_array(src, chunks=(4, 4))
    with p.force():
        out, d = p.spy(lambda: x.var().compute())
    assert d["count"] == 0
    np.testing.assert_allclose(float(out), src.var(), rtol=1e-8)
    return out, d


def single_chunk_axis_declines(p):
    src = np.random.default_rng(12).standard_normal((8, 8))
    x = p.da.from_array(src, chunks=(8, 8))
    with p.force():
        out, d = p.spy(lambda: (x * 2).compute())
    assert d["count"] == 0
    np.testing.assert_allclose(out, src * 2, rtol=1e-12)
    return out, d


def memmap_leaf_streams_from_disk(p, tmp_path):
    path = tmp_path / f"big-{p.which}.npy"
    src = np.random.default_rng(13).standard_normal((64, 8))
    np.save(path, src)
    x = p.da.from_array(np.load(path, mmap_mode="r"), chunks=(8, 8))
    with p.force():
        out, d = p.spy(lambda: (x + 0.5).compute())
    assert d["count"] == 1 and d["panels"] >= 2
    np.testing.assert_allclose(out, src + 0.5, rtol=1e-12)
    return out, d


def maybe_stream_none_means_untouched(p):
    x = p.da.from_array(np.ones((4, 4)), chunks=(4, 4))
    with p.force():
        out, d = p.spy(lambda: p.streaming.maybe_stream(x.expr))
    assert out is None
    return out, d


CASES = {
    "map_stream_elemwise_values_and_panels": map_stream_elemwise_values_and_panels,
    "map_stream_budget_bounds_panel_height": map_stream_budget_bounds_panel_height,
    "auto_engages_only_above_budget": auto_engages_only_above_budget,
    "off_never_engages": off_never_engages,
    "map_stream_matmul_panel_sweep_pins_rhs": map_stream_matmul_panel_sweep_pins_rhs,
    "map_stream_reduction_over_other_axis": map_stream_reduction_over_other_axis,
    "map_stream_stencil_halos_read_correctly": map_stream_stencil_halos_read_correctly,
    "map_stream_tail_panel": map_stream_tail_panel,
    **{f"reduce_stream_full[{k}]": _reduce_stream_full(k, f)
       for k, f in [("sum", np.sum), ("prod", np.prod), ("min", np.min), ("max", np.max), ("mean", np.mean)]},
    **{f"reduce_stream_nan_kinds[{k}]": _reduce_stream_nan_kinds(k, f)
       for k, f in [("nansum", np.nansum), ("nanmin", np.nanmin), ("nanmax", np.nanmax), ("nanmean", np.nanmean)]},
    "reduce_stream_any_all": reduce_stream_any_all,
    "reduce_stream_axis0_keeps_columns": reduce_stream_axis0_keeps_columns,
    "reduce_stream_mean_elemwise_tree": reduce_stream_mean_elemwise_tree,
    "irregular_grid_declines_but_computes": irregular_grid_declines_but_computes,
    "unknown_chunks_decline": unknown_chunks_decline,
    "masked_declines": masked_declines,
    "barrier_splits_stream_inside_not_across": barrier_splits_stream_inside_not_across,
    "var_declines_but_computes": var_declines_but_computes,
    "single_chunk_axis_declines": single_chunk_axis_declines,
    "memmap_leaf_streams_from_disk": memmap_leaf_streams_from_disk,
    "maybe_stream_none_means_untouched": maybe_stream_none_means_untouched,
}

# tolerance between the packages, per case (exact where no reduction runs)
RTOL = {
    "map_stream_matmul_panel_sweep_pins_rhs": 1e-5,  # float32 products near 0: atol 1e-5
    "map_stream_reduction_over_other_axis": 1e-12,
    "reduce_stream_axis0_keeps_columns": 1e-12,
    "reduce_stream_mean_elemwise_tree": 1e-12,
    "var_declines_but_computes": 1e-12,
    **{k: 1e-12 for k in CASES if k.startswith("reduce_stream_")},
}


def _run(name, which, tmp_path):
    fn = CASES[name]
    p = Pkg(which)
    return fn(p, tmp_path) if name == "memmap_leaf_streams_from_disk" else fn(p)


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_through_both_packages(name, tmp_path):
    got = {which: _run(name, which, tmp_path) for which in ROOTS}
    (pv, pd), (jv, jd) = got["port"], got["jax"]
    assert pd == jd, (pd, jd)
    if isinstance(jv, np.ma.MaskedArray):
        # a masked leaf declines the lane in both, and keeps its mask
        assert isinstance(pv, np.ma.MaskedArray) and pd["count"] == 0
        np.testing.assert_array_equal(np.ma.getmaskarray(pv), np.ma.getmaskarray(jv))
    if pv is None or jv is None:
        assert pv is None and jv is None
        return
    pv, jv = np.asarray(pv), np.asarray(jv)
    assert pv.shape == jv.shape and pv.dtype == jv.dtype
    rtol = RTOL.get(name)
    if rtol is None:
        np.testing.assert_array_equal(pv, jv)
    else:
        atol = 1e-5 if pv.dtype == np.float32 else 1e-12
        np.testing.assert_allclose(pv, jv, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the port's own: BandStencil's slice pushdown and streamed seams
# ---------------------------------------------------------------------------

import dask_array_tpu_torch as tda  # noqa: E402
from dask_array_tpu_torch._streaming import STREAMED  # noqa: E402

K1_BOUNDARIES = ["reflect", "nearest", "periodic", 0.5]


def _np_stencil(src, boundary, depth=1):
    mode = {"reflect": "symmetric", "nearest": "edge", "periodic": "wrap"}.get(boundary)
    pad = np.pad(src, depth, mode=mode) if mode else np.pad(src, depth, constant_values=boundary)
    d = depth
    out = -4 * src
    for s0, s1 in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        out = out + pad[d + s0 : d + s0 + src.shape[0], d + s1 : d + s1 + src.shape[1]]
    return out


def _laplace(b):
    return torch.roll(b, 1, 0) + torch.roll(b, -1, 0) + torch.roll(b, 1, 1) + torch.roll(b, -1, 1) - 4 * b


def _stencil(boundary, shape=(40, 12), chunks=(5, 12)):
    src = np.random.default_rng(21).standard_normal(shape).astype("f8")
    x = tda.from_array(src, chunks=chunks)
    return src, tda.map_overlap(_laplace, x, depth=1, boundary=boundary, dtype="f8")


SLICES = [np.s_[0:5], np.s_[5:10], np.s_[35:40], np.s_[1:39], np.s_[3:17, 2:9], np.s_[0:40:2], np.s_[7],
          np.s_[:, 0:3], np.s_[:, 11:], np.s_[38:, 1:], np.s_[0:1]]


@pytest.mark.parametrize("boundary", K1_BOUNDARIES, ids=str)
@pytest.mark.parametrize("index", SLICES, ids=str)
def test_band_stencil_slices_equal_numpy(boundary, index):
    from dask_array_tpu_torch.ops._overlap import BandStencil

    src, st = _stencil(boundary)
    assert isinstance(st.expr, BandStencil)
    want = _np_stencil(src, boundary)
    np.testing.assert_allclose(st[index].compute(), want[index], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(st[index].compute(), st.compute()[index])


@pytest.mark.parametrize("boundary", ["reflect", "nearest", 0.5], ids=str)
def test_band_stencil_slice_shrinks_the_leaf_read(boundary):
    src, st = _stencil(boundary)
    leaf = [n for n in st[5:10].optimize().expr.walk() if type(n).__name__ == "FromArray"]
    assert len(leaf) == 1 and leaf[0].shape == (7, 12)  # the panel and one halo row each side


def test_band_stencil_periodic_edge_slice_stays_outside():
    src, st = _stencil("periodic")
    leaves = [n for n in st[0:5].optimize().expr.walk() if type(n).__name__ == "FromArray"]
    assert leaves[0].shape == src.shape  # the wrap halo needs the other end
    inner = [n for n in st[5:10].optimize().expr.walk() if type(n).__name__ == "FromArray"]
    assert inner[0].shape == (7, 12)


@pytest.mark.parametrize("boundary", K1_BOUNDARIES, ids=str)
@pytest.mark.parametrize("chunks", [(5, 12), (8, 12), ((9, 9, 9, 9, 4), 12), (40, 3)], ids=str)
def test_band_stencil_streamed_seams_equal_in_core(boundary, chunks):
    src, st = _stencil(boundary, chunks=chunks)
    with tconfig.set({"out-of-core": "off"}):
        in_core = st.compute()
    before = dict(STREAMED)
    with tconfig.set({"out-of-core": "force"}):
        out = st.compute()
    count = STREAMED["count"] - before["count"]
    panels = STREAMED["panels"] - before["panels"]
    np.testing.assert_allclose(out, _np_stencil(src, boundary), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(out, in_core)
    if boundary == "periodic":
        assert count == 0  # edge panels cannot take their wrap halo: declined, as the Overlap route
    else:
        assert count == 1 and panels >= 2


def test_streamed_matches_jax_package_on_the_overlap_route():
    """With the band kernel off, the port takes the JAX package's Overlap
    route and streams the same panels."""
    jda = importlib.import_module("dask_array_tpu")
    jstreaming = importlib.import_module("dask_array_tpu._streaming")
    src = np.random.default_rng(3).standard_normal((40, 12)).astype("f4")
    got = {}
    for which, da, spy in (("port", tda, STREAMED), ("jax", jda, jstreaming.STREAMED)):
        p = Pkg(which)
        x = da.from_array(src, chunks=(5, 12))
        with tconfig.set({"stencil-kernel": "off"}):
            st = da.map_overlap(p.laplace(), x, depth=1, boundary="nearest", dtype="f4")
        with p.force():
            got[which] = p.spy(lambda: st.compute())
    assert got["port"][1] == got["jax"][1] and got["port"][1]["panels"] >= 2
    np.testing.assert_allclose(got["port"][0], got["jax"][0], rtol=1e-6, atol=1e-6)


def test_auto_never_engages_on_the_cpu():
    from dask_array_tpu_torch import _streaming

    assert _streaming._budget() == 1 << 62
    x = tda.from_array(np.ones((64, 4)), chunks=(4, 4))
    before = STREAMED["count"]
    assert (x + 1).compute().sum() == 512
    assert STREAMED["count"] == before


def test_from_reference_maps_the_streaming_keys():
    assert tconfig.from_reference({"tpu.out-of-core": "force", "tpu.memory-budget": "2 GiB",
                                   "tpu.stream-depth": 0}) == {
        "out-of-core": "force", "memory-budget": "2 GiB", "stream-depth": 0}


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_stream_depth_keeps_values(depth):
    src = np.random.default_rng(30).standard_normal((64, 6))
    x = tda.from_array(src, chunks=(4, 6))
    before = dict(STREAMED)
    with tconfig.set({"out-of-core": "force", "memory-budget": 1024, "stream-depth": depth}):
        out = (x * 3 - 1).compute()
    np.testing.assert_array_equal(out, src * 3 - 1)
    assert STREAMED["panels"] - before["panels"] >= 4


def test_streamed_bytes_are_counted():
    src = np.random.default_rng(31).standard_normal((64, 6))
    x = tda.from_array(src, chunks=(8, 6))
    before = dict(STREAMED)
    with tconfig.set({"out-of-core": "force"}):
        (x + 1).compute()
    assert STREAMED["h2d_bytes"] - before["h2d_bytes"] == src.nbytes
    assert STREAMED["d2h_bytes"] - before["d2h_bytes"] == src.nbytes


def test_persist_of_a_streamed_result():
    src = np.random.default_rng(32).standard_normal((32, 4))
    x = tda.from_array(src, chunks=(4, 4))
    with tconfig.set({"out-of-core": "force"}):
        y = (x * 2).persist()
    np.testing.assert_array_equal((y + 1).compute(), src * 2 + 1)


def test_an_edit_the_samples_miss_renames_the_leaf():
    # 90000 elements: the digest samples the head, the tail and every 21st
    # element; element 40001 is none of these, and the full-coverage class
    # sums still see its edit
    src = np.random.default_rng(33).standard_normal(90000).reshape(300, 300)
    before = tda.from_array(src, chunks=(100, 300))
    y = tda.barrier(before + 1)
    np.testing.assert_array_equal(y.compute(), src + 1)
    src.reshape(-1)[40001] += 1.0
    after = tda.from_array(src, chunks=(100, 300))
    assert after.name != before.name
    z = tda.barrier(after + 1)
    assert z.name != y.name
    np.testing.assert_array_equal(z.compute(), src + 1)


def test_derived_leaves_do_not_hash_the_source_again(monkeypatch):
    from dask_array_tpu_torch.utils import _tokenize

    src = np.random.default_rng(34).standard_normal((400, 300))
    x = tda.from_array(src, chunks=(50, 300))
    calls = []
    real = _tokenize._positional_class_digest
    monkeypatch.setattr(_tokenize, "_positional_class_digest", lambda *a: calls.append(1) or real(*a))
    with tconfig.set({"out-of-core": "force", "memory-budget": 300_000}):
        out = (x * 2).sum(axis=0).compute()
    np.testing.assert_allclose(out, (src * 2).sum(axis=0), rtol=1e-12)
    assert x[:50].name == x[:50].name and x[:50].name != x[50:100].name
    assert calls == []


def test_keys_bounded_allows_three_plans():
    from dask_array_tpu_torch._streaming import _keys_bounded

    exprs = [tda.ones((8, 8), chunks=4)[:n].optimize().expr for n in (1, 2, 3, 4)]
    assert _keys_bounded(exprs[:3]) and not _keys_bounded(exprs)


# ---------------------------------------------------------------------------
# the pinned copies' pieces (the host side of _hostcopy, runnable here)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", [
    lambda a: a,
    lambda a: a[:, 1:7],
    lambda a: a[::2],
    lambda a: a.T,
    lambda a: a[3],
    lambda a: a[:, :, ::-1],
    lambda a: a[:0],
    lambda a: np.asarray(a[0, 0, 0]),
], ids=["contiguous", "columns", "step", "transpose", "row", "reversed", "empty", "scalar"])
@pytest.mark.parametrize("slot", [8, 48, 200, 1 << 20])
def test_pieces_cover_every_byte_once_in_c_order(make, slot):
    from dask_array_tpu_torch import _hostcopy

    a = make(np.arange(6 * 8 * 5, dtype="f8").reshape(6, 8, 5))
    flat = np.zeros(a.nbytes, np.uint8)
    covered = 0
    for off, nb, sub in _hostcopy._pieces(a, slot):
        assert 0 < nb <= max(slot, sub.dtype.itemsize) and sub.nbytes == nb
        staged = np.zeros(slot if slot >= nb else nb, np.uint8)
        np.copyto(_hostcopy._staged(staged, nb, sub), sub)  # up: gather into a slot
        flat[off : off + nb] = staged[:nb]
        back = np.zeros_like(sub)
        np.copyto(back, _hostcopy._staged(staged, nb, sub))  # down: scatter from a slot
        np.testing.assert_array_equal(back, sub)
        covered += nb
    assert covered == a.nbytes
    np.testing.assert_array_equal(flat.view(a.dtype).reshape(a.shape), np.ascontiguousarray(a))


def test_hostcopy_dtype_maps_are_torch_from_numpys():
    from dask_array_tpu_torch import _hostcopy

    for dt in ("f2", "f4", "f8", "i1", "i8", "u1", "u2", "u4", "u8", "b1", "c8", "c16"):
        assert _hostcopy._torch_dtype_of(np.dtype(dt)) == torch.from_numpy(np.zeros(1, dt)).dtype
        assert _hostcopy._numpy_dtype_of(_hostcopy._torch_dtype_of(np.dtype(dt))) == np.dtype(dt)
