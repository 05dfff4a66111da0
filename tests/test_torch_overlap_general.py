"""The general halo path of the PyTorch port: ``overlap``, ``map_overlap``
and ``trim_overlap`` for every func the band kernel does not take.  The
band kernel takes linear stencils and programs of pointwise ops over
shifted windows (tests/test_torch_band_stencil.py,
tests/test_torch_band_program.py), so the tests here ask for this path
with config ``stencil-kernel`` "off", or use a func the capture declines.

The same numpy inputs go through the JAX package (off the TPU its
``map_overlap`` always takes the ``Overlap -> map_blocks -> trim`` route)
and through the port, whose ``Overlap._build`` pads with ``halo_pad``'s
plain version on a CPU tensor, and both are held against numpy.
Tolerance: float32 values rtol 1e-5, atol 1e-6 (the two packages round
their float32 sums in different orders); float64 rtol 1e-12; layouts and
plans equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.kernels import halo
from dask_array_tpu_torch.models.pipelines import laplace_roll, laplace_slices, stencil2d
from dask_array_tpu_torch.ops._overlap import BandStencil, Overlap

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


@pytest.fixture
def rng():
    return np.random.default_rng(23)


def np_laplace(x, boundary="symmetric"):
    p = np.pad(x.astype(np.float64), 1, mode=boundary)
    return p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4 * p[1:-1, 1:-1]


def j_laplace_roll(b):
    return jnp.roll(b, 1, 0) + jnp.roll(b, -1, 0) + jnp.roll(b, 1, 1) + jnp.roll(b, -1, 1) - 4 * b


def both(tfunc, jfunc, arrays, chunks, kernel="off", **kw):
    """(port result, JAX package result) of map_overlap on the same inputs,
    the port's through the halo path: under config ``stencil-kernel``
    ``kernel`` ("off", or "auto" for a func the capture declines)."""
    with tconfig.set({"stencil-kernel": kernel}):
        got = tda.map_overlap(tfunc, *[tda.from_array(a, chunks=chunks) for a in arrays], **kw)
    assert not isinstance(got.expr, BandStencil)
    want = jda.map_overlap(jfunc, *[jda.from_array(a, chunks=chunks) for a in arrays], **kw)
    return got.compute(), np.asarray(want.compute())


# ---------------------------------------------------------------------------
# the main paths: stencil2d's slices form and a func the band kernel declines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape, chunk", [((64, 96), 16), ((100, 70), (30, 25))])
def test_stencil2d_slices_form_matches_jax_and_numpy(shape, chunk):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = stencil2d(chunk=chunk, form="slices", x_np=x)
    assert not isinstance(got.expr, BandStencil)
    xj = jda.from_array(x, chunks=chunk)
    want = jda.map_overlap(laplace_slices, xj, depth=1, boundary="reflect", trim=False,
                           dtype=xj.dtype, chunks=xj.chunks)
    out = got.compute()
    np.testing.assert_allclose(out, np.asarray(want.compute()), **F32)
    np.testing.assert_allclose(out, np_laplace(x), **F32)


def t_median3(b):
    """The 3x3 median filter: a stack and a median, which the band kernel's
    capture declines."""
    return torch.stack([torch.roll(b, (dy, dx), (0, 1)) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]).median(0).values


def j_median3(b):
    return jnp.median(jnp.stack([jnp.roll(b, (dy, dx), (0, 1)) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]), axis=0)


@pytest.mark.parametrize("boundary", ["reflect", "nearest", "periodic", 0.0, -2.5])
def test_nonlinear_func_takes_the_halo_path(rng, boundary):
    x = rng.standard_normal((48, 40)).astype(np.float32)
    # a func the capture declines takes the halo path by itself
    got, want = both(t_median3, j_median3, [x], 12, kernel="auto", depth=1, boundary=boundary)
    np.testing.assert_array_equal(got, want)
    npmode = {"reflect": "symmetric", "nearest": "edge", "periodic": "wrap"}
    pad = (np.pad(x, 1, mode=npmode[boundary]) if isinstance(boundary, str)
           else np.pad(x, 1, mode="constant", constant_values=boundary))
    windows = np.stack([pad[1 + dy:49 + dy, 1 + dx:41 + dx] for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    np.testing.assert_array_equal(got, np.median(windows, axis=0))
    # tanh(laplace), a program the band kernel takes, with the kernel off
    got, want = both(lambda b: torch.tanh(laplace_roll(b)), lambda b: jnp.tanh(j_laplace_roll(b)),
                     [x], 12, depth=1, boundary=boundary)
    np.testing.assert_allclose(got, want, **F32)
    npmode = {"reflect": "symmetric", "nearest": "edge", "periodic": "wrap"}
    if isinstance(boundary, str):
        np.testing.assert_allclose(got, np.tanh(np_laplace(x, npmode[boundary])), **F32)


def test_one_pad_per_compute(rng, monkeypatch):
    x = rng.standard_normal((40, 40)).astype(np.float32)
    calls = []
    real = halo.halo_pad_plain

    def counting(t, widths, modes):
        calls.append((tuple(widths), tuple(modes)))
        return real(t, widths, modes)

    monkeypatch.setattr(halo, "halo_pad_plain", counting)
    with tconfig.set({"stencil-kernel": "off"}):
        arr = tda.map_overlap(lambda b: torch.tanh(b), tda.from_array(x, chunks=10), depth=2, boundary="reflect")
    arr.compute()
    assert calls == [(((2, 2), (2, 2)), ("symmetric", "symmetric"))]


def test_product_of_shifted_windows(rng):
    x = rng.standard_normal((30, 44))
    got, want = both(lambda b: torch.roll(b, 1, 0) * torch.roll(b, -1, 1),
                     lambda b: jnp.roll(b, 1, 0) * jnp.roll(b, -1, 1),
                     [x], (10, 11), depth=1, boundary="periodic")
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(got, np.roll(x, 1, 0) * np.roll(x, -1, 1), rtol=1e-12)


def test_max_filter(rng):
    x = rng.standard_normal((36, 36)).astype(np.float32)

    def tmax(b):
        return torch.stack([torch.roll(b, (i, j), (0, 1)) for i in (-1, 0, 1) for j in (-1, 0, 1)]).amax(0)

    def jmax(b):
        return jnp.stack([jnp.roll(b, (i, j), (0, 1)) for i in (-1, 0, 1) for j in (-1, 0, 1)]).max(0)

    got, want = both(tmax, jmax, [x], 9, depth=1, boundary="nearest")
    np.testing.assert_array_equal(got, want)
    p = np.pad(x, 1, mode="edge")
    ref = np.max([p[1 + i:37 + i, 1 + j:37 + j] for i in (-1, 0, 1) for j in (-1, 0, 1)], axis=0)
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# the other shapes of map_overlap
# ---------------------------------------------------------------------------


def test_trim_false(rng):
    x = rng.standard_normal((20, 24))
    got, want = both(lambda b: b * 2, lambda b: b * 2, [x], (5, 6), depth=2, boundary="reflect", trim=False)
    assert got.shape == want.shape == (36, 40)
    np.testing.assert_array_equal(got, want)


def test_two_arrays(rng):
    x = rng.standard_normal((24, 18))
    y = rng.standard_normal((24, 18))
    got, want = both(lambda a, b: a + torch.roll(b, 1, 0), lambda a, b: a + jnp.roll(b, 1, 0),
                     [x, y], 6, depth=1, boundary="periodic")
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(got, x + np.roll(y, 1, 0), rtol=1e-12)


def test_1d_and_3d(rng):
    v = rng.standard_normal(50)
    got, want = both(lambda b: torch.roll(b, 1) - torch.roll(b, -1), lambda b: jnp.roll(b, 1) - jnp.roll(b, -1),
                     [v], 10, depth=1, boundary="nearest")
    np.testing.assert_allclose(got, want, rtol=1e-12)
    p = np.pad(v, 1, mode="edge")
    np.testing.assert_allclose(got, p[:-2] - p[2:], rtol=1e-12)
    c = rng.standard_normal((8, 10, 12)).astype(np.float32)
    got, want = both(lambda b: torch.roll(b, 1, 2) * 0.5 + torch.roll(b, -2, 0),
                     lambda b: jnp.roll(b, 1, 2) * 0.5 + jnp.roll(b, -2, 0),
                     [c], (4, 5, 6), depth={0: 2, 1: 0, 2: 1}, boundary="periodic")
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(got, np.roll(c, 1, 2) * 0.5 + np.roll(c, -2, 0), **F32)


def test_boundary_none_with_unequal_depth(rng):
    x = rng.standard_normal((20, 30))
    got, want = both(lambda b: b + 1, lambda b: b + 1, [x], (5, 10), depth={0: (1, 2), 1: (0, 3)}, boundary="none")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x + 1)
    # boundary "none" pads nothing: the overlap's tensor is the input's
    ov = tda.overlap(tda.from_array(x, chunks=(5, 10)), depth={0: (1, 2), 1: (0, 3)}, boundary="none")
    jov = jda.overlap(jda.from_array(x, chunks=(5, 10)), depth={0: (1, 2), 1: (0, 3)}, boundary="none")
    assert ov.chunks == jov.chunks
    np.testing.assert_array_equal(ov.compute(), np.asarray(jov.compute()))


@pytest.mark.parametrize("fill", [0.0, 7.5, np.nan])
def test_constant_boundaries(rng, fill):
    x = rng.standard_normal((16, 12))
    got, want = both(lambda b: torch.roll(b, 1, 0) * torch.roll(b, -1, 1), lambda b: jnp.roll(b, 1, 0) * jnp.roll(b, -1, 1),
                     [x], 4, depth=1, boundary=fill)
    np.testing.assert_allclose(got, want, rtol=1e-12, equal_nan=True)
    p = np.pad(x, 1, mode="constant", constant_values=fill)
    np.testing.assert_allclose(got, p[:-2, 1:-1] * p[1:-1, 2:], rtol=1e-12, equal_nan=True)


def test_mixed_boundaries_per_axis(rng):
    x = rng.standard_normal((18, 21))
    bnd = {0: "periodic", 1: 3.0}
    got, want = both(lambda b: torch.roll(b, (1, -1), (0, 1)) ** 2, lambda b: jnp.roll(b, (1, -1), (0, 1)) ** 2,
                     [x], (6, 7), depth=1, boundary=bnd)
    np.testing.assert_array_equal(got, want)
    p = np.pad(np.pad(x, ((1, 1), (0, 0)), mode="wrap"), ((0, 0), (1, 1)), constant_values=3.0)
    np.testing.assert_array_equal(got, p[:-2, 2:] ** 2)


# ---------------------------------------------------------------------------
# overlap / trim_overlap and the slice pushdown through the halo machinery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("boundary", ["reflect", "nearest", "periodic", 4.0])
def test_overlap_then_trim_overlap(rng, boundary):
    x = rng.standard_normal((24, 30)).astype(np.float32)
    depth = {0: 2, 1: 3}
    ov = tda.overlap(tda.from_array(x, chunks=(6, 10)), depth=depth, boundary=boundary)
    jov = jda.overlap(jda.from_array(x, chunks=(6, 10)), depth=depth, boundary=boundary)
    assert ov.chunks == jov.chunks
    np.testing.assert_array_equal(ov.compute(), np.asarray(jov.compute()))
    back = tda.trim_overlap(ov, depth, boundary=boundary)
    jback = jda.trim_overlap(jov, depth, boundary=boundary)
    assert back.chunks == jback.chunks == ((6,) * 4, (10,) * 3)
    np.testing.assert_array_equal(back.compute(), x)


def test_overlap_merges_chunks_smaller_than_the_depth(rng):
    x = rng.standard_normal(20)
    ov = tda.overlap(tda.from_array(x, chunks=((2, 8, 1, 9),)), depth=3, boundary="reflect")
    jov = jda.overlap(jda.from_array(x, chunks=((2, 8, 1, 9),)), depth=3, boundary="reflect")
    assert ov.chunks == jov.chunks
    np.testing.assert_array_equal(ov.compute(), np.asarray(jov.compute()))
    with pytest.raises(ValueError, match="rechunk first"):
        tda.overlap(tda.from_array(x, chunks=((2, 8, 1, 9),)), depth=3, boundary="reflect", allow_rechunk=False)


@pytest.mark.parametrize("index", [np.s_[16:48, :], np.s_[:, 24:72], np.s_[16:32, 24:48], np.s_[:16, :24]])
def test_slice_pushes_through_the_overlap(rng, index):
    x = rng.standard_normal((64, 96)).astype(np.float32)
    with tconfig.set({"stencil-kernel": "off"}):
        arr = tda.map_overlap(lambda b: torch.tanh(laplace_roll(b)), tda.from_array(x, chunks=(16, 24)),
                              depth=1, boundary="reflect")
    sliced = arr[index]
    plan = sliced.expr.simplify()
    overlaps = plan.find(Overlap)
    assert len(overlaps) == 1
    # the slice moved below the halo machinery: the overlap reads a smaller leaf
    assert overlaps[0].array.shape != (64, 96) or index == np.s_[:16, :24]
    want = np.tanh(np_laplace(x))[index]
    np.testing.assert_allclose(sliced.compute(), want, **F32)
    jarr = jda.map_overlap(lambda b: jnp.tanh(j_laplace_roll(b)), jda.from_array(x, chunks=(16, 24)),
                           depth=1, boundary="reflect")
    np.testing.assert_allclose(sliced.compute(), np.asarray(jarr[index].compute()), **F32)


def test_asymmetric_depth_needs_boundary_none(rng):
    x = tda.from_array(rng.standard_normal((10, 10)), chunks=5)
    with pytest.raises(NotImplementedError, match="Asymmetric"):
        tda.map_overlap(lambda b: b, x, depth={0: (1, 2)}, boundary="reflect")
