"""The ported slice end to end: stencil2d (BASELINE config 4) in both
forms and the README example, through ``compute()`` in both packages,
with numpy as the tie-breaker.

The JAX package's ``models.pipelines.stencil2d`` draws its input from
``da.random``, which torch cannot reproduce, so the JAX side builds the
same ``map_overlap`` from ``da.from_array`` with the jnp Laplace (as
tests/test_band_stencil.py does).  Tolerance: atol 1e-5 for float32,
1e-12 for float64.
"""

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
from dask_array_tpu import config as jconfig
from dask_array_tpu.models.pipelines import readme_example as jax_readme
from dask_array_tpu.ops._overlap import BandStencil as JaxBandStencil
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.models.pipelines import readme_example, stencil2d
from dask_array_tpu_torch.ops._overlap import BandStencil

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


def numpy_laplace(x):
    p = np.pad(x.astype(np.float64), 1, mode="symmetric")
    return p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4 * p[1:-1, 1:-1]


def jax_stencil2d(x, chunk, form):
    import jax.numpy as jnp

    d = jda.from_array(x, chunks=chunk)
    if form == "roll":
        def laplace(b):
            return jnp.roll(b, 1, 0) + jnp.roll(b, -1, 0) + jnp.roll(b, 1, 1) + jnp.roll(b, -1, 1) - 4 * b

        with jconfig.set({"tpu.stencil-kernel": "interpret"}):
            out = jda.map_overlap(laplace, d, depth=1, boundary="reflect", dtype=x.dtype)
            assert isinstance(out.expr, JaxBandStencil)
            return out.compute()

    def laplace(p):
        return p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4 * p[1:-1, 1:-1]

    return jda.map_overlap(
        laplace, d, depth=1, boundary="reflect", trim=False, dtype=x.dtype, chunks=d.chunks
    ).compute()


@pytest.mark.parametrize("dtype, atol", [("float32", 1e-5), ("float64", 1e-12)])
@pytest.mark.parametrize("form", ["roll", "slices"])
def test_stencil2d_matches_jax_and_numpy(form, dtype, atol):
    x = np.random.default_rng(0).standard_normal((256, 256)).astype(dtype)
    got = stencil2d(chunk=64, form=form, x_np=x)
    assert isinstance(got.expr, BandStencil) == (form == "roll")
    out = got.compute()
    assert out.shape == (256, 256) and out.dtype == np.dtype(dtype)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, numpy_laplace(x), atol=atol)
    np.testing.assert_allclose(out, jax_stencil2d(x, 64, form), atol=atol)


def test_stencil2d_auto_form_follows_the_gate():
    from dask_array_tpu_torch import config

    x = np.random.default_rng(1).standard_normal((64, 64)).astype("f4")
    assert isinstance(stencil2d(chunk=32, x_np=x).expr, BandStencil)
    with config.set({"stencil-kernel": "off"}):
        slices = stencil2d(chunk=32, x_np=x)
    assert not isinstance(slices.expr, BandStencil)
    np.testing.assert_allclose(slices.compute(), numpy_laplace(x), atol=1e-5)


def test_stencil2d_ragged_chunks():
    x = np.random.default_rng(2).standard_normal((100, 70)).astype("f8")
    for form in ("roll", "slices"):
        np.testing.assert_allclose(stencil2d(chunk=(30, 25), form=form, x_np=x).compute(), numpy_laplace(x), atol=1e-12)


def test_readme_example_matches_jax():
    got = readme_example(n=200, chunk=20)
    want = jax_readme(n=200, chunk=20)
    out = got.compute()
    np.testing.assert_array_equal(out, want.compute())
    np.testing.assert_array_equal(out, np.full((20, 20), 2.0))


def _tree(expr):
    return (type(expr).__name__, tuple(map(tuple, expr.chunks)), tuple(_tree(d) for d in expr.dependencies()))


@pytest.mark.parametrize("index", [(slice(32, 96), slice(None)), (slice(64, None), slice(24, 72))])
def test_block_aligned_slice_through_overlap_plan_matches_jax(index):
    import dask_array_tpu_torch as tda
    from dask_array_tpu_torch.models.pipelines import laplace_slices

    x = np.random.default_rng(5).standard_normal((128, 96))

    def jlap(p):
        return p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4 * p[1:-1, 1:-1]

    got = tda.map_overlap(laplace_slices, tda.from_array(x, chunks=32), depth=1, boundary="nearest",
                          trim=False, dtype=x.dtype, chunks=((32,) * 4, (32,) * 3))[index]
    ref = jda.map_overlap(jlap, jda.from_array(x, chunks=32), depth=1, boundary="nearest",
                          trim=False, dtype=x.dtype, chunks=((32,) * 4, (32,) * 3))[index]
    assert _tree(got.optimize().expr) == _tree(ref.optimize().expr)
    p = np.pad(x, 1, mode="edge")
    want = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4 * p[1:-1, 1:-1])[index]
    np.testing.assert_allclose(got.compute(), want, atol=1e-12)
    np.testing.assert_allclose(ref.compute(), want, atol=1e-12)


def test_multi_array_map_overlap_aligns_chunks():
    import dask_array_tpu_torch as tda

    rng = np.random.default_rng(6)
    a, b = rng.standard_normal((60, 40)), rng.standard_normal((60, 40))

    def tf(p, q):
        return torch.roll(p, 1, 0) - q

    def jf(p, q):
        import jax.numpy as jnp

        return jnp.roll(p, 1, 0) - q

    got = tda.map_overlap(tf, tda.from_array(a, chunks=(20, 40)), tda.from_array(b, chunks=(15, 20)),
                          depth=1, boundary="periodic", dtype=a.dtype)
    ref = jda.map_overlap(jf, jda.from_array(a, chunks=(20, 40)), jda.from_array(b, chunks=(15, 20)),
                          depth=1, boundary="periodic", dtype=a.dtype)
    assert got.chunks == ref.chunks
    np.testing.assert_allclose(got.compute(), ref.compute(), atol=1e-12)


def test_overlap_and_trim_internal_match_jax():
    import dask_array_tpu_torch as tda
    from dask_array_tpu.ops._overlap import overlap as joverlap, trim_internal as jtrim
    from dask_array_tpu_torch.ops._overlap import overlap, trim_internal

    x = np.arange(20.0 * 12).reshape(20, 12)
    for depth, boundary in [({0: 2, 1: 1}, "reflect"), (1, 0.5), ({0: (1, 2), 1: 0}, "none")]:
        got = overlap(tda.from_array(x, chunks=(5, 4)), depth, boundary)
        ref = joverlap(jda.from_array(x, chunks=(5, 4)), depth, boundary)
        assert got.chunks == ref.chunks
        np.testing.assert_array_equal(got.compute(), ref.compute())
        back = trim_internal(got, depth, boundary)
        assert back.chunks == jtrim(ref, depth, boundary).chunks
        np.testing.assert_array_equal(back.compute(), x)


def test_slice_of_stencil_matches_numpy():
    x = np.random.default_rng(4).standard_normal((128, 96)).astype("f8")
    want = numpy_laplace(x)
    for form in ("roll", "slices"):
        got = stencil2d(chunk=32, form=form, x_np=x)[32:96, 10:50].compute()
        np.testing.assert_allclose(got, want[32:96, 10:50], atol=1e-12)
