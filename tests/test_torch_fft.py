"""The port's ``fft`` module against the JAX package and numpy, on the CPU.

All 14 transforms over ``norm`` None, "ortho" and "forward", with
``n``/``s``/``axes`` (a crop, a pad, ``s`` without ``axes``, and the ``*2``
functions given one or three axes, which numpy allows), in float16,
float32, float64, complex64, complex128, int32 and bool; then ``fftfreq``,
``rfftfreq``, ``fftshift``, ``ifftshift``, ``fft_wrap`` and the error for
a transformed axis of several chunks.  Inputs are seeded numpy arrays
through ``from_array``, chunked along the axes a case does not transform.

Tolerance, relative to the largest magnitude of numpy's result: rtol 1e-5
where numpy's result is single precision (complex64, float32), 1e-12
where it is double; for float16 input 2**-10, since numpy rounds its
normalization factor 1 / n to float16 (relative error up to 2**-11) and
an ``irfft``/``hfft`` of float16 to float16.  Result dtypes equal numpy's
exactly.  The JAX package is held to the same values; where its dtype,
its precision or its refusal differs from numpy's,
``KNOWN_REFERENCE_FAULTS`` lists the case and
``test_known_reference_faults_are_real`` shows it (the JAX package's
int32 and bool transforms are held at rtol 1e-5, their single precision).
"""

import warnings

import numpy as np
import pytest
import torch

import dask_array_tpu as jda
import dask_array_tpu_torch as tda
from dask_array_tpu_torch import config as tconfig

torch.set_num_threads(1)

SHAPE = (6, 8, 5)
DTYPES = ["float16", "float32", "float64", "complex64", "complex128", "int32", "bool"]
NORMS = [None, "ortho", "forward"]

# name -> (transform, keyword arguments)
PROGRAMS = {}
for _k in ["fft", "ifft", "rfft", "irfft", "hfft", "ihfft"]:
    PROGRAMS[f"{_k}"] = (_k, {})
    PROGRAMS[f"{_k}_axis1_n6"] = (_k, {"axis": 1, "n": 6})
    PROGRAMS[f"{_k}_axis0_n10"] = (_k, {"axis": 0, "n": 10})
for _k in ["fft2", "ifft2", "rfft2", "irfft2"]:
    PROGRAMS[f"{_k}"] = (_k, {})
    PROGRAMS[f"{_k}_s"] = (_k, {"s": (4, 6)})
    PROGRAMS[f"{_k}_one_axis"] = (_k, {"axes": (0,)})
    PROGRAMS[f"{_k}_three_axes"] = (_k, {"s": (5, 4, 6), "axes": (0, 1, 2)})
for _k in ["fftn", "ifftn", "rfftn", "irfftn"]:
    PROGRAMS[f"{_k}"] = (_k, {})
    PROGRAMS[f"{_k}_axes"] = (_k, {"axes": (2, 0)})
    PROGRAMS[f"{_k}_s"] = (_k, {"s": (4, 6)})

# numpy's real-input transforms refuse complex input
_REAL_INPUT = ("rfft", "ihfft")

# case -> what the JAX package does differently from numpy
KNOWN_REFERENCE_FAULTS = {
    # float16 input: numpy gives complex64 (float16 for irfft/hfft,
    # float32 for irfftn); the JAX package gives complex128 / float64
    "float16": "dtype",
    # float16 input to rfft, ihfft, rfft2 and rfftn: numpy transforms it;
    # the JAX package refuses it on compute (ValueError)
    "float16_real_input": "refuses",
    # int32 and bool input: numpy transforms in float64; the JAX package
    # in float32 (complex128 of single-precision values, 1e-8 off)
    "int32": "single precision",
    "bool": "single precision",
    # a complex rfft: numpy refuses the call (TypeError); the JAX package
    # accepts it and raises only on compute (ValueError)
    "rfft_complex": "accepts",
}


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


def sample(dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SHAPE) * 3
    if dtype == "bool":
        return x > 0
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(SHAPE)
    return x.astype(dtype)


def transformed_axes(kind, kw):
    ndim = len(SHAPE)
    if "axis" in kw:
        return (kw["axis"] % ndim,)
    if kind in ("fft", "ifft", "rfft", "irfft", "hfft", "ihfft"):
        return (ndim - 1,)
    if "axes" in kw:
        return tuple(a % ndim for a in kw["axes"])
    if "s" in kw:
        return tuple(range(ndim - len(kw["s"]), ndim))
    return (ndim - 2, ndim - 1) if kind.endswith("2") else tuple(range(ndim))


def chunks_for(axes):
    return tuple(-1 if ax in axes else 2 for ax in range(len(SHAPE)))


def rtol(dtype, out_dtype):
    if dtype == "float16":
        return 2.0**-10
    return 1e-5 if np.dtype(out_dtype) in (np.complex64, np.float32) else 1e-12


def close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got.astype(np.complex128) - want.astype(np.complex128)).max())
    assert err <= tol * scale, (what, err / scale, tol)


CASES = [(name, dtype, norm) for name in PROGRAMS for dtype in DTYPES for norm in NORMS
         if not (PROGRAMS[name][0].startswith(_REAL_INPUT) and np.dtype(dtype).kind == "c")]


@pytest.mark.parametrize("name, dtype, norm", CASES)
def test_transform(name, dtype, norm):
    kind, kw = PROGRAMS[name]
    a = sample(dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = getattr(np.fft, kind)(a, norm=norm, **kw)
    chunks = chunks_for(transformed_axes(kind, kw))
    port = getattr(tda.fft, kind)(tda.from_array(a, chunks=chunks), norm=norm, **kw)
    assert port.dtype == want.dtype and port.shape == want.shape
    got = port.compute()
    assert got.dtype == want.dtype
    tol = rtol(dtype, want.dtype)
    close(got, want, tol, "port")
    ref = getattr(jda.fft, kind)(jda.from_array(a, chunks=chunks), norm=norm, **kw)
    fault = KNOWN_REFERENCE_FAULTS.get(dtype)
    if fault != "dtype":
        assert ref.dtype == want.dtype
    if dtype == "float16" and kind.startswith(_REAL_INPUT):
        return  # KNOWN_REFERENCE_FAULTS["float16_real_input"]
    close(ref.compute(), want, 1e-5 if fault == "single precision" else tol, "JAX package")


@pytest.mark.parametrize("kind", ["rfft", "ihfft", "rfft2", "rfftn"])
def test_complex_input_to_a_real_transform_raises_numpys_error(kind):
    a = sample("complex128")
    with pytest.raises(TypeError) as want:
        getattr(np.fft, kind)(a)
    with pytest.raises(TypeError, match="not supported for the input types"):
        getattr(tda.fft, kind)(tda.from_array(a, chunks=-1))
    assert "not supported" in str(want.value)


@pytest.mark.parametrize("kind, kw", [("fft", {"axis": 0}), ("rfft", {"axis": 1}), ("fft2", {}), ("fftn", {"axes": (1,)})])
def test_a_transformed_axis_of_several_chunks_raises_the_reference_error(kind, kw):
    a = sample("float64")
    with pytest.raises(ValueError) as ref:
        getattr(jda.fft, kind)(jda.from_array(a, chunks=(3, 4, 5)), **kw)
    with pytest.raises(ValueError) as got:
        getattr(tda.fft, kind)(tda.from_array(a, chunks=(3, 4, 5)), **kw)
    assert str(got.value) == str(ref.value) and "single chunk" in str(got.value)


def test_duplicate_axes_raise_the_reference_error():
    a = sample("float64")
    with pytest.raises(ValueError, match="Duplicate axes not allowed."):
        tda.fft.fftn(tda.from_array(a, chunks=-1), axes=(0, 0))
    with pytest.raises(ValueError, match="Duplicate axes not allowed."):
        jda.fft.fftn(jda.from_array(a, chunks=-1), axes=(0, 0))


@pytest.mark.parametrize("n, d, chunks", [(1, 1.0, "auto"), (8, 1.0, 3), (9, 0.3, 4), (16, 2.5, "auto"), (17, 0.1, 5)])
def test_frequencies(n, d, chunks):
    for port_fn, ref_fn, np_fn in ((tda.fft.fftfreq, jda.fft.fftfreq, np.fft.fftfreq),
                                   (tda.fft.rfftfreq, jda.fft.rfftfreq, np.fft.rfftfreq)):
        want = np_fn(n, d)
        got = port_fn(n, d, chunks=chunks)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.compute(), want)  # numpy's own steps: equal
        np.testing.assert_allclose(ref_fn(n, d, chunks=chunks).compute(), want, rtol=1e-12)


@pytest.mark.parametrize("axes", [None, 0, -1, (0, 2), (1,)])
@pytest.mark.parametrize("dtype", ["float32", "complex128", "int32"])
def test_shifts(axes, dtype):
    a = sample(dtype)
    for port_fn, ref_fn, np_fn in ((tda.fft.fftshift, jda.fft.fftshift, np.fft.fftshift),
                                   (tda.fft.ifftshift, jda.fft.ifftshift, np.fft.ifftshift)):
        want = np_fn(a, axes=axes)
        got = port_fn(tda.from_array(a, chunks=(4, 3, 2)), axes=axes).compute()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ref_fn(jda.from_array(a, chunks=(4, 3, 2)), axes=axes).compute(), want)


def test_a_round_trip_gives_the_input_back():
    a = sample("float64")
    x = tda.from_array(a, chunks=(2, 8, -1))
    np.testing.assert_allclose(tda.fft.irfft(tda.fft.rfft(x), n=SHAPE[-1]).compute(), a, rtol=0, atol=1e-12 * 12)
    np.testing.assert_allclose(tda.fft.ifftn(tda.fft.fftn(tda.from_array(a, chunks=-1))).compute().real, a,
                               rtol=0, atol=1e-12 * 12)


def test_fft_wrap():
    import scipy.fftpack

    a = sample("float64")
    x = tda.from_array(a, chunks=(2, 2, -1))
    wrapped = tda.fft.fft_wrap(np.fft.fft)
    assert wrapped.__name__ == "fft"
    np.testing.assert_allclose(wrapped(x).compute(), np.fft.fft(a), rtol=1e-12)
    wrapped2 = tda.fft.fft_wrap(np.fft.rfftn, kind="rfft2")
    np.testing.assert_allclose(wrapped2(tda.from_array(a, chunks=-1)).compute(), np.fft.rfft2(a), rtol=1e-12)
    for mod in (tda, jda):
        with pytest.raises(ValueError, match="Given unknown `kind` foo."):
            mod.fft.fft_wrap(np.fft.fft, kind="foo")
        with pytest.warns(FutureWarning, match="scipy.fftpack"):
            mod.fft.fft_wrap(scipy.fftpack.fft)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            mod.fft.fft_wrap(scipy.fftpack.fft, allow_fftpack=True)


def test_every_public_fft_name_is_ported():
    want = {n for n in dir(jda.fft) if not n.startswith("_")
            and getattr(getattr(jda.fft, n), "__module__", None) == "dask_array_tpu.ops.fft"}
    assert len(want) == 20 and want - set(dir(tda.fft)) == set()
    assert tda.fft.fft is tda.ops.fft.fft


@pytest.mark.parametrize("name", sorted(KNOWN_REFERENCE_FAULTS))
def test_known_reference_faults_are_real(name):
    """Each listed case does differ from numpy in the JAX package; the
    port does what numpy does."""
    if name == "float16":
        a = sample("float16")
        for kind in ("fft", "rfft", "irfft", "hfft", "fftn", "irfftn"):
            want = getattr(np.fft, kind)(a).dtype
            assert getattr(jda.fft, kind)(jda.from_array(a, chunks=-1)).dtype != want
            assert getattr(tda.fft, kind)(tda.from_array(a, chunks=-1)).dtype == want
    elif name == "float16_real_input":
        a = sample("float16")
        for kind in ("rfft", "ihfft", "rfft2", "rfftn"):
            with pytest.raises(ValueError, match="float16"):
                getattr(jda.fft, kind)(jda.from_array(a, chunks=-1)).compute()
            want = getattr(np.fft, kind)(a)
            close(getattr(tda.fft, kind)(tda.from_array(a, chunks=-1)).compute(), want, 2.0**-10, "port")
    elif name in ("int32", "bool"):
        a = sample(name)
        for kind in ("fft", "irfft", "fftn"):
            want = getattr(np.fft, kind)(a)
            with pytest.raises(AssertionError):
                close(getattr(jda.fft, kind)(jda.from_array(a, chunks=-1)).compute(), want, 1e-12, "JAX package")
            close(getattr(tda.fft, kind)(tda.from_array(a, chunks=-1)).compute(), want, 1e-12, "port")
    else:
        a = sample("complex128")
        ref = jda.fft.rfft(jda.from_array(a, chunks=-1))  # accepted at the call
        with pytest.raises(ValueError):
            ref.compute()
        with pytest.raises(TypeError):
            tda.fft.rfft(tda.from_array(a, chunks=-1))
