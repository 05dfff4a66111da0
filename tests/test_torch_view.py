"""``Array.view`` and ``chunk.view`` through the port on the CPU, beside
the JAX package, with numpy as the tie-breaker.

A view reads the same bytes as another dtype: on the device it is
``Tensor.view`` of the held tensor (numpy's unsigned integers, bfloat16
and datetime ticks included), the last axis scaled by the itemsizes'
ratio.  Each case runs through both packages and equals numpy's view of
the source byte for byte, with the chunk rule of ``View.chunks``.
"""

from __future__ import annotations

import importlib

import ml_dtypes
import numpy as np
import pytest
import torch

from dask_array_tpu_torch import config as tconfig

torch.set_num_threads(1)

ROOTS = {"port": "dask_array_tpu_torch", "jax": "dask_array_tpu"}
BF16 = np.dtype(ml_dtypes.bfloat16)


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


def _src(dtype, shape=(6, 8)):
    raw = np.random.default_rng(21).integers(0, 256, int(np.prod(shape)) * np.dtype(dtype).itemsize, dtype=np.uint8)
    out = raw.view(dtype).reshape(shape)
    if np.dtype(dtype).kind == "f":
        out = np.where(np.isfinite(out), out, 0).astype(dtype)  # no NaN payloads: numpy may quiet them
    return out


# (source dtype, view dtype, chunks); every pair the JAX package's
# ``View.chunks`` takes: equal, smaller and larger itemsizes
PAIRS = [
    ("float32", "int32", (3, 4)), ("float32", "uint32", (3, 4)), ("int32", "float32", (2, 8)),
    ("float32", "uint16", (3, 4)), ("float32", "uint8", (6, 2)), ("uint16", "float32", (3, 4)),
    ("int8", "int64", (3, 8)), ("float64", "complex128", (2, 2)), ("complex64", "float32", (3, 4)),
    ("uint64", "int64", (3, 4)), ("int64", "uint64", (3, 4)), ("float32", "bfloat16", (3, 4)),
    ("bfloat16", "uint16", (3, 4)), ("bfloat16", "float32", (3, 4)), ("float16", "int16", (3, 4)),
    ("int64", "datetime64[ns]", (3, 4)), ("datetime64[s]", "int64", (3, 4)), ("bool", "uint8", (3, 4)),
]


def _dt(name):
    return BF16 if name == "bfloat16" else np.dtype(name)


# pairs -> how the JAX package differs from numpy there (each checked to
# differ): ``lax.bitcast_convert_type`` refuses them
KNOWN_REFERENCE_FAULTS = {
    "float64-complex128": "bitcast_convert_type takes no complex type",
    "complex64-float32": "bitcast_convert_type takes no complex type",
    "int64-datetime64[ns]": "jax has no datetime dtype",
    "bool-uint8": "bitcast_convert_type takes no bool",
}


def _view_source(src):
    return _src(_dt(src)) if _dt(src).kind not in "Mm" else _src(np.int64).view(_dt(src))


@pytest.mark.parametrize("src,dst,chunks", PAIRS, ids=[f"{s}-{d}" for s, d, _ in PAIRS])
def test_view_through_both_packages(src, dst, chunks):
    x = _view_source(src)
    want = x.view(_dt(dst))
    outs = {}
    roots = {"port": ROOTS["port"]} if f"{src}-{dst}" in KNOWN_REFERENCE_FAULTS else ROOTS
    for which, root in roots.items():
        da = importlib.import_module(root)
        v = da.from_array(x, chunks=chunks).view(_dt(dst))
        assert v.dtype == want.dtype and v.shape == want.shape
        if which == "port":
            ratio = x.dtype.itemsize / want.dtype.itemsize
            assert v.chunks[-1] == tuple(int(c * ratio) for c in da.from_array(x, chunks=chunks).chunks[-1])
        got = np.asarray(v.compute())
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
        outs[which] = got
    if "jax" in outs:
        np.testing.assert_array_equal(outs["port"].view(np.uint8), outs["jax"].view(np.uint8))


@pytest.mark.parametrize("pair", sorted(KNOWN_REFERENCE_FAULTS))
def test_known_reference_faults_are_real(pair):
    import dask_array_tpu as jda

    src, dst, chunks = next(p for p in PAIRS if f"{p[0]}-{p[1]}" == pair)
    with pytest.raises(TypeError):
        jda.from_array(_view_source(src), chunks=chunks).view(_dt(dst)).compute()


@pytest.mark.parametrize("which", sorted(ROOTS))
def test_view_to_a_larger_dtype_needs_divisible_chunks(which):
    da = importlib.import_module(ROOTS[which])
    with pytest.raises(ValueError, match="divisible"):
        da.from_array(np.zeros((4, 6), np.int8), chunks=(2, 3)).view(np.int16).chunks


@pytest.mark.parametrize("which", sorted(ROOTS))
def test_view_errors(which):
    da = importlib.import_module(ROOTS[which])
    with pytest.raises(ValueError, match="0-d"):
        da.from_array(np.float32(1.0)).view(np.float64)
    with pytest.raises(NotImplementedError):
        da.from_array(np.zeros(4, np.float32), chunks=2).view(np.int32, order="F")


def test_view_then_arithmetic_on_the_device():
    import dask_array_tpu_torch as tda

    x = np.arange(16, dtype=np.float32).reshape(4, 4)
    v = tda.from_array(x, chunks=2).view(np.int32) >> 23
    np.testing.assert_array_equal(v.compute(), x.view(np.int32) >> 23)
    assert isinstance(v.compute_device(), torch.Tensor)


def test_view_of_a_host_block():
    """Records view on the host lane as numpy views them."""
    import dask_array_tpu_torch as tda

    rec = np.zeros(4, dtype=[("a", "i4"), ("b", "i4")])
    rec["a"], rec["b"] = np.arange(4), -np.arange(4)
    got = tda.from_array(rec, chunks=2).view(np.int64).compute()
    np.testing.assert_array_equal(got, rec.view(np.int64))


@pytest.mark.parametrize("order", ["C", "F"])
def test_chunk_view(order):
    from dask_array_tpu_torch import chunk

    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    want = x.view(np.int32) if order == "C" else np.asfortranarray(x).T.view(np.int32).T
    np.testing.assert_array_equal(chunk.view(x, np.int32, order), want)
    got = chunk.view(torch.from_numpy(x), np.int32, order)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
