"""The tiled transpose's plain version, its wrappers and its route, on the CPU.

``kernels/transpose.py::transpose_last2_plain`` against the Pallas probe's
own ``_transp_call`` (``bench/probe_pallas_min.py``, imported by path and
run in interpret mode) and against numpy's ``.T`` on ragged, batched and
sliced inputs of every element size, byte for byte (NaN payloads and -0.0
included); the wrappers' device rule; and ``Transpose._build``, which lays
out a swap of the last two axes through the wrapper.  The CUDA kernel
itself cannot run here: ``chip_smoke.py`` and ``tests/test_torch_gpu.py``
hold it against this plain version on the card.
"""

import functools
import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

import dask_array_tpu_torch as tda
from dask_array_tpu_torch import config as tconfig
from dask_array_tpu_torch.kernels import transpose as tk
from dask_array_tpu_torch.ops.manipulation import Transpose

torch.set_num_threads(1)

PROBE = pathlib.Path(__file__).resolve().parents[1] / "bench" / "probe_pallas_min.py"
DTYPES = ["bool", "int8", "float16", "float32", "float64", "int64", "complex64", "complex128"]
SHAPES = [(1, 7), (37, 53), (513, 257), (1000, 1003), (4097, 33), (3, 513, 257), (2, 3, 5, 7)]


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


@pytest.fixture(scope="module")
def probe():
    """The probe module with ``pl.pallas_call`` in interpret mode, so the
    TPU kernel runs on the CPU without any change to ``bench/``."""
    from jax.experimental import pallas as pl

    spec = importlib.util.spec_from_file_location("probe_pallas_min", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True), BlockSpec=pl.BlockSpec
    )
    return mod


def sample(shape, dtype, seed=0):
    """Random values of ``dtype``; float inputs carry a NaN with a payload,
    -0.0 and infinities, so a byte comparison sees any value change."""
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(shape) < 0.5
    if dtype in ("int8", "int64"):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, size=shape, dtype=dtype, endpoint=True)
    x = rng.standard_normal(shape)
    if dtype.startswith("complex"):
        x = x + 1j * rng.standard_normal(shape)
    x = x.astype(dtype)
    flat = x.reshape(-1)
    specials = [-0.0, np.inf, -np.inf]
    for i, v in enumerate(specials[: flat.size]):
        flat[(i * 7919) % flat.size] = v
    if flat.size > 3:
        real = flat.view(x.real.dtype) if dtype.startswith("complex") else flat
        bits = real.view(f"u{real.dtype.itemsize}")
        nan = np.array(np.nan, dtype=real.dtype).view(bits.dtype)
        bits[3] = nan | np.array(0x5, dtype=bits.dtype)  # a NaN with a payload
    return x


def same_bytes(got: torch.Tensor, want: np.ndarray) -> bool:
    got = got.numpy()
    return got.shape == want.shape and got.dtype == want.dtype and (
        np.ascontiguousarray(got).tobytes() == np.ascontiguousarray(want).tobytes()
    )


@pytest.mark.parametrize("T", [256, 512])
def test_plain_matches_the_probe(probe, T):
    import jax.numpy as jnp

    x = sample((1024, 1024), "float32", seed=T)
    ref = np.asarray(probe._transp_call(jnp.asarray(x), T=T))
    got = tk.transpose_last2_plain(torch.from_numpy(x))
    assert same_bytes(got, ref)
    assert same_bytes(got, x.T)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_numpy_byte_for_byte(shape, dtype):
    x = sample(shape, dtype, seed=len(shape) * 31 + shape[-1])
    got = tk.transpose_last2_plain(torch.from_numpy(x))
    assert got.is_contiguous()
    assert same_bytes(got, np.swapaxes(x, -1, -2))


@pytest.mark.parametrize("dtype", ["int8", "float32", "complex128"])
def test_plain_reads_sliced_views(dtype):
    x = sample((700, 900), dtype, seed=5)
    t = torch.from_numpy(x)
    for view, want in (
        (t[100:400], x[100:400]),  # row slice: a row stride of 900
        (t[:, 37:500], x[:, 37:500]),  # column slice: the same row stride
        (t[5:300, 134:900], x[5:300, 134:900]),
        (t[:, ::2], x[:, ::2]),  # a strided last axis
        (t.mT, x.T),  # a transposed view
    ):
        assert same_bytes(tk.transpose_last2_plain(view), want.T)


def test_wrappers_follow_the_tensors_device(monkeypatch):
    x_np = sample((40, 30), "float32")
    x = torch.from_numpy(x_np)
    before = tk.LAUNCHES
    assert same_bytes(tk.transpose_last2(x), x_np.T)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk.transpose_last2_cuda(x)
    assert tk.LAUNCHES == before
    # a CPU tensor never reaches the kernel's wrapper, and the plain version
    # never catches a kernel failure
    monkeypatch.setattr(tk, "transpose_last2_cuda", lambda _: pytest.fail("kernel called"))
    assert same_bytes(tk.transpose_last2(x), x_np.T)
    with pytest.raises(ValueError, match="2 dimensions"):
        tk.transpose_last2_plain(torch.ones(5))


def test_empty_inputs():
    for shape in [(0, 5), (4, 0), (2, 0, 3)]:
        got = tk.transpose_last2(torch.ones(shape))
        assert tuple(got.shape) == (*shape[:-2], shape[-1], shape[-2])


@pytest.mark.parametrize(
    "shape, axes, laid_out",
    [
        ((12, 10), (1, 0), True),
        ((4, 12, 10), (0, 2, 1), True),
        ((2, 3, 12, 10), (0, 1, 3, 2), True),
        ((4, 12, 10), (2, 1, 0), False),
        ((4, 12, 10), (1, 0, 2), False),
        ((4, 12, 10), (2, 0, 1), False),
    ],
)
def test_transpose_build_lays_out_a_last_two_swap(shape, axes, laid_out, monkeypatch):
    """``Transpose._build`` hands a swap of the last two axes to
    ``transpose_last2`` (a contiguous result on every device); every other
    permutation stays a ``permute`` view."""
    x = sample(shape, "float64", seed=11)
    calls = []
    real = tk.transpose_last2_plain

    def spy(t):
        calls.append(tuple(t.shape))
        return real(t)

    monkeypatch.setattr(tk, "transpose_last2_plain", spy)
    y = tda.transpose(tda.from_array(x, chunks=5), axes)
    assert isinstance(y.expr, Transpose)
    out = y.compute_device()
    np.testing.assert_array_equal(out.numpy(), x.transpose(axes))
    assert bool(calls) == laid_out
    assert out.is_contiguous() == laid_out
