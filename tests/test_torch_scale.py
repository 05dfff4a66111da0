"""The broadcast-scale kernel's plain version, its wrappers and its route,
on the CPU.

``kernels/scale.py::scale_plain`` against numpy in float16, float32 and
float64 (bfloat16, which numpy lacks, against the float32 product rounded
once) for the scalar, row and column forms, byte for byte; against the
Pallas probe it replaces (``bench/probe_pallas_min.py::k_copy``, imported
by path and run in interpret mode); ``scale_form``'s shapes; the wrappers'
device rule; and ``Elemwise._build``'s route: real float multiplies by a
scalar, a row or a column reach ``scale``, full-shape, integer and complex
multiplies do not.  The CUDA kernel itself cannot run here:
``chip_smoke.py`` and ``tests/test_torch_gpu.py`` hold it against this
plain version on the card.
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
from dask_array_tpu_torch.kernels import scale as sk

torch.set_num_threads(1)

PROBE = pathlib.Path(__file__).resolve().parents[1] / "bench" / "probe_pallas_min.py"
FORMS = {"scalar": lambda shape: (), "row": lambda shape: (1, shape[1]), "column": lambda shape: (shape[0], 1)}
SHAPES = [(256, 256), (37, 53), (1, 7), (1000, 3)]


@pytest.fixture(autouse=True)
def _cpu_device():
    """The port runs on the card by default; these tests ask for the CPU."""
    with tconfig.set({"device": "cpu"}):
        yield


def sample(shape, dtype, seed=0):
    """Values with a NaN, an infinity, -0.0 and a float16 subnormal."""
    x = np.random.default_rng(seed).standard_normal(shape) * 3
    flat = x.reshape(-1)
    for i, v in enumerate([np.nan, np.inf, -0.0, 3e-6][: flat.size]):
        flat[(i * 7919) % flat.size] = v
    return x.astype(dtype)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("dtype", ["float16", "float32", "float64"])
def test_plain_equals_numpy(dtype, form, shape):
    x = sample(shape, dtype)
    s = sample(FORMS[form](shape), dtype, seed=1) if form != "scalar" else np.asarray(0.1, dtype=dtype)
    got = sk.scale_plain(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(s)))
    want = x * s
    bits = f"u{x.dtype.itemsize}"
    same = (got.numpy().view(bits) == want.view(bits)) | (np.isnan(got.numpy()) & np.isnan(want))
    assert got.dtype == torch.from_numpy(x).dtype and same.all()


@pytest.mark.parametrize("form", list(FORMS))
def test_plain_bfloat16_is_the_float32_product_rounded_once(form):
    shape = (37, 53)
    x = torch.from_numpy(sample(shape, "float32")).bfloat16()
    s = torch.from_numpy(np.ascontiguousarray(sample(FORMS[form](shape), "float32", seed=1))).bfloat16()
    got = sk.scale_plain(x, s)
    want = (x.float() * s.float()).bfloat16()
    assert got.dtype == torch.bfloat16
    assert bool(((got.view(torch.int16) == want.view(torch.int16)) | (got.isnan() & want.isnan())).all())


def test_plain_takes_a_python_number_rounded_to_the_dtype():
    x = sample((64, 64), "float16")
    got = sk.scale(torch.from_numpy(x), 0.1).numpy()
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(x * 0.1))


def test_against_the_pallas_probe():
    """``k_copy`` (o = x * 2.0 on 256 x 256 float32 in (128, 256) row
    blocks), run in interpret mode, against ``scale_plain``."""
    from jax.experimental import pallas as pl

    spec = importlib.util.spec_from_file_location("probe_pallas_min", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = []

    def pallas_call(*args, **kwargs):
        call = pl.pallas_call(*args, interpret=True, **kwargs)

        def run(x):
            out = call(x)
            seen.append((np.asarray(x), np.asarray(out)))
            return out

        return run

    mod.pl = types.SimpleNamespace(pallas_call=pallas_call, BlockSpec=pl.BlockSpec)
    mod.k_copy()
    (x, out), = seen
    assert x.shape == (256, 256) and x.dtype == np.float32
    got = sk.scale_plain(torch.from_numpy(x), 2.0).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), out.view(np.uint32))


def test_scale_form():
    assert sk.scale_form((5, 7), ()) == (5, 7, 0, 0)
    assert sk.scale_form((5, 7), (1, 1)) == (5, 7, 0, 0)
    assert sk.scale_form((5, 7), (1, 7)) == (5, 7, 0, 1)
    assert sk.scale_form((5, 7), (7,)) == (5, 7, 0, 1)
    assert sk.scale_form((5, 7), (5, 1)) == (5, 7, 1, 0)
    assert sk.scale_form((2, 3, 7), (1, 1, 7)) == (6, 7, 0, 1)  # leading axes merge
    assert sk.scale_form((1, 3, 4, 5), (3, 1, 1)) == (3, 20, 1, 0)
    assert sk.scale_form((2, 3, 7), (1, 3, 1)) is None  # a middle axis under a longer one
    assert sk.scale_form((5, 7), (5, 7)) is None  # full shape
    assert sk.scale_form((5, 7), (2, 1)) is None
    assert sk.scale_form((7,), (1, 7)) is None  # s has more axes than x
    assert sk.scale_form((), ()) == (1, 1, 0, 0)


def test_wrappers_device_rule_and_checks():
    x = torch.ones(4, 5)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        sk.scale_cuda(x, 2.0)
    with pytest.raises(TypeError, match="float16, bfloat16, float32 or float64"):
        sk.scale(torch.ones(4, 5, dtype=torch.int32), 2)
    with pytest.raises(TypeError, match="x's dtype"):
        sk.scale(x, torch.ones(5, dtype=torch.float64))
    with pytest.raises(ValueError, match="not a scalar, row or column"):
        sk.scale(x, torch.ones(4, 5))
    before = sk.LAUNCHES
    sk.scale(x, 2.0)  # the plain version on the CPU: no launch
    assert sk.LAUNCHES == before


@pytest.fixture
def routed(monkeypatch):
    """Record every call of the route into ``scale``."""
    calls = []
    real = sk.scale

    def spy(x, s):
        calls.append((tuple(x.shape), tuple(np.shape(s)), x.dtype))  # s: a tensor or a number
        return real(x, s)

    monkeypatch.setattr(sk, "scale", spy)
    return calls


@pytest.mark.parametrize("dtype", ["float16", "float32", "float64"])
def test_route_takes_scalar_row_and_column_multiplies(routed, dtype):
    x = sample((40, 30), dtype)
    row = sample((1, 30), dtype, seed=1)
    col = sample((40, 1), dtype, seed=2)
    d = tda.from_array(x, chunks=(10, 15))
    cases = [
        (d * 2.5, x * 2.5),
        (2.5 * d, 2.5 * x),
        (tda.multiply(d, 0.3), np.multiply(x, 0.3)),
        (d * tda.from_array(row, chunks=(1, 15)), x * row),
        (tda.from_array(row, chunks=(1, 15)) * d, row * x),
        (d * tda.from_array(col, chunks=(10, 1)), x * col),
        (d * tda.from_array(row[0], chunks=15), x * row[0]),
        (d * d.sum(), x * x.sum(dtype=dtype)),
    ]
    for arr, want in cases:
        got = arr.compute()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert len(routed) == len(cases)
    assert all(shape == (40, 30) for shape, _, _ in routed)


def test_route_leaves_other_multiplies_to_torch(routed):
    x = sample((40, 30), "float32")
    d = tda.from_array(x, chunks=(10, 15))
    xi = np.arange(1200).reshape(40, 30)
    xc = (x + 1j * x).astype(np.complex64)
    others = [
        (d * d, x * x),  # full shape
        (tda.from_array(xi, chunks=10) * 3, xi * 3),  # integer
        (tda.from_array(xc, chunks=10) * 2.0, xc * 2.0),  # complex
        (tda.from_array(xi, chunks=10) * d[:1], xi * x[:1]),  # int64 x float32 row: loop float64
        (tda.from_array(x[:, :1], chunks=10) * tda.from_array(x[:1], chunks=(1, 15)), x[:, :1] * x[:1]),  # outer
    ]
    for arr, want in others:
        np.testing.assert_array_equal(arr.compute(), want)
    assert [r for r in routed if r[2] != torch.float64] == []
    # the int64 x float32 case casts both to float64 and scales
    assert routed == [((40, 30), (1, 30), torch.float64)]


def test_svd_flip_multiplies_go_through_the_route(routed):
    x = sample((200, 6), "float32")
    x = np.nan_to_num(x, nan=0.0, posinf=1.0)
    u, s, vh = tda.linalg.svd(tda.from_array(x, chunks=(50, 6)))
    tda.compute(u, s, vh)
    # u * signs (a row), vh * signs.T (a column), 2.0 * (...) (a scalar)
    assert sorted(routed) == sorted([((200, 6), (1, 6), torch.float32), ((6, 6), (6, 1), torch.float32),
                                     ((1, 6), (), torch.float32)])


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32, torch.float64], ids=str)
def test_number_bits_round_as_the_plain_version(dtype):
    # the kernel takes a number by value: its bits are those of the 0-d
    # tensor the plain version multiplies by, -0.0 apart from 0.0
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[torch.finfo(dtype).bits // 8]
    mask = (1 << torch.finfo(dtype).bits) - 1
    for value in (0.1, -0.0, 0.0, 3, True, np.float32(7.77), 1e300, float("inf")):
        key = int(value) if isinstance(value, (bool, int)) else float(value).hex()
        want = int(torch.tensor(value, dtype=dtype).view(bits).item()) & mask
        assert sk._number_bits(key, dtype) == want, value
    assert sk._number_bits((-0.0).hex(), dtype) != sk._number_bits((0.0).hex(), dtype)
