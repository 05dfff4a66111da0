"""ml_dtypes' bfloat16 and float8 types through the port on the CPU,
beside the JAX package, and K1 and K2 in bfloat16.

Every case of the JAX package's ``tests/test_mldtypes_routing.py`` runs
through both packages (numpy sees bfloat16 through ml_dtypes, which the
port imports when it can and never installs).  Then the port's own: the
four float8 types torch holds go through ``from_array``, ``astype`` and
``compute``; the float6 types are refused by name (the narrow types are
``test_torch_narrow_dtypes.py``'s); and the two
kernels on bfloat16 data against the JAX package's: K1 (the band stencil,
run by the JAX package in Pallas interpret mode) and K2 (the histogram
scan, ``khist(..., interpret=True)``).
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


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def is_float_dtype_table(da, tmp_path):
    is_float_dtype = importlib.import_module(f"{da.__name__}._chunks").is_float_dtype
    for dt in (np.float16, np.float32, np.float64, BF16, ml_dtypes.float8_e4m3fn):
        assert is_float_dtype(dt), dt
    for dt in (np.int32, np.int64, bool, ml_dtypes.int4, "U4", object, np.dtype([("a", "f4")]), "datetime64[ns]",
               np.complex64):
        assert not is_float_dtype(dt), dt
    return []


def sliding_mean_keeps_bf16(da, tmp_path):
    v = da.sliding_window_view(da.ones((32,), chunks=16, dtype=BF16), 8, axis=0).mean(axis=-1)
    assert np.dtype(v.dtype) == BF16
    out = v.compute()
    assert np.dtype(out.dtype) == BF16 and np.allclose(_f32(out), 1.0)
    return [_f32(out)]


def overlap_push_keeps_bf16(da, tmp_path):
    out = da.push(da.ones((32,), chunks=16, dtype=BF16), axis=0)
    assert np.dtype(out.dtype) == BF16
    got = out.compute()
    assert np.dtype(got.dtype) == BF16
    return [_f32(got)]


def random_bf16_generates_in_float_lane(da, tmp_path):
    x = da.random.default_rng(7).standard_normal((64,), chunks=32, dtype=BF16)
    assert np.dtype(x.dtype) == BF16
    vals = _f32(x.compute())
    assert np.isfinite(vals).all() and vals.std() > 0.5
    return []  # the two packages' generators differ (never compared)


def percentile_bf16_is_numeric(da, tmp_path):
    x = da.from_array(np.arange(100, dtype=np.float32).astype(BF16), chunks=25)
    got = float(_f32(da.percentile(x, 50).compute())[0])
    assert abs(got - 49.5) <= 1.0  # bfloat16's resolution near 50
    return []  # the packages' approximate percentiles differ in method


def astype_bf16_is_real_bfloat16(da, tmp_path):
    y = da.eye(4, chunks=4).astype(BF16)
    assert np.dtype(y.dtype) == BF16
    out = (y + y.T).compute()
    assert np.dtype(out.dtype) == BF16 and float(_f32(out)[0, 0]) == 2.0
    return [_f32(out)]


def dtype_key_unique_across_ml_dtypes(da, tmp_path):
    dtype_key = importlib.import_module(f"{da.__name__}._chunks").dtype_key
    fams = ["float8_e4m3fn", "float8_e5m2", "float8_e4m3", "int4", "uint4", "int2", "float4_e2m1fn", "bfloat16"]
    keys = [dtype_key(np.dtype(getattr(ml_dtypes, n))) for n in fams]
    assert len(set(keys)) == len(fams)
    for k, n in zip(keys, fams):
        assert np.dtype(k) == np.dtype(getattr(ml_dtypes, n))
    assert dtype_key(np.dtype([("a", "f4")])) != dtype_key(np.dtype([("b", "f4")]))
    return []


def tokenize_distinguishes_fp8_variants(da, tmp_path):
    tokenize = importlib.import_module(f"{da.__name__}.utils._tokenize").tokenize
    assert tokenize(np.zeros(8, dtype=ml_dtypes.float8_e4m3fn)) != tokenize(np.zeros(8, dtype=ml_dtypes.int4))
    assert tokenize(np.dtype(ml_dtypes.float8_e4m3fn)) != tokenize(np.dtype(ml_dtypes.uint4))
    return []


def from_array_bf16_singletons_not_aliased(da, tmp_path):
    raw = np.zeros(8, dtype=np.uint16)
    x = da.from_array(raw.view(BF16), chunks=4)
    y = da.from_array(raw.view(ml_dtypes.float8_e4m3fn).reshape(8, 2)[:, 0], chunks=4)
    assert x.expr._name != y.expr._name
    return []


def npy_stack_bf16_round_trip(da, tmp_path):
    da.to_npy_stack(str(tmp_path / f"n-{da.__name__}"), da.full((8, 8), 3, chunks=4, dtype=BF16), axis=0)
    back = da.from_npy_stack(str(tmp_path / f"n-{da.__name__}"))
    assert np.dtype(back.dtype) == BF16
    out = back.compute()
    assert np.dtype(out.dtype) == BF16 and np.allclose(_f32(out), 3.0)
    return [_f32(out)]


def zarr_bf16_round_trip(da, tmp_path):
    da.to_zarr(da.full((8, 8), 5, chunks=4, dtype=BF16), str(tmp_path / f"z-{da.__name__}"))
    back = da.from_zarr(str(tmp_path / f"z-{da.__name__}"))
    assert np.dtype(back.dtype) == BF16
    out = back.compute()
    assert np.dtype(out.dtype) == BF16 and np.allclose(_f32(out), 5.0)
    return [_f32(out)]


def linalg_bf16_promotes_to_f32_not_f64(da, tmp_path):
    a_np = np.random.default_rng(11).standard_normal((16, 8)).astype(np.float32)
    q, r = da.linalg.qr(da.from_array(a_np.astype(BF16), chunks=(8, 8)))
    assert np.dtype(q.dtype) == np.dtype("f4")
    got = _f32((q @ r).compute())
    assert np.allclose(got, a_np, atol=0.15)  # bfloat16 input resolution
    return []  # the factorizations' float32 roundings differ


def _subf32_reduction(dt, kind):
    def case(da, tmp_path):
        dtype = BF16 if dt == "bfloat16" else np.dtype(np.float16)
        fill = 256.0 if dt == "bfloat16" else 0.25  # float16's max is 65504
        out = getattr(da, kind)(da.full((64, 64), fill, chunks=16, dtype=dtype)).compute()
        assert np.dtype(out.dtype) == dtype
        assert float(np.asarray(out, dtype=np.float64)) == (fill if kind == "mean" else fill * 64 * 64)
        return [np.asarray(out, dtype=np.float64)]

    return case


CASES = {
    **{f.__name__: f for f in (
        is_float_dtype_table, sliding_mean_keeps_bf16, overlap_push_keeps_bf16, random_bf16_generates_in_float_lane,
        percentile_bf16_is_numeric, astype_bf16_is_real_bfloat16, dtype_key_unique_across_ml_dtypes,
        tokenize_distinguishes_fp8_variants, from_array_bf16_singletons_not_aliased, npy_stack_bf16_round_trip,
        zarr_bf16_round_trip, linalg_bf16_promotes_to_f32_not_f64,
    )},
    # (the JAX file skips float16 with mean and nansum: one dtype by every
    # kind and one kind by every dtype)
    **{f"subf32_reductions_accumulate_in_f32[{k}-{d}]": _subf32_reduction(d, k)
       for d, k in [("bfloat16", "sum"), ("bfloat16", "mean"), ("bfloat16", "nansum"), ("float16", "sum")]},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_through_both_packages(name, tmp_path):
    port = CASES[name](importlib.import_module(ROOTS["port"]), tmp_path)
    ref = CASES[name](importlib.import_module(ROOTS["jax"]), tmp_path)
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)


# -- the port's own --------------------------------------------------------------------


@pytest.mark.parametrize("name", ["bfloat16", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz", "float8_e5m2fnuz"])
def test_torch_held_ml_dtypes_round_trip(name):
    """Each ml_dtypes type torch holds goes through from_array, astype and
    compute, its bytes kept (held as torch's own dtype)."""
    import dask_array_tpu_torch as tda
    from dask_array_tpu_torch._chunks import torch_dtype

    dt = np.dtype(getattr(ml_dtypes, name))
    src = np.linspace(-3, 3, 24, dtype=np.float32).reshape(4, 6).astype(dt)
    x = tda.from_array(src, chunks=(2, 3))
    out = x.compute()
    assert out.dtype == dt and np.array_equal(out.view(np.uint8), src.view(np.uint8))
    assert x.compute_device().dtype == torch_dtype(dt) == getattr(torch, name)
    back = x.astype(np.float32).compute()
    np.testing.assert_array_equal(back, src.astype(np.float32))
    cast = tda.from_array(src.astype(np.float32), chunks=(2, 3)).astype(dt).compute()
    assert cast.dtype == dt and np.array_equal(cast.view(np.uint8), src.view(np.uint8))


@pytest.mark.parametrize("name", ["float6_e2m3fn", "float6_e3m2fn"])
def test_other_ml_dtypes_are_refused_by_name(name):
    import dask_array_tpu_torch as tda

    with pytest.raises(TypeError, match=f"ml_dtypes.{name}"):
        tda.from_array(np.zeros(4, dtype=getattr(ml_dtypes, name)), chunks=2)


def test_bf16_crosses_host_copies_as_16_bit_words():
    """A bfloat16 host array goes up and down as the bytes of its 16-bit
    words (``_chunks.tensor_of``/``array_of``; the pinned rings of
    ``_hostcopy`` take the same dtypes)."""
    from dask_array_tpu_torch._chunks import array_of, tensor_of
    from dask_array_tpu_torch._hostcopy import _numpy_dtype_of, _torch_dtype_of

    src = np.arange(-8, 8, dtype=np.float32).astype(BF16)
    t = tensor_of(src)
    assert t.dtype == torch.bfloat16 and np.array_equal(array_of(t).view(np.uint16), src.view(np.uint16))
    assert _torch_dtype_of(BF16) == torch.bfloat16 and _numpy_dtype_of(torch.bfloat16) == BF16


def test_bf16_products_are_bf16_with_float32_sums():
    """``blocked_matmul`` takes BASELINE's bfloat16 operands: a bfloat16
    product (numpy's einsum takes no bfloat16; numpy's promotion keeps it)."""
    from dask_array_tpu_torch.models.pipelines import blocked_matmul

    rng = np.random.default_rng(3)
    a = rng.standard_normal((64, 64)).astype(BF16)
    b = rng.standard_normal((64, 64)).astype(BF16)
    m = blocked_matmul(chunk=16, a_np=a, b_np=b)
    assert np.dtype(m.dtype) == BF16 and m.chunks == ((16,) * 4, (8,) * 8)
    want = a.astype(np.float32) @ b.astype(np.float32)
    np.testing.assert_allclose(_f32(m.compute()), want, rtol=2.0**-7, atol=2.0**-16 * np.abs(want).max())


# -- K1 and K2 in bfloat16, against the JAX package's kernels ------------------------


def _laplace_torch(b):
    return torch.roll(b, 1, 0) + torch.roll(b, -1, 0) + torch.roll(b, 1, 1) + torch.roll(b, -1, 1) - 4 * b


def _laplace_jnp(b):
    import jax.numpy as jnp

    return jnp.roll(b, 1, 0) + jnp.roll(b, -1, 0) + jnp.roll(b, 1, 1) + jnp.roll(b, -1, 1) - 4 * b


@pytest.mark.parametrize("boundary", ["reflect", "nearest", "periodic", 0.0])
def test_k1_bf16_against_the_jax_kernel_in_interpret_mode(boundary):
    """The port's K1 in bfloat16 (its plain version here: float32 taps,
    one rounding) against the JAX package's Pallas band kernel in
    interpret mode.  bfloat16 rounds at other places in the two
    frameworks, so the tolerance is a bfloat16 step of the result plus one
    of sum|w| * max|x| (the taps' largest sum)."""
    import jax.numpy as jnp
    from dask_array_tpu.kernels.stencil import band_stencil_call

    import dask_array_tpu_torch as tda
    from dask_array_tpu_torch.ops._overlap import BandStencil

    x = np.random.default_rng(12).standard_normal((64, 96)).astype(np.float32).astype(BF16)
    port = tda.map_overlap(_laplace_torch, tda.from_array(x, chunks=(16, 48)), depth=1, boundary=boundary, dtype=BF16)
    assert port.optimize().expr.find(BandStencil)
    # the JAX package's route keeps bfloat16 off its kernel; its kernel
    # itself takes bfloat16 (kernels/stencil.py:27), called here directly
    want = _f32(band_stencil_call(jnp.asarray(x), _laplace_jnp, (1, 1), (boundary, boundary), interpret=True))
    got = port.compute()
    assert got.dtype == BF16
    scale = 8.0 * float(np.abs(_f32(x)).max())
    np.testing.assert_allclose(_f32(got), want, rtol=2.0**-7, atol=2.0**-8 * scale)


def test_k1_bf16_plain_version_rounds_once():
    """The plain version (the card's reference) computes in float32 and
    rounds once: equal to float64 numpy's stencil rounded to bfloat16 but
    where a float32 sum lands on the other side of a tie."""
    from dask_array_tpu_torch.kernels import stencil

    x = np.random.default_rng(13).standard_normal((40, 56)).astype(np.float32).astype(BF16)
    got = stencil.band_stencil_plain(torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16), _laplace_torch,
                                     (1, 1), ("reflect", "reflect"))
    assert got.dtype == torch.bfloat16
    p = np.pad(_f32(x).astype(np.float64), 1, mode="symmetric")
    ref = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4 * p[1:-1, 1:-1]).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref.astype(BF16).astype(np.float32), rtol=2.0**-7, atol=0)
    assert stencil._DTYPE_CODES[torch.bfloat16] == 3


@pytest.mark.parametrize("nbins", [1, 16, 256])
def test_k2_bf16_counts_equal_the_jax_scan(nbins):
    """K2 on bfloat16 data compares in float32 (exact for bfloat16): the
    port's counts equal the JAX package's Pallas scan in interpret mode
    and numpy's on the float32 values."""
    import jax.numpy as jnp
    from dask_array_tpu.kernels.histogram import histogram as khist

    from dask_array_tpu_torch.kernels import histogram as hk

    rng = np.random.default_rng(14)
    x = (rng.standard_normal(5000) * 2).astype(np.float32).astype(BF16)
    x[::97] = np.nan
    edges = np.linspace(-4, 4, nbins + 1)
    got = hk.histogram_counts(torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16), torch.from_numpy(edges))
    want = np.asarray(khist(jnp.asarray(x), jnp.asarray(edges), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.histogram(_f32(x)[~np.isnan(_f32(x))], bins=edges)[0])
    assert hk.DATA_CODES[torch.bfloat16] in hk.KERNEL_PAIRS[hk.kernel_compare(hk.comparison_dtype(torch.bfloat16,
                                                                                                   torch.float64))]
    assert hk.kernel_compare(BF16) == "float32"
