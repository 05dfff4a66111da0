"""Masked arrays (``np.ma``) through the port on the CPU, beside the JAX
package, with numpy.ma as the tie-breaker.

Every case of the JAX package's ``tests/test_masked_arrays.py`` runs
through both packages (``pkg``) and is held to numpy.ma; the two packages'
results are held to each other (type, mask and values; exactly unless the
case states a tolerance).  Then the repair: ``from_array`` of a masked
array kept its data and dropped its mask, so a sum counted the masked
elements (15.0 for 10.0).  ``KNOWN_REFERENCE_FAULTS`` holds the cases where
the JAX package differs from numpy, each checked to differ.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from dask_array_tpu_torch import config as tconfig

torch.set_num_threads(1)

ROOTS = {"port": "dask_array_tpu_torch", "jax": "dask_array_tpu"}


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


def _marr():
    arr = np.ma.array(np.arange(100.0).reshape(10, 10), mask=False)
    arr[5, 5] = np.ma.masked
    return arr


def _assert_ma_eq(got, want, rtol=0.0):
    assert isinstance(got, np.ma.MaskedArray), type(got)
    np.testing.assert_array_equal(np.ma.getmaskarray(got), np.ma.getmaskarray(want))
    np.testing.assert_allclose(got.filled(-123.0), np.ma.asanyarray(want).filled(-123.0), rtol=rtol)


# -- the cases: each takes a package, checks it against numpy.ma and returns
# its results (compared across the packages by ``_same``)


def slice_compute(da):
    marr = _marr()
    out = da.from_array(marr, chunks=5)[4:7, 4:7].compute()
    assert isinstance(out, np.ma.MaskedArray) and out[1, 1] is np.ma.masked
    np.testing.assert_array_equal(out.filled(-1), marr[4:7, 4:7].filled(-1))
    return [out]


def identity_compute(da):
    out = da.from_array(_marr(), chunks=5).compute()
    assert isinstance(out, np.ma.MaskedArray) and bool(out.mask[5, 5])
    return [out]


def concat_stack_rechunk(da):
    x = da.from_array(_marr(), chunks=5)
    c, s, r = da.concatenate([x, x]).compute(), da.stack([x, x]).compute(), x.rechunk(4).compute()
    assert int(np.sum(np.ma.getmaskarray(c))) == 2 and int(np.sum(np.ma.getmaskarray(s))) == 2
    assert bool(np.ma.getmaskarray(r)[5, 5])
    return [c, s, r]


def map_blocks_numpy_ma_kernel(da):
    out = da.from_array(_marr(), chunks=5).map_blocks(lambda b: np.ma.filled(b, -9.0), dtype="f8").compute()
    assert float(np.asarray(out)[5, 5]) == -9.0
    return [np.asarray(out)]


def elemwise_compute(da):
    marr = _marr()
    x = da.from_array(marr, chunks=5)
    outs = [(x + 1).compute(), (x * 2 - x).compute(), da.sqrt(x).compute()]
    for got, want in zip(outs, [marr + 1, marr * 2 - marr, np.sqrt(marr)]):
        _assert_ma_eq(got, want)
    return outs


def elemwise_domain_mask(da):
    src = np.ma.array([-1.0, 4.0, 9.0], mask=[0, 0, 1])
    out = da.sqrt(da.from_array(src, chunks=2)).compute()
    with np.errstate(all="ignore"):
        _assert_ma_eq(out, np.sqrt(src))
    assert bool(np.ma.getmaskarray(out)[0])  # numpy.ma masks the domain error
    return [out]


def reductions_compute(da):
    marr = _marr()
    x = da.from_array(marr, chunks=5)
    total, mean = x.sum().compute(), x.mean().compute()
    assert float(total) == float(marr.sum()) and float(mean) == float(marr.mean())
    col = x.sum(axis=0).compute()
    _assert_ma_eq(col, marr.sum(axis=0))
    src = np.ma.array(np.ones((4, 3)), mask=False)
    src[:, 1] = np.ma.masked
    y = da.from_array(src, chunks=2).sum(axis=0).compute()
    assert bool(np.ma.getmaskarray(y)[1])  # a column with nothing left stays masked
    return [np.asarray(total), np.asarray(mean), col, y]


def where(da):
    marr = _marr()
    x = da.from_array(marr, chunks=5)
    cond = np.arange(100).reshape(10, 10) % 2 == 0
    got = da.where(da.from_array(cond, chunks=5), x, -x).compute()
    _assert_ma_eq(got, np.ma.where(cond, marr, -marr))
    return [got]


def transpose_squeeze(da):
    marr = _marr()
    t = da.from_array(marr, chunks=5).T.compute()
    _assert_ma_eq(t, marr.T)
    s = np.ma.array(np.arange(6.0).reshape(1, 6), mask=[[0, 1, 0, 0, 0, 0]])
    q = da.squeeze(da.from_array(s, chunks=3), axis=0).compute()
    _assert_ma_eq(q, np.squeeze(s, axis=0))
    return [t, q]


def compute_many(da):
    marr = _marr()
    x = da.from_array(marr, chunks=5)
    a, b = da.compute(x + 1, x - 1)
    _assert_ma_eq(a, marr + 1)
    _assert_ma_eq(b, marr - 1)
    return [a, b]


def mixed_with_device_operand(da):
    marr = _marr()
    got = (da.from_array(marr, chunks=5) + da.ones((10, 10), chunks=5)).compute()
    _assert_ma_eq(got, marr + 1.0)
    return [got]


def unsupported_still_raises(da):
    x = da.from_array(_marr(), chunks=5)
    with pytest.raises(NotImplementedError, match="mask"):
        da.fft.fft(x.rechunk((10, 10))).compute()
    return []


def tokenize_mask_is_identity(da):
    tokenize = importlib.import_module(f"{da.__name__}.utils._tokenize").tokenize
    a1 = np.ma.array([1.0, 2.0], mask=[0, 1])
    a2 = np.ma.array([1.0, 2.0], mask=[0, 0])
    a3 = np.ma.array([1.0, 2.0], mask=[0, 1])
    assert tokenize(a1) != tokenize(a2) and tokenize(a1) == tokenize(a3)
    return []


def tokenize_ignores_bytes_under_mask(da):
    tokenize = importlib.import_module(f"{da.__name__}.utils._tokenize").tokenize
    assert tokenize(np.ma.array([1.0, 777.0], mask=[0, 1])) == tokenize(np.ma.array([1.0, -5.0], mask=[0, 1]))
    return []


def var_std_mask_aware_count(da):
    marr = _marr()
    x = da.from_array(marr, chunks=5)
    v, s = x.var().compute(), x.std().compute()
    assert float(v) == pytest.approx(float(marr.var()), rel=1e-12)
    assert float(s) == pytest.approx(float(marr.std()), rel=1e-12)
    col = x.var(axis=0).compute()
    _assert_ma_eq(col, marr.var(axis=0), rtol=1e-12)
    return [np.asarray(v), np.asarray(s), col]


def var_heavily_masked(da):
    src = np.ma.array(np.arange(24.0).reshape(4, 6), mask=False)
    src[1] = np.ma.masked  # a whole row
    src[0, ::2] = np.ma.masked  # half a row
    x = da.from_array(src, chunks=2)
    v = x.var().compute()
    assert float(v) == pytest.approx(float(src.var()), rel=1e-12)
    row = x.var(axis=1, ddof=1).compute()
    _assert_ma_eq(row, src.var(axis=1, ddof=1), rtol=1e-12)
    return [np.asarray(v), row]


def cumsum_cumprod(da):
    src = np.ma.array([3.0, 1.0, 2.0, 9.0], mask=[0, 1, 0, 0])
    x = da.from_array(src, chunks=2)
    outs = [da.cumsum(x).compute(), da.cumprod(x).compute()]
    _assert_ma_eq(outs[0], np.cumsum(src))
    _assert_ma_eq(outs[1], np.cumprod(src))
    m2 = np.ma.array(np.arange(12.0).reshape(3, 4), mask=False)
    m2[1, 2] = np.ma.masked
    outs.append(da.cumsum(da.from_array(m2, chunks=2), axis=0).compute())
    _assert_ma_eq(outs[2], np.cumsum(m2, axis=0))
    return outs


def argmax_ignores_masked(da):
    x = da.from_array(np.ma.array([3.0, 100.0, 2.0, 9.0], mask=[0, 1, 0, 0]), chunks=2)
    assert int(da.argmax(x).compute()) == 3 and int(da.argmin(x).compute()) == 2  # the masked 100 never wins
    m2 = np.ma.array([[3.0, 1.0], [2.0, 9.0]], mask=[[0, 1], [0, 0]])
    got = np.asarray(da.argmax(da.from_array(m2, chunks=1), axis=1).compute())
    np.testing.assert_array_equal(got, np.argmax(m2, axis=1))
    return [got]


CASES = {f.__name__: f for f in (
    slice_compute, identity_compute, concat_stack_rechunk, map_blocks_numpy_ma_kernel, elemwise_compute,
    elemwise_domain_mask, reductions_compute, where, transpose_squeeze, compute_many, mixed_with_device_operand,
    unsupported_still_raises, tokenize_mask_is_identity, tokenize_ignores_bytes_under_mask, var_std_mask_aware_count,
    var_heavily_masked, cumsum_cumprod, argmax_ignores_masked,
)}

# tolerance between the packages, per case (exact elsewhere)
RTOL = {"var_std_mask_aware_count": 1e-12, "var_heavily_masked": 1e-12}


def _same(a, b, rtol):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, np.ma.MaskedArray):
        np.testing.assert_array_equal(np.ma.getmaskarray(a), np.ma.getmaskarray(b))
        a, b = a.filled(0), b.filled(0)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_through_both_packages(name):
    port = CASES[name](importlib.import_module(ROOTS["port"]))
    ref = CASES[name](importlib.import_module(ROOTS["jax"]))
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        _same(a, b, RTOL.get(name, 0.0))


# -- the repair: a masked source keeps its mask ------------------------------------


@pytest.mark.parametrize("pkg", sorted(ROOTS))
def test_masked_sum_leaves_masked_elements_out(pkg):
    """``from_array`` of a masked array called ``np.asarray`` and dropped the
    mask: the port summed 0..5 to 15.0 and computed a plain ndarray."""
    da = importlib.import_module(ROOTS[pkg])
    src = np.ma.masked_array(np.arange(6.0), mask=[0, 1, 0, 0, 1, 0])
    x = da.from_array(src, chunks=3)
    assert float(x.sum().compute()) == float(src.sum()) == 10.0
    out = x.compute()
    assert isinstance(out, np.ma.MaskedArray)
    np.testing.assert_array_equal(out.mask, src.mask)


def test_masked_ops_without_a_mask_safe_kernel_raise():
    """A node the host lane cannot keep a mask through raises before it
    computes; a torch function with no numpy counterpart raises too."""
    import dask_array_tpu_torch as tda

    x = tda.from_array(np.ma.masked_array(np.arange(8.0), mask=[0, 1] * 4), chunks=4)
    with pytest.raises(NotImplementedError, match="mask"):
        tda.fft.fft(x.rechunk(8)).compute()
    with pytest.raises(NotImplementedError, match="mask"):
        tda.elemwise(torch.special.erfcx, x).compute()


def test_masked_leaves_are_never_uploaded():
    """The lane is chosen by the block's type: a masked leaf stays a masked
    array in the walk (``to_device`` returns it as it is)."""
    from dask_array_tpu_torch._executor import to_device

    src = np.ma.masked_array(np.arange(4.0), mask=[0, 1, 0, 0])
    assert to_device(src, torch.device("cpu")) is src


# -- every ufunc of the port on a masked array -------------------------------------

_UFUNCS = sorted(n for n in __import__("dask_array_tpu_torch").ops.ufuncs.__all__
                 if isinstance(getattr(np, n, None), np.ufunc))
# ufuncs the JAX package's host kernel hands a masked block to jnp (its
# functions are chosen by their module, ``_blockwise.py:143-165``, and
# these are its own wrappers): jax refuses a masked array
JAX_MASKED_REFUSALS = {"copysign", "frexp", "ldexp", "modf", "nextafter", "signbit", "spacing"}


def _operands(uf):
    """Data and a second operand numpy's ufunc takes: floats and 1.5, else
    floats and 2 (``ldexp``), else integers and 2 (shifts, bit ops)."""
    mask = [0, 1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0]
    floats = np.ma.masked_array(np.linspace(-2.5, 2.5, 12), mask=mask)
    ints = np.ma.masked_array(np.arange(-6, 6), mask=mask)
    for src, other in ((floats, 1.5), (floats, 2), (ints, 2)):
        try:
            with np.errstate(all="ignore"):
                uf(*((src,) if uf.nin == 1 else (src, other)))
        except TypeError:
            continue
        return src, other
    raise AssertionError(f"numpy's {uf.__name__} takes none of the operands")


def _ufunc_on_masked(da, name):
    uf = getattr(np, name)
    src, other = _operands(uf)
    x = da.from_array(src, chunks=5)
    got = getattr(da, name)(*((x,) if uf.nin == 1 else (x, other)))
    got = got[0] if isinstance(got, tuple) else got
    with np.errstate(all="ignore"):
        want = uf(src) if uf.nin == 1 else uf(src, other)
    return got.compute(), want[0] if isinstance(want, tuple) else want


@pytest.mark.parametrize("name", _UFUNCS)
def test_every_ufunc_keeps_the_mask_as_numpy_ma_does(name):
    """numpy.ma's counterpart of each port ufunc on masked blocks: the
    mask (with numpy.ma's domain masking) and the values numpy.ma gives.
    The JAX package agrees but where it refuses the masked block."""
    import dask_array_tpu as jda
    import dask_array_tpu_torch as tda

    got, want = _ufunc_on_masked(tda, name)
    assert isinstance(got, np.ma.MaskedArray)
    np.testing.assert_array_equal(np.ma.getmaskarray(got), np.ma.getmaskarray(want))
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got.filled(0), np.ma.asanyarray(want).filled(0), rtol=1e-12)
    if name in JAX_MASKED_REFUSALS:
        with pytest.raises(ValueError, match="masked"):
            _ufunc_on_masked(jda, name)
    else:
        ref, _ = _ufunc_on_masked(jda, name)
        np.testing.assert_array_equal(np.ma.getmaskarray(ref), np.ma.getmaskarray(got))
        np.testing.assert_allclose(ref.filled(0), got.filled(0), rtol=1e-12)


# -- where the JAX package differs from numpy ----------------------------------------

# case -> the difference (each checked to differ from numpy in the JAX
# package and to agree with numpy in the port)
KNOWN_REFERENCE_FAULTS = {
    "concatenate_masked_with_duck": "the JAX package gives masked blocks precedence over duck blocks "
                                    "(ops/stacking.py:196): a masked array comes back where numpy's "
                                    "np.concatenate dispatches to the duck type",
}


class _Duck:
    """A minimal NEP-18 duck array (its concatenation dispatches to it)."""

    def __init__(self, arr):
        self.arr = np.asarray(arr)

    shape = property(lambda self: self.arr.shape)
    dtype = property(lambda self: self.arr.dtype)
    ndim = property(lambda self: self.arr.ndim)

    def __getitem__(self, idx):
        out = self.arr[idx]
        return _Duck(out) if isinstance(out, np.ndarray) else out

    def __array__(self, dtype=None, copy=None):
        return self.arr if dtype is None else self.arr.astype(dtype)

    def __array_function__(self, func, types, args, kwargs):
        def un(v):
            if isinstance(v, _Duck):
                return v.arr
            return type(v)(un(i) for i in v) if isinstance(v, (list, tuple)) else v

        out = func(*un(args), **kwargs)
        return _Duck(out) if isinstance(out, np.ndarray) else out


def _concatenate_masked_with_duck(pkg, monkeypatch):
    da = importlib.import_module(ROOTS[pkg])
    disp = importlib.import_module(f"{ROOTS[pkg]}._dispatch")
    monkeypatch.setattr(disp, "_HANDLED_CHUNK_TYPES", list(disp._HANDLED_CHUNK_TYPES))
    monkeypatch.setattr(disp, "_DUCK_TYPES", disp._DUCK_TYPES)
    disp.register_chunk_type(_Duck)
    m = np.ma.masked_array(np.arange(4.0), mask=[0, 1, 0, 0])
    d = np.arange(4.0, 8.0)
    got = da.concatenate([da.from_array(m, chunks=4), da.from_array(_Duck(d), chunks=4)]).compute()
    return got, np.concatenate([m, _Duck(d)])


@pytest.mark.parametrize("name", sorted(KNOWN_REFERENCE_FAULTS))
def test_known_reference_faults_are_real(name, monkeypatch):
    got_port, want = _concatenate_masked_with_duck("port", monkeypatch)
    assert type(got_port) is type(want) is _Duck
    np.testing.assert_array_equal(got_port.arr, want.arr)
    got_jax, _ = _concatenate_masked_with_duck("jax", monkeypatch)
    assert isinstance(got_jax, np.ma.MaskedArray)
