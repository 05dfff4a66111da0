"""Registered duck chunk types through the port on the CPU, beside the
JAX package, with numpy as the tie-breaker.

Every case of the JAX package's ``tests/test_chunk_types.py`` runs through
both packages with the same duck class: the type survives from
``from_array`` to ``compute()`` (the host lane runs numpy's functions,
which dispatch through the type), and the values equal numpy's.  The
registry is process-global: each test registers through ``monkeypatch``,
which restores it, so no type leaks into another file of the run.
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


def _unwrap(x):
    return x.arr if isinstance(x, WrappedArray) else x


class WrappedArray:
    """A minimal NEP-13/NEP-18 duck array wrapping a numpy buffer (the JAX
    package's test double, dask's ``EncapsulateNDArray``)."""

    def __init__(self, arr):
        self.arr = np.asarray(arr)

    shape = property(lambda self: self.arr.shape)
    dtype = property(lambda self: self.arr.dtype)
    ndim = property(lambda self: self.arr.ndim)
    size = property(lambda self: self.arr.size)

    def __len__(self):
        return len(self.arr)

    def __getitem__(self, idx):
        idx = tuple(_unwrap(i) for i in idx) if isinstance(idx, tuple) else _unwrap(idx)
        return _rewrap(self.arr[idx])

    def astype(self, dtype, **kwargs):
        return WrappedArray(self.arr.astype(dtype, **kwargs))

    def reshape(self, *shape):
        return WrappedArray(self.arr.reshape(*shape))

    def __array__(self, dtype=None, copy=None):
        return self.arr.astype(dtype) if dtype is not None else self.arr

    __array_priority__ = 20.0

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if kwargs.get("out") is not None:
            return NotImplemented
        return _rewrap(getattr(ufunc, method)(*(_unwrap(i) for i in inputs), **kwargs))

    def __array_function__(self, func, types, args, kwargs):
        return _rewrap(func(*_tree_unwrap(args), **_tree_unwrap(kwargs)))

    def __add__(self, other):
        return np.add(self, other)

    def __radd__(self, other):
        return np.add(other, self)

    def __mul__(self, other):
        return np.multiply(self, other)

    def __sub__(self, other):
        return np.subtract(self, other)


def _rewrap(x):
    if isinstance(x, (list, tuple)):
        return type(x)(_rewrap(v) for v in x)
    return WrappedArray(x) if isinstance(x, np.ndarray) and x.ndim > 0 else x


def _tree_unwrap(x):
    if isinstance(x, WrappedArray):
        return x.arr
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_unwrap(v) for v in x)
    if isinstance(x, dict):
        return {k: _tree_unwrap(v) for k, v in x.items()}
    return x


class Pkg:
    """One package with ``WrappedArray`` registered in its registry, which
    ``monkeypatch`` restores after the test."""

    def __init__(self, which, monkeypatch):
        self.da = importlib.import_module(ROOTS[which])
        self.disp = importlib.import_module(f"{ROOTS[which]}._dispatch")
        monkeypatch.setattr(self.disp, "_HANDLED_CHUNK_TYPES", list(self.disp._HANDLED_CHUNK_TYPES))
        monkeypatch.setattr(self.disp, "_DUCK_TYPES", self.disp._DUCK_TYPES)
        self.disp.register_chunk_type(WrappedArray)

    def wrapped(self, shape=(10, 8), chunks=(4, 5), seed=0):
        buf = np.random.default_rng(seed).standard_normal(shape)
        return self.da.from_array(WrappedArray(buf), chunks=chunks), buf


def _check(result, expect, exact_type=WrappedArray):
    assert isinstance(result, exact_type), type(result)
    np.testing.assert_allclose(_unwrap(result), expect, rtol=1e-6, atol=1e-12)
    return np.asarray(_unwrap(result))


def registry_predicates(p):
    d = p.disp
    assert d.is_valid_chunk_type(WrappedArray) and d.is_valid_chunk_type(np.ndarray)
    assert d.is_valid_array_chunk(WrappedArray(np.ones(3))) and d.is_valid_array_chunk(np.ones(3))
    assert d.is_valid_array_chunk(None)
    assert d.is_duck_chunk(WrappedArray(np.ones(3)))
    assert not d.is_duck_chunk(np.ones(3)) and not d.is_duck_chunk(np.ma.masked_array([1.0], mask=[True]))
    return []


def masked_is_a_default_chunk_type(p):
    assert p.disp.is_valid_chunk_type(np.ma.MaskedArray)
    return []


def from_array_keeps_duck_type(p):
    x, buf = p.wrapped()
    assert x.dtype == buf.dtype and x.chunks == ((4, 4, 2), (5, 3))
    return [_check(x.compute(), buf)]


def elemwise_preserves_type(p):
    x, buf = p.wrapped()
    return [_check((x + 1).compute(), buf + 1), _check((x * 2 - x).compute(), buf * 2 - buf),
            _check(np.sqrt(np.abs(x)).compute(), np.sqrt(np.abs(buf)))]


def mixed_duck_and_plain_leaves(p):
    x, buf = p.wrapped()
    other = np.arange(8.0)
    return [_check((x + p.da.from_array(other, chunks=5)).compute(), buf + other)]


def binary_op_with_raw_duck_operand_does_not_defer(p):
    x, buf = p.wrapped()
    out = x + WrappedArray(np.ones((10, 8)))
    assert isinstance(out, p.da.Array)
    return [_check(out.compute(), buf + 1)]


def slicing_and_take_preserve_type(p):
    x, buf = p.wrapped()
    return [_check(x[2:7, 1:].compute(), buf[2:7, 1:]), _check(x[[3, 1, 7]].compute(), buf[[3, 1, 7]]),
            _check(x[:, [0, 6, 2]].compute(), buf[:, [0, 6, 2]])]


def transpose_squeeze_reshape(p):
    x, buf = p.wrapped()
    y = p.da.from_array(WrappedArray(buf[None]), chunks=(1, 4, 5))
    return [_check(x.T.compute(), buf.T), _check(y.squeeze(axis=0).compute(), buf),
            _check(x.reshape(20, 4).compute(), buf.reshape(20, 4))]


def concatenate_stack_preserve_type(p):
    x, buf = p.wrapped()
    y, buf2 = p.wrapped(seed=1)
    return [_check(p.da.concatenate([x, y], axis=0).compute(), np.concatenate([buf, buf2], 0)),
            _check(p.da.stack([x, y], axis=0).compute(), np.stack([buf, buf2], 0))]


def rechunk_preserves_type(p):
    x, buf = p.wrapped()
    return [_check(x.rechunk((3, 8)).compute(), buf)]


def reductions_preserve_type(p):
    x, buf = p.wrapped()
    got_max = x.max().compute()
    np.testing.assert_allclose(float(_unwrap(got_max)), buf.max())
    return [_check(x.sum(axis=0).compute(), buf.sum(axis=0)), _check(x.mean(axis=1).compute(), buf.mean(axis=1)),
            np.asarray(_unwrap(got_max))]


def argreduction_on_duck(p):
    x, buf = p.wrapped()
    got = np.asarray(_unwrap(x.argmax(axis=0).compute()))
    np.testing.assert_array_equal(got, buf.argmax(axis=0))
    return [got]


def cumsum_preserves_type(p):
    x, buf = p.wrapped()
    return [_check(x.cumsum(axis=0).compute(), buf.cumsum(axis=0))]


def map_blocks_with_duck_kernel(p):
    x, buf = p.wrapped()
    return [_check(x.map_blocks(lambda b: b * 2, dtype=x.dtype).compute(), buf * 2)]


def compute_many_returns_duck(p):
    x, buf = p.wrapped()
    a, b = p.da.compute(x + 1, x.sum(axis=0))
    return [_check(a, buf + 1), _check(b, buf.sum(axis=0))]


def unregistered_duck_densifies_via_array(p):
    class Plain:
        def __init__(self, arr):
            self.arr = np.asarray(arr)

        shape = property(lambda self: self.arr.shape)
        dtype = property(lambda self: self.arr.dtype)
        ndim = property(lambda self: self.arr.ndim)

        def __getitem__(self, idx):
            return self.arr[idx]

        def __array__(self, dtype=None, copy=None):
            return self.arr

    buf = np.arange(12.0).reshape(3, 4)
    out = (p.da.from_array(Plain(buf), chunks=2) + 1).compute()
    assert not isinstance(out, WrappedArray)
    np.testing.assert_array_equal(np.asarray(out), buf + 1)
    return [np.asarray(out)]


CASES = {f.__name__: f for f in (
    registry_predicates, masked_is_a_default_chunk_type, from_array_keeps_duck_type, elemwise_preserves_type,
    mixed_duck_and_plain_leaves, binary_op_with_raw_duck_operand_does_not_defer, slicing_and_take_preserve_type,
    transpose_squeeze_reshape, concatenate_stack_preserve_type, rechunk_preserves_type, reductions_preserve_type,
    argreduction_on_duck, cumsum_preserves_type, map_blocks_with_duck_kernel, compute_many_returns_duck,
    unregistered_duck_densifies_via_array,
)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_through_both_packages(name, monkeypatch):
    port = CASES[name](Pkg("port", monkeypatch))
    ref = CASES[name](Pkg("jax", monkeypatch))
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("which", sorted(ROOTS))
def test_the_registry_is_restored_after_a_test(which):
    """``monkeypatch`` put the registry back: no test left a type in it."""
    disp = importlib.import_module(f"{ROOTS[which]}._dispatch")
    assert not disp.is_valid_chunk_type(WrappedArray) and disp._DUCK_TYPES == ()


def test_register_chunk_type_is_public():
    import dask_array_tpu_torch as tda
    from dask_array_tpu_torch._dispatch import register_chunk_type

    assert tda.register_chunk_type is register_chunk_type and "register_chunk_type" in tda.__all__


# case -> how the JAX package differs from numpy and dask (each checked to differ)
KNOWN_REFERENCE_FAULTS = {
    "is_valid_chunk_type_of_a_non_type": "the JAX package's issubclass raises TypeError for an instance "
                                         "(_dispatch.py:129); dask answers False",
}


@pytest.mark.parametrize("name", sorted(KNOWN_REFERENCE_FAULTS))
def test_known_reference_faults_are_real(name):
    from dask_array_tpu._dispatch import is_valid_chunk_type as jax_valid

    from dask_array_tpu_torch._dispatch import is_valid_chunk_type

    assert is_valid_chunk_type(np.ones(3)) is False
    with pytest.raises(TypeError):
        jax_valid(np.ones(3))


# -- every ufunc of the port on a duck block ------------------------------------------

_UFUNCS = sorted(n for n in __import__("dask_array_tpu_torch").ops.ufuncs.__all__
                 if isinstance(getattr(np, n, None), np.ufunc))
# ufuncs the JAX package's host kernel hands to its own wrappers (chosen by
# module, ``_blockwise.py:179-194``), which refuse a duck block
JAX_DUCK_REFUSALS = {"copysign", "frexp", "ldexp", "modf", "nextafter", "signbit", "spacing"}


def _ufunc_operands(uf):
    """Data and a second operand numpy's ufunc takes: floats and 1.5, else
    floats and 2 (``ldexp``), else integers and 2 (shifts, bit ops)."""
    for src, other in ((np.linspace(-2.5, 2.5, 12), 1.5), (np.linspace(-2.5, 2.5, 12), 2), (np.arange(-6, 6), 2)):
        try:
            with np.errstate(all="ignore"):
                uf(*((src,) if uf.nin == 1 else (src, other)))
        except TypeError:
            continue
        return src, other
    raise AssertionError(f"numpy's {uf.__name__} takes none of the operands")


def _ufunc_on_duck(p, name):
    uf = getattr(np, name)
    buf, other = _ufunc_operands(uf)
    x = p.da.from_array(WrappedArray(buf), chunks=5)
    got = getattr(p.da, name)(*((x,) if uf.nin == 1 else (x, other)))
    with np.errstate(all="ignore"):
        want = uf(buf) if uf.nin == 1 else uf(buf, other)
    return (got[0] if isinstance(got, tuple) else got).compute(), want[0] if isinstance(want, tuple) else want


@pytest.mark.parametrize("name", _UFUNCS)
def test_every_ufunc_keeps_the_duck_type(name, monkeypatch):
    """numpy's ufunc on a duck block dispatches through the type: the type
    and numpy's values come back.  The JAX package agrees but where its
    own wrappers refuse the duck block."""
    got, want = _ufunc_on_duck(Pkg("port", monkeypatch), name)
    assert isinstance(got, WrappedArray) and got.dtype == want.dtype
    np.testing.assert_allclose(got.arr, want, rtol=1e-12, equal_nan=True)
    if name in JAX_DUCK_REFUSALS:
        with pytest.raises(TypeError):
            _ufunc_on_duck(Pkg("jax", monkeypatch), name)
    else:
        ref, _ = _ufunc_on_duck(Pkg("jax", monkeypatch), name)
        np.testing.assert_allclose(np.asarray(_unwrap(ref)), got.arr, rtol=1e-12, equal_nan=True)


def test_push_on_a_duck_block(monkeypatch):
    """``push`` (forward fill) of a duck block runs numpy's functions,
    which dispatch through the type: the type and the filled values."""
    p = Pkg("port", monkeypatch)
    buf = np.array([[1.0, np.nan, np.nan, 4.0, np.nan], [np.nan, 2.0, np.nan, np.nan, np.nan]])
    got = p.da.push(p.da.from_array(WrappedArray(buf), chunks=(2, 5)), n=1, axis=1).compute()
    want = np.array([[1.0, 1.0, np.nan, 4.0, 4.0], [np.nan, 2.0, 2.0, np.nan, np.nan]])
    assert isinstance(got, WrappedArray)
    np.testing.assert_array_equal(got.arr, want)
