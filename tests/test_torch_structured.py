"""Structured (record) dtypes through the port on the CPU, beside the JAX
package, with numpy as the tie-breaker.

Every case of the JAX package's ``tests/test_structured_dtypes.py`` runs
through both packages.  Records stay host numpy (the host lane); a field
is numeric and computes on the device ("field, then arithmetic").
"""

from __future__ import annotations

import importlib
import os

import numpy as np
import pytest
import torch

from dask_array_tpu_torch import config as tconfig

torch.set_num_threads(1)

ROOTS = {"port": "dask_array_tpu_torch", "jax": "dask_array_tpu"}
DT = [("a", "i4"), ("b", "f4")]


@pytest.fixture(autouse=True)
def _cpu_device():
    with tconfig.set({"device": "cpu"}):
        yield


def _rec():
    x = np.empty(12, dtype=[("a", "f8"), ("b", "i4"), ("c", "f4")])
    x["a"] = np.linspace(0, 1, 12)
    x["b"] = np.arange(12)
    x["c"] = 2.0
    return x


def _eq(arr, want):
    got = np.asarray(arr.compute())
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)
    return got


def field_access_reference_case(da, tmp_path):
    x = np.array([(1, 1.0), (2, 2.0)], dtype=DT)
    y = da.from_array(x, chunks=(1,))
    return [_eq(y["a"], x["a"]), _eq(y[["b", "a"]], x[["b", "a"]])]


def field_access_with_shape_reference_case(da, tmp_path):
    dtype = [("col1", ("f4", (3, 2))), ("col2", ("f4", 3))]
    data = np.ones((20, 10), dtype=dtype)
    x = da.from_array(data, 5)
    return [_eq(x["col1"], data["col1"]), _eq(x[["col1"]], data[["col1"]]), _eq(x["col2"], data["col2"]),
            _eq(x[["col1", "col2"]], data[["col1", "col2"]])]


def field_then_arithmetic(da, tmp_path):
    rec = _rec()
    x = da.from_array(rec, chunks=4)
    got = (x["a"] * 2 + x["b"]).compute()
    np.testing.assert_allclose(got, rec["a"] * 2 + rec["b"], rtol=1e-15)
    return [got]


def field_reduction_2d(da, tmp_path):
    rec2 = np.zeros((6, 4), dtype=[("u", "f8"), ("v", "f8")])
    rec2["u"] = np.arange(24).reshape(6, 4)
    got = da.from_array(rec2, chunks=(3, 2))["u"].sum(axis=0).compute()
    np.testing.assert_allclose(got, rec2["u"].sum(axis=0))
    return [got]


def structured_slicing_and_identity(da, tmp_path):
    rec = _rec()
    x = da.from_array(rec, chunks=4)
    return [_eq(x[3:9], rec[3:9]), _eq(x, rec), _eq(x[::-1], rec[::-1])]


def structured_concat_stack_rechunk(da, tmp_path):
    rec = _rec()
    x = da.from_array(rec, chunks=4)
    return [_eq(da.concatenate([x, x]), np.concatenate([rec, rec])), _eq(da.stack([x, x]), np.stack([rec, rec])),
            _eq(x.rechunk(3), rec)]


def structured_npy_stack_roundtrip(da, tmp_path):
    rec = _rec()
    p = os.path.join(str(tmp_path), f"stk-{da.__name__}")
    da.to_npy_stack(p, da.from_array(rec, chunks=4))
    return [_eq(da.from_npy_stack(p), rec)]


def missing_field_raises(da, tmp_path):
    x = da.from_array(_rec(), chunks=4)
    with pytest.raises(KeyError):
        x["zz"]
    with pytest.raises(KeyError):
        x[["a", "zz"]]
    return []


def field_access_on_numeric_raises(da, tmp_path):
    with pytest.raises(IndexError):
        da.ones((4,), chunks=2)["a"]
    return []


def structured_arithmetic_raises(da, tmp_path):
    x = da.from_array(_rec(), chunks=4)
    with pytest.raises(Exception):  # numpy refuses arithmetic on records
        (x + 1).compute()
    return []


CASES = {f.__name__: f for f in (
    field_access_reference_case, field_access_with_shape_reference_case, field_then_arithmetic, field_reduction_2d,
    structured_slicing_and_identity, structured_concat_stack_rechunk, structured_npy_stack_roundtrip,
    missing_field_raises, field_access_on_numeric_raises, structured_arithmetic_raises,
)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_through_both_packages(name, tmp_path):
    port = CASES[name](importlib.import_module(ROOTS["port"]), tmp_path)
    ref = CASES[name](importlib.import_module(ROOTS["jax"]), tmp_path)
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_a_field_computes_on_the_device_and_records_stay_on_the_host():
    import dask_array_tpu_torch as tda
    from dask_array_tpu_torch._executor import to_device

    rec = _rec()
    x = tda.from_array(rec, chunks=4)
    assert isinstance((x["a"] * 2).compute_device(), torch.Tensor)
    assert to_device(rec, torch.device("cpu")) is rec
    assert isinstance(x[["a", "b"]].compute_device(), np.ndarray)


def test_strings_and_objects_slice_concatenate_and_pad_on_the_host():
    """``<U`` and object arrays have no torch dtype: the port raised
    ``TypeError`` for them; they now move on the host lane as numpy does."""
    import dask_array_tpu_torch as tda

    s = np.array(["a", "bc", "d", "efg", "h"])
    x = tda.from_array(s, chunks=2)
    np.testing.assert_array_equal(x[::-1].compute(), s[::-1])
    np.testing.assert_array_equal(tda.concatenate([x, x]).compute(), np.concatenate([s, s]))
    np.testing.assert_array_equal(tda.pad(x, 1, mode="edge").compute(), np.pad(s, 1, mode="edge"))
    np.testing.assert_array_equal(tda.full((3,), "ab", dtype="<U2", chunks=2).compute(), np.full(3, "ab"))
    o = np.array([1, "x", None, 2.5], dtype=object)
    got = tda.from_array(o, chunks=2)[1:].compute()
    assert got.dtype == object and list(got) == list(o[1:])


@pytest.mark.parametrize("which", sorted(ROOTS))
def test_casts_to_and_from_host_only_dtypes(which):
    """``astype`` to strings and objects leaves the card for the host lane;
    strings cast back to floats go to the card again."""
    da = importlib.import_module(ROOTS[which])
    x = np.arange(6.0)
    d = da.from_array(x, chunks=4)
    np.testing.assert_array_equal(d.astype("U5").compute(), x.astype("U5"))
    got = d.astype(object).compute()
    assert got.dtype == object and list(got) == list(x.astype(object))
    s = np.array(["1.5", "2", "3"])
    np.testing.assert_array_equal(da.from_array(s, chunks=2).astype(float).compute(), s.astype(float))


def test_object_reductions_and_arithmetic_stay_object():
    """numpy reduces object arrays to an object; the host lane does too
    (the JAX package's elementwise jit refuses object blocks)."""
    import dask_array_tpu_torch as tda

    o = np.array([1, 2, 3, 10], dtype=object)
    x = tda.from_array(o, chunks=3)
    assert x.sum().dtype == object and x.sum().compute() == 16 and x.max().compute() == 10
    got = (x + 1).compute()
    assert got.dtype == object and list(got) == [2, 3, 4, 11]
    import dask_array_tpu as jda

    with pytest.raises(TypeError):  # the JAX package's difference, checked to differ
        (jda.from_array(o, chunks=3) + 1).compute()
