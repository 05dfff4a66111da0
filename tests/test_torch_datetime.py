"""datetime64/timedelta64 through the port on the CPU, beside the JAX
package, with numpy as the tie-breaker.

Every case of the JAX package's ``tests/test_datetime.py`` runs through
both packages: dtype and values equal to numpy's, and so to each other.
The port holds the blocks as int64 ticks on the device (the unit in the
metadata) and follows numpy where the JAX package's plain tick arithmetic
does not: NaT propagates through ``max``, sums, arithmetic and
comparisons, and operands of two units meet in numpy's loop unit
(``KNOWN_REFERENCE_FAULTS``, each checked to differ).
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


def _t():
    return np.array(["2010-01-01", "2011-06-01", "2009-03-05", "2012-01-01", "2010-07-04"], dtype="M8[D]")


def eq(a, want):
    got = np.asarray(a.compute())
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.array_equal(got.view("i8") if got.dtype.kind in "Mm" else got,
                          want.view("i8") if want.dtype.kind in "Mm" else want), (got, want)
    return got


def roundtrip_slice_concat(da):
    t = _t()
    d = da.from_array(t, chunks=2)
    return [eq(d, t), eq(d[1:4], t[1:4]), eq(da.concatenate([d, d]), np.concatenate([t, t])),
            eq(da.repeat(d, 2), np.repeat(t, 2)), eq(d.rechunk(3), t)]


def datetime_reductions(da):
    t = _t()
    d = da.from_array(t, chunks=2)
    out = [eq(d.max(), t.max()), eq(d.min(), t.min())]
    assert int(d.argmax().compute()) == int(np.argmax(t))
    t2 = t[:4].reshape(2, 2)
    d2 = da.from_array(t2, chunks=1)
    return out + [eq(d2.min(axis=0), t2.min(axis=0)), eq(d2.max(axis=1), t2.max(axis=1))]


def datetime_arithmetic(da):
    t = _t()
    d = da.from_array(t, chunks=2)
    td = t - t[0]
    return [eq(d - d[0], t - t[0]), eq(d + td, t + td), eq(da.diff(d), np.diff(t))]


def datetime_compare_where(da):
    t = _t()
    d = da.from_array(t, chunks=2)
    return [eq(d > t[1], t > t[1]), eq(da.where(d > t[1], d, d[0]), np.where(t > t[1], t, t[0])),
            eq(da.isnull(d), np.isnat(t))]


def datetime_persist(da):
    t = _t()
    d = da.from_array(t, chunks=2).persist()
    assert d.dtype == t.dtype
    return [eq(d, t), eq(d.max(), t.max())]


def timedelta_reductions(da):
    t = _t()
    td = t - t[0]
    d = da.from_array(td, chunks=2)
    return [eq(d.sum(), td.sum()), eq(d.max(), td.max())]


def _unit_conversion(unit):
    def case(da):
        t = np.random.default_rng(5).integers(-40000, 40000, size=200).astype("M8[D]")
        return [eq(da.from_array(t, chunks=37).astype(f"M8[{unit}]"), t.astype(f"M8[{unit}]"))]

    return case


def _unit_conversion_various_sources(srcunit, unit):
    def case(da):
        rng = np.random.default_rng(6)
        if srcunit == "s":
            t = (rng.integers(-40000, 40000, 150) * 86400 + rng.integers(0, 86400, 150)).astype("M8[s]")
        else:
            t = rng.integers(-1000, 1000, size=150).astype("M8[M]")
        return [eq(da.from_array(t, chunks=29).astype(f"M8[{unit}]"), t.astype(f"M8[{unit}]"))]

    return case


def _timedelta_unit_conversion(unit):
    def case(da):
        td = np.random.default_rng(7).integers(-(10**6), 10**6, size=100).astype("m8[s]")
        return [eq(da.from_array(td, chunks=13).astype(f"m8[{unit}]"), td.astype(f"m8[{unit}]"))]

    return case


def datetime_to_int(da):
    t = _t()
    return [eq(da.from_array(t, chunks=2).astype("i8"), t.astype("i8"))]


CASES = {
    "roundtrip_slice_concat": roundtrip_slice_concat,
    "datetime_reductions": datetime_reductions,
    "datetime_arithmetic": datetime_arithmetic,
    "datetime_compare_where": datetime_compare_where,
    "datetime_persist": datetime_persist,
    "timedelta_reductions": timedelta_reductions,
    **{f"datetime_unit_conversion[{u}]": _unit_conversion(u) for u in ["s", "m", "h", "W", "M", "Y", "ms", "ns"]},
    **{f"datetime_unit_conversion_various_sources[{s}-{u}]": _unit_conversion_various_sources(s, u)
       for s, u in [("s", "D"), ("s", "M"), ("s", "Y"), ("M", "D"), ("M", "s"), ("M", "Y")]},
    **{f"timedelta_unit_conversion[{u}]": _timedelta_unit_conversion(u) for u in ["ms", "m", "h", "D"]},
    "datetime_to_int": datetime_to_int,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_through_both_packages(name):
    port = CASES[name](importlib.import_module(ROOTS["port"]))
    ref = CASES[name](importlib.import_module(ROOTS["jax"]))
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind in "fc")


def test_datetime_blocks_are_int64_ticks_on_the_device():
    """The executor holds datetime blocks as int64 ticks (never on the
    host lane); ``compute()`` restores the unit from the metadata."""
    import dask_array_tpu_torch as tda

    t = _t()
    d = tda.from_array(t, chunks=2)
    dev = (d + np.timedelta64(1, "D")).compute_device()
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.int64
    np.testing.assert_array_equal(dev.numpy(), (t + np.timedelta64(1, "D")).view("i8"))


# -- numpy's NaT and unit rules, where the JAX package differs ----------------------


def _nat_data():
    rng = np.random.default_rng(8)
    ticks = rng.integers(-(10**15), 10**15, 64)
    ticks[[3, 17, 40]] = np.iinfo(np.int64).min
    return ticks.view("M8[ns]")


def _nat_max(da):
    t = _nat_data()
    return da.from_array(t, chunks=16).max().compute(), t.max()


def _nat_compare(da):
    t = _nat_data()
    return (da.from_array(t, chunks=16) < t[0]).compute(), t < t[0]


def _nat_not_equal(da):
    t = _nat_data()
    d = da.from_array(t, chunks=16)
    return (d != d).compute(), t != t


def _nat_arithmetic(da):
    t = _nat_data()
    return (da.from_array(t, chunks=16) - t[0]).compute(), t - t[0]


def _mixed_units(da):
    t = _t()
    td = np.arange(5).astype("m8[h]")
    return (da.from_array(t, chunks=2) + da.from_array(td, chunks=2)).compute(), t + td


def _timedelta_sum_with_nat(da):
    td = np.array([1, 2, np.iinfo(np.int64).min, 4], dtype="i8").view("m8[s]")
    return da.from_array(td, chunks=2).sum().compute(), td.sum()


NAT_CASES = {"nat_max": _nat_max, "nat_compare": _nat_compare, "nat_not_equal": _nat_not_equal,
             "nat_arithmetic": _nat_arithmetic, "mixed_units": _mixed_units,
             "timedelta_sum_with_nat": _timedelta_sum_with_nat}

# case -> how the JAX package differs from numpy (each checked to differ)
KNOWN_REFERENCE_FAULTS = {
    "nat_max": "an int64 tick max: NaT (the int64 minimum) never wins, numpy's max is NaT",
    "nat_compare": "NaT compares as the int64 minimum (NaT < t is True), numpy's comparison is False",
    "nat_not_equal": "NaT != NaT is False on ticks, True in numpy",
    "nat_arithmetic": "NaT - t wraps as int64 ticks, numpy gives NaT",
    "mixed_units": "ticks of [D] and [h] are added as they are, numpy converts both to [h]",
    "timedelta_sum_with_nat": "the ticks are summed, numpy's sum is NaT",
}


def _same_as_numpy(got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype != want.dtype:
        return False
    if got.dtype.kind in "Mm":
        return np.array_equal(got.view("i8"), want.view("i8"))
    return np.array_equal(got, want)


@pytest.mark.parametrize("name", sorted(NAT_CASES))
def test_numpys_nat_and_unit_rules(name):
    got, want = NAT_CASES[name](importlib.import_module(ROOTS["port"]))
    assert _same_as_numpy(got, want), (got, want)


@pytest.mark.parametrize("name", sorted(KNOWN_REFERENCE_FAULTS))
def test_known_reference_faults_are_real(name):
    got, want = NAT_CASES[name](importlib.import_module(ROOTS["jax"]))
    assert not _same_as_numpy(got, want)


def test_full_and_pad_of_datetimes():
    """A datetime fill goes to the card as ticks of the array's unit."""
    import dask_array_tpu_torch as tda

    t = _t()
    fill = np.datetime64("2000-01-01")
    eq(tda.full((3,), fill, dtype="M8[D]", chunks=2), np.full(3, fill, dtype="M8[D]"))
    eq(tda.pad(tda.from_array(t, chunks=2), 1, constant_values=fill), np.pad(t, 1, constant_values=fill))
    eq(tda.pad(tda.from_array(t, chunks=2), 2, mode="edge"), np.pad(t, 2, mode="edge"))
