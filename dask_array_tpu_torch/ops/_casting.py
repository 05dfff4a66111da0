"""dtype casting as an elementwise expression (``Array.astype``), and the
datetime shim.

Port of ``dask_array_tpu/ops/_casting.py``.  datetime64/timedelta64 blocks
live on the device as int64 ticks (``_chunks.device_dtype``); the unit
stays in the metadata.  A cast between units converts the ticks on the
device: linear units by an integer ratio, calendar units (months, years)
through the civil calendar in integer torch ops.  NaT, the int64 minimum,
stays NaT.  ``datetime_call`` runs an elementwise function of datetime
operands as numpy's loop says: each operand in the loop's unit, NaT
propagated as numpy propagates it.  Host-only dtypes (records, strings,
objects) cast on the host with numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from dask_array_tpu_torch._blockwise import Elemwise
from dask_array_tpu_torch._chunks import INT64_MIN, cast, host_only_dtype


def _np_astype(x, dtype=None, src_dtype=None):
    """numpy's ``astype`` (the metadata of ``_astype``, and its form for
    host blocks)."""
    return x.astype(np.dtype(dtype))


def _astype(x, dtype=None, src_dtype=None):
    """numpy's ``astype`` of a block (``_chunks.cast``: floats to unsigned
    truncate toward zero then wrap, uint64 converts from and to its bits;
    datetime ticks change unit by ``convert_ticks``)."""
    dt = np.dtype(dtype)
    if not isinstance(x, torch.Tensor):
        return x.astype(dt)
    src = np.dtype(src_dtype) if src_dtype is not None else None
    if src is not None and src.kind in "Mm" and dt.kind in "Mm":
        return convert_ticks(x, src, dt)
    if host_only_dtype(dt):
        from dask_array_tpu_torch._host import host_array

        return host_array(x).astype(dt)
    return cast(x, dt)


_astype.numpy_function = _np_astype
_astype.ticks_aware = True
_astype.narrow_convert = True  # a narrow side converts by ``_chunks.convert``
_astype.numpy_strict = True  # a cast numpy refuses (uint2 to int4) raises


# fixed-length units in seconds, as (numerator, denominator); the calendar
# units M and Y are apart
_LINEAR_SECONDS = {
    "W": (604800, 1), "D": (86400, 1), "h": (3600, 1), "m": (60, 1), "s": (1, 1),
    "ms": (1, 10**3), "us": (1, 10**6), "ns": (1, 10**9),
    "ps": (1, 10**12), "fs": (1, 10**15), "as": (1, 10**18),
}
_CALENDAR = ("M", "Y")


def _unit_ratio(src_u, dst_u):
    """(mul, div): ticks in ``dst_u`` are ticks in ``src_u`` * mul // div."""
    sn, sd = _LINEAR_SECONDS[src_u]
    dn, dd = _LINEAR_SECONDS[dst_u]
    num, den = sn * dd, sd * dn
    g = np.gcd(num, den)
    return num // g, den // g


def _floor(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _scale(ticks, mul, div):
    out = ticks * mul if mul != 1 else ticks
    return _floor(out, div) if div != 1 else out


def _days_to_months(days):
    """Days since 1970-01-01 to months since 1970-01: Howard Hinnant's
    ``civil_from_days`` in integer torch ops."""
    z = days + 719468
    era = _floor(z, 146097)
    doe = z - era * 146097
    yoe = _floor(doe - _floor(doe, 1460) + _floor(doe, 36524) - _floor(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floor(yoe, 4) - _floor(yoe, 100))
    mp = _floor(5 * doy + 2, 153)
    m = mp + torch.where(mp < 10, 3, -9)  # 1..12
    y = y + (m <= 2).to(y.dtype)
    return (y - 1970) * 12 + (m - 1)


def _months_to_days(months):
    """Months since 1970-01 to the day count of the month's first day."""
    y = 1970 + _floor(months, 12)
    m = torch.remainder(months, 12) + 1  # 1..12
    y = y - (m <= 2).to(y.dtype)
    era = _floor(y, 400)
    yoe = y - era * 400
    mp = m + torch.where(m > 2, -3, 9)
    doy = _floor(153 * mp + 2, 5)
    doe = yoe * 365 + _floor(yoe, 4) - _floor(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _convert(ticks, src, dt):
    src_u = np.datetime_data(src)[0]
    dst_u = np.datetime_data(dt)[0]
    if src_u == dst_u:
        return ticks
    if src_u not in _CALENDAR and dst_u not in _CALENDAR:
        return _scale(ticks, *_unit_ratio(src_u, dst_u))
    if dt.kind == "M" and src.kind == "M":
        # absolute dates: through days and months of the civil calendar
        if src_u in _CALENDAR and dst_u in _CALENDAR:
            return ticks * 12 if src_u == "Y" else _floor(ticks, 12)
        if src_u in _CALENDAR:
            days = _months_to_days(ticks * 12 if src_u == "Y" else ticks)
            return _scale(days, *_unit_ratio("D", dst_u))
        months = _days_to_months(_scale(ticks, *_unit_ratio(src_u, "D")))
        return _floor(months, 12) if dst_u == "Y" else months
    # a timedelta in calendar units: numpy's unsafe cast by its mean ratio
    one = int(np.timedelta64(1, src_u).astype(f"m8[{dst_u}]", casting="unsafe").view("i8"))
    if one >= 1:
        return ticks * one
    inv = int(np.timedelta64(1, dst_u).astype(f"m8[{src_u}]", casting="unsafe").view("i8"))
    return _floor(ticks, inv)


def convert_ticks(t: torch.Tensor, src, dt) -> torch.Tensor:
    """int64 ticks of datetime/timedelta dtype ``src`` as ticks of ``dt``
    (numpy's ``astype`` between units); NaT stays NaT."""
    src, dt = np.dtype(src), np.dtype(dt)
    ticks = t.to(torch.int64)
    if np.datetime_data(src)[0] == np.datetime_data(dt)[0]:
        return ticks
    return torch.where(ticks == INT64_MIN, INT64_MIN, _convert(ticks, src, dt))


def is_datetime(a) -> bool:
    """A datetime64/timedelta64 operand: an expression or a numpy scalar."""
    dt = getattr(a, "dtype", None)
    return isinstance(dt, np.dtype) and dt.kind in "Mm"


_NAT_FALSE = frozenset({np.less, np.less_equal, np.greater, np.greater_equal, np.equal})


def datetime_call(func, exprs, values, out_dtype, kwargs):
    """``func`` on int64 ticks of datetime operands, as numpy computes it.

    ``exprs`` are the node's operands (expressions, which carry the units,
    or numbers), ``values`` their built values.  A numpy ufunc's loop
    dtypes give each operand's unit; any other function (``where``) takes
    its datetime operands in the result's unit.  Through a ufunc NaT
    propagates: a datetime result is NaT, a float NaN, a comparison False
    (``!=`` True) wherever an operand is NaT."""
    from dask_array_tpu_torch._expr import _numpy_equivalent

    np_fn = _numpy_equivalent(func)
    logical = [e.dtype if hasattr(e, "dtype") else type(e) for e in exprs]
    if np_fn is not None:
        loop = np_fn.resolve_dtypes(tuple(logical) + (None,) * np_fn.nout)[: np_fn.nin]
    else:
        loop = [out_dtype if is_datetime(e) and out_dtype.kind in "Mm" else lg for e, lg in zip(exprs, logical)]
    device = next(v.device for v in values if isinstance(v, torch.Tensor))
    operands, nat = [], None
    for e, v, lg, want in zip(exprs, values, logical, loop):
        if isinstance(v, torch.Tensor):
            if is_datetime(e) and np.dtype(want).kind in "Mm":
                v = convert_ticks(v, lg, want)
                hit = v == INT64_MIN
                nat = hit if nat is None else nat | hit
            elif not isinstance(want, type):
                from dask_array_tpu_torch._chunks import to_compute

                v = to_compute(v, np.dtype(want))
        elif isinstance(v, (np.datetime64, np.timedelta64)):
            if np.isnat(v):
                nat = torch.ones((), dtype=torch.bool, device=device) if nat is None else nat | True
            v = int(v.astype(want).view("i8"))
        operands.append(v)
    out = func(*operands, **kwargs)
    if nat is None or np_fn is None:
        return out  # (a function that moves values, as where, moves NaT too)
    kind = np.dtype(out_dtype).kind
    if kind in "Mm":
        return torch.where(nat, INT64_MIN, out)
    if kind in "fc":
        return torch.where(nat, torch.nan, out)
    if kind == "b" and np_fn is np.not_equal:
        return out | nat
    if kind == "b" and np_fn in _NAT_FALSE:
        return out & ~nat
    return out


def astype_expr(expr, dtype):
    dtype = np.dtype(dtype)
    if expr.dtype == dtype:
        return expr
    if expr.dtype.kind in "Mm" and dtype.kind in "Mm":
        # the ticks' unit is in the metadata only: the cast carries it
        return Elemwise(_astype, (("dtype", dtype), ("src_dtype", expr.dtype)), expr)
    return Elemwise(_astype, (("dtype", dtype),), expr)
