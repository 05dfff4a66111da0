"""ml_dtypes' narrow types held as 1-byte bit patterns.

torch has no dtype for ``int2``, ``uint2``, ``int4``, ``uint4``,
``float4_e2m1fn``, ``float8_e3m4``, ``float8_e4m3``,
``float8_e4m3b11fnuz`` or ``float8_e8m0fnu`` that it computes in, so a
block of one of them is held as its bit pattern in a ``torch.uint8``
carrier (numpy's ml_dtypes arrays are one element a byte, and cross as
uint8).  A value is computed by decoding the pattern to float32 (int32
for the integer types), computing, and encoding back: the decode, op and
round that XLA inserts on the CPU, and that ml_dtypes' own loops do.

Each format is given by its parameters (``Format``); the 256-entry decode
table and the encode are built from them, never read from ml_dtypes (the
tests hold both against ml_dtypes' ``astype`` for every pattern).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Format:
    """One narrow type.

    ``kind`` is "int", "uint" or "float".  A float has ``ebits`` exponent
    and ``mbits`` mantissa bits under ``bias``; ``special`` says where its
    NaN and infinities sit ("ieee": an all-ones exponent, infinity with a
    zero mantissa; "fn": NaN only at all ones; "fnuz": NaN at the negative
    zero's pattern, no infinity, no -0; "e8m0": an unsigned exponent, NaN
    at all ones and no zero; "none": finite only); ``overflow`` what a
    value past the largest finite one becomes ("inf", "nan" or
    "saturate"); ``ties`` how a value halfway between two neighbours
    rounds ("even": to the even pattern; "up": to the larger)."""

    name: str
    bits: int
    kind: str
    ebits: int = 0
    mbits: int = 0
    bias: int = 0
    special: str = "none"
    overflow: str = "saturate"
    ties: str = "even"

    @property
    def is_float(self) -> bool:
        return self.kind == "float"

    @property
    def signed(self) -> bool:
        return self.kind == "int" or (self.is_float and self.special != "e8m0")

    @property
    def mask(self) -> int:
        return (1 << self.bits) - 1


FORMATS = {f.name: f for f in (
    Format("int2", 2, "int"),
    Format("uint2", 2, "uint"),
    Format("int4", 4, "int"),
    Format("uint4", 4, "uint"),
    Format("float4_e2m1fn", 4, "float", 2, 1, 1, "none", "saturate"),
    Format("float8_e3m4", 8, "float", 3, 4, 3, "ieee", "inf"),
    Format("float8_e4m3", 8, "float", 4, 3, 7, "ieee", "inf"),
    Format("float8_e4m3b11fnuz", 8, "float", 4, 3, 11, "fnuz", "nan"),
    Format("float8_e8m0fnu", 8, "float", 8, 0, 127, "e8m0", "nan", "up"),
)}
NAMES = tuple(FORMATS)
# the float8 types torch holds as dtypes of its own.  torch computes in none
# of them, and its conversion from float32 differs from ml_dtypes' (it
# saturates float8_e4m3fn's overflow, and makes other NaN patterns), so a
# value computed in float32 is encoded by its format too
# (``_chunks.as_stored``); the held tensor is its patterns' view
HELD = {f.name: f for f in (
    Format("float8_e4m3fn", 8, "float", 4, 3, 7, "fn", "nan"),
    Format("float8_e5m2", 8, "float", 5, 2, 15, "ieee", "inf"),
    Format("float8_e4m3fnuz", 8, "float", 4, 3, 8, "fnuz", "nan"),
    Format("float8_e5m2fnuz", 8, "float", 5, 2, 16, "fnuz", "nan"),
)}
_ALL = {**FORMATS, **HELD}


def format_of(dt):
    """The ``Format`` of numpy dtype ``dt``, or None for any other dtype."""
    try:
        dt = np.dtype(dt)
    except TypeError:
        return None
    if dt.names is not None or getattr(dt.type, "__module__", "") != "ml_dtypes":
        return None
    return FORMATS.get(dt.name)


def compute_dtype(fmt: Format) -> torch.dtype:
    """What a value of ``fmt`` is computed in: float32, or int32 for the
    integer types."""
    return torch.float32 if fmt.is_float else torch.int32


def _float_value(fmt: Format, pattern: int) -> float:
    """The value of one pattern of a float format (a byte: a set bit at or
    above the sign bit's place makes it negative, as ml_dtypes reads it)."""
    if fmt.special == "e8m0":
        return float("nan") if pattern == 0xFF else 2.0 ** (pattern - fmt.bias)
    sign_at = fmt.bits - 1
    negative = pattern >= (1 << sign_at)
    mag = pattern & ((1 << sign_at) - 1)
    if fmt.special == "fnuz" and pattern == 0x80:
        return -float("nan")  # ml_dtypes reads it as a negative NaN
    exp, man = mag >> fmt.mbits, mag & ((1 << fmt.mbits) - 1)
    top = (1 << fmt.ebits) - 1
    if fmt.special == "ieee" and exp == top:
        value = float("inf") if man == 0 else float("nan")
    elif fmt.special == "fn" and exp == top and man == (1 << fmt.mbits) - 1:
        value = float("nan")
    elif exp == 0:
        value = man * 2.0 ** (1 - fmt.bias - fmt.mbits)
    else:
        value = (1 + man / (1 << fmt.mbits)) * 2.0 ** (exp - fmt.bias)
    return -value if negative else value


@functools.lru_cache(maxsize=None)
def decode_table(name: str) -> np.ndarray:
    """The value of each of the 256 bytes as a ``name`` element: float32,
    or int32 for an integer type (the low ``bits`` bits, sign-extended for
    a signed one)."""
    fmt = _ALL[name]
    p = np.arange(256)
    if not fmt.is_float:
        low = p & fmt.mask
        if fmt.kind == "int":
            low = np.where(low >= 1 << (fmt.bits - 1), low - (1 << fmt.bits), low)
        return low.astype(np.int32)
    return np.array([_float_value(fmt, int(b)) for b in p], dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _rounding(name: str):
    """The encode's tables for a float format: the finite magnitudes in
    order with their patterns, one past the largest (the next binade's
    first value, whose pattern is the overflow's), and the midpoints
    between neighbours (exact in float32)."""
    fmt = _ALL[name]
    table = decode_table(name).astype(np.float64)
    limit = 1 << (fmt.bits - 1) if fmt.signed else 256
    pats = [p for p in range(limit) if np.isfinite(table[p]) and not (fmt.special == "fnuz" and p == 0x80)]
    pats.sort(key=lambda p: table[p])
    vals = [table[p] for p in pats]
    top = vals[-1]
    step = top - vals[-2] if fmt.mbits else top
    vals.append(top + step)  # the next binade's first value: an even pattern
    pats.append(-1)
    mids = [(a + b) / 2 for a, b in zip(vals[:-1], vals[1:])]
    even = [p == -1 or p % 2 == 0 for p in pats]
    return (np.array(pats, np.int64), np.array(mids, np.float64), np.array(even))


def _nan_pattern(fmt: Format) -> int:
    if fmt.special == "ieee":
        return (((1 << fmt.ebits) - 1) << fmt.mbits) | (1 << (fmt.mbits - 1))
    if fmt.special == "fn":
        return (1 << (fmt.bits - 1)) - 1
    return 0x80 if fmt.special == "fnuz" else 0xFF


def _overflow_pattern(fmt: Format) -> int:
    if fmt.overflow == "inf":
        return ((1 << fmt.ebits) - 1) << fmt.mbits
    if fmt.overflow == "nan":
        return _nan_pattern(fmt)
    return (1 << (fmt.bits - 1)) - 1  # the largest finite magnitude


@functools.lru_cache(maxsize=None)
def _device_tables(name: str, device: torch.device):
    fmt = _ALL[name]
    table = torch.from_numpy(decode_table(name)).to(device)
    if not fmt.is_float:
        return table, None
    pats, mids, even = _rounding(name)
    pats = np.where(pats < 0, _overflow_pattern(fmt), pats)
    return table, (torch.from_numpy(pats.astype(np.int32)).to(device),
                   torch.from_numpy(mids.astype(np.float32)).to(device),
                   torch.from_numpy(even).to(device))


def decode(t: torch.Tensor, fmt: Format) -> torch.Tensor:
    """The values of a carrier ``t`` (uint8 patterns) in
    ``compute_dtype(fmt)``: one lookup in the 256-entry table."""
    table, _ = _device_tables(fmt.name, t.device)
    return table[t.to(torch.int32)]


def encode(v: torch.Tensor, fmt: Format) -> torch.Tensor:
    """The patterns of values ``v`` as a uint8 carrier of ``fmt``, as
    ml_dtypes' ``astype`` makes them.

    An integer type keeps the low bits of an integer value; a float value
    is truncated to int32 first (one out of int32's range, a NaN or an
    infinity gives int32's minimum, whose low bits are 0, as x86's
    conversion gives).  A float type rounds the float32 value (a float64
    is rounded to float32 first, as ml_dtypes converts it) to the nearest
    magnitude, ties by the format's rule, past the largest to its overflow
    pattern; then the sign, NaN and zero rules of the format."""
    if v.dtype == torch.bool:
        v = v.to(torch.int32)
    if not fmt.is_float:
        if v.is_floating_point():
            inside = (v > -(2.0**31) - 1) & (v < 2.0**31)
            v = torch.where(inside, torch.nan_to_num(v).trunc(), 0).to(torch.int64)
        return (v.to(torch.int64) & fmt.mask).to(torch.uint8)
    v = v.to(torch.float32)  # integers and float64 round to float32 first, as in ml_dtypes
    _, (pats, mids, even) = _device_tables(fmt.name, v.device)
    a = v.abs()
    j = torch.searchsorted(mids, a, out_int32=True)
    last = mids.numel()
    jn = torch.clamp(j, max=last - 1)
    tie = a == mids[jn]
    if fmt.ties == "up":
        j = torch.where(tie, j + 1, j)
    else:
        j = torch.where(tie & ~even[torch.clamp(j, max=last)], j + 1, j)
    out = pats[torch.clamp(j, max=last)]
    nan = torch.isnan(v)
    negative = torch.signbit(v)
    out = torch.where(torch.isinf(v), _overflow_pattern(fmt), out)
    if fmt.special == "e8m0":
        # under float32's normal range a value past 2**-127 goes up
        tiny = a < 2.0**-126
        out = torch.where(tiny, (a > 2.0**-127).to(out.dtype), out)
        return torch.where(nan | negative | (v == 0), 0xFF, out).to(torch.uint8)
    sign = 1 << (fmt.bits - 1)
    if fmt.special == "fnuz":
        out = torch.where(negative & (out != 0), out | sign, out)
    else:
        out = torch.where(negative, out | sign, out)
    if fmt.special == "none":
        # finite only: a NaN is a zero of the other sign, as ml_dtypes has it
        return torch.where(nan, torch.where(negative, 0, sign), out).to(torch.uint8)
    if fmt.special in ("ieee", "fn"):
        nan_out = torch.where(negative, _nan_pattern(fmt) | sign, _nan_pattern(fmt))
        return torch.where(nan, nan_out, out).to(torch.uint8)
    return torch.where(nan, _nan_pattern(fmt), out).to(torch.uint8)


def recast(t: torch.Tensor, src: Format, dst: Format) -> torch.Tensor:
    """A carrier of ``src`` as one of ``dst``, converted as ml_dtypes
    converts: through float32 (int32 between two integer types)."""
    if src == dst:
        return t
    return encode(decode(t, src), dst)
