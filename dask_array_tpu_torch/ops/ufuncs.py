"""The elementwise ufunc table + the ``ufunc`` wrapper class.

Port of ``dask_array_tpu/ops/ufuncs.py``.  Each entry wraps a torch
function in an ``Elemwise`` expression; result dtypes follow numpy (see
``_expr.compute_meta``), and operands are cast to numpy's loop dtypes
before the torch call (``Elemwise._build``).
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from dask_array_tpu_torch._blockwise import elemwise
from dask_array_tpu_torch._chunks import INT64_MIN, uint64_bits


class ufunc:
    """A wrapped elementwise universal function over lazy Arrays."""

    __slots__ = ("_fn", "__name__")

    def __init__(self, fn, name):
        self._fn = fn
        self.__name__ = name

    def __repr__(self):
        return f"<dask_array_tpu_torch ufunc '{self.__name__}'>"

    def __call__(self, *args, **kwargs):
        from dask_array_tpu_torch._collection import Array

        if any(isinstance(a, Array) for a in args):
            return elemwise(self._fn, *args, **kwargs)
        # eager on plain numpy/scalars
        return getattr(np, self.__name__)(*args, **kwargs)


def _numpy_named(np_ufunc):
    """Mark a port function as standing in for ``np_ufunc`` (its name and
    numpy's dtype rules, ``_expr._numpy_equivalent``)."""

    def mark(fn):
        fn.__name__ = fn.__qualname__ = np_ufunc.__name__
        fn.numpy_ufunc = np_ufunc
        return fn

    return mark


def _zero_safe(torch_fn, np_ufunc):
    """``torch_fn`` with numpy's integer division by zero: 0 where the
    divisor is 0.  torch raises on the CPU for it and is undefined on CUDA,
    so the quotient is taken with zero divisors replaced by 1, then 0 is
    selected there.  Float operands pass straight through (inf/nan as in
    numpy)."""

    @_numpy_named(np_ufunc)
    def fn(a, b):
        dtype = torch.result_type(a, b)
        if not isinstance(a, torch.Tensor):  # torch.fmod takes no scalar first
            a = torch.tensor(a, dtype=dtype, device=b.device)
        if dtype.is_floating_point or dtype.is_complex:
            return torch_fn(a, b)
        if isinstance(b, torch.Tensor):
            zero = b == 0
            return torch.where(zero, 0, torch_fn(a, torch.where(zero, 1, b)))
        if b == 0:
            return torch.zeros_like(torch_fn(a, 1))
        return torch_fn(a, b)

    return fn


floor_divide_ = _zero_safe(torch.floor_divide, np.floor_divide)
remainder_ = _zero_safe(torch.remainder, np.remainder)
fmod_ = _zero_safe(torch.fmod, np.fmod)


@_numpy_named(np.absolute)
def absolute_(x):
    """numpy's absolute: a bool array is its own absolute value (torch has
    no bool ``abs``)."""
    return x if x.dtype == torch.bool else torch.abs(x)


@_numpy_named(np.reciprocal)
def reciprocal_(x):
    """numpy's reciprocal: an integer's is the C quotient 1 / x (1 and -1
    keep themselves, everything else gives 0, and so does 0)."""
    if x.is_floating_point() or x.is_complex():
        return torch.reciprocal(x)
    out = (x == 1).to(x.dtype)
    return out - (x == -1).to(x.dtype) if x.dtype.is_signed else out


@_numpy_named(np.rint)
def rint_(x):
    """numpy's rint: half to even, each part of a complex number apart."""
    if x.is_complex():
        return torch.complex(torch.round(x.real), torch.round(x.imag))
    return torch.round(x)


def _complex_sign(z):
    """numpy 2's complex sign: z/|z|, 0 at 0; with |z| infinite, the
    infinite part's sign (NaN where both parts are infinite); NaN where |z|
    is NaN."""
    re, im = z.real, z.imag
    mag = torch.hypot(re, im)
    out_re, out_im = re / mag, im / mag
    inf_re, inf_im = torch.isinf(re), torch.isinf(im)
    nan = torch.full_like(re, float("nan"))
    on_inf = torch.isinf(mag)
    out_re = torch.where(on_inf, torch.where(inf_re, torch.where(inf_im, nan, torch.sign(re)), 0.0), out_re)
    out_im = torch.where(on_inf, torch.where(inf_re, torch.where(inf_im, nan, 0.0), torch.sign(im)), out_im)
    zero = mag == 0
    return torch.complex(torch.where(zero, 0.0, out_re), torch.where(zero, 0.0, out_im))


@_numpy_named(np.sign)
def sign_(x):
    """numpy's sign: NaN stays NaN (torch gives 0), complex by numpy 2's
    rule (torch refuses it)."""
    if x.is_complex():
        return _complex_sign(x)
    if x.is_floating_point():
        return torch.where(torch.isnan(x), x, torch.sign(x))
    return torch.sign(x)


# -- complex ordering: numpy orders complex numbers lexicographically (the
# real part, then the imaginary part); torch has no complex order at all


def _complex_pair(a, b):
    """``(a, b)`` as complex tensors of one dtype when either is complex,
    else None.  A Python scalar becomes a 0-d tensor of the other's dtype
    (numpy casts both operands to the loop dtype first)."""
    ta = a if isinstance(a, torch.Tensor) else None
    tb = b if isinstance(b, torch.Tensor) else None
    if not ((ta is not None and ta.is_complex()) or (tb is not None and tb.is_complex())):
        return None
    ref = ta if ta is not None and ta.is_complex() else tb

    def as_complex(v):
        if isinstance(v, torch.Tensor):
            return v.to(ref.dtype)
        return torch.tensor(v, dtype=ref.dtype, device=ref.device)

    return as_complex(a), as_complex(b)


def _tensors(a, b):
    """``(a, b)`` with a number made a 0-d tensor of the other's dtype
    (torch's extrema take no number; the uint64 loops want int64 bits)."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a, b
    ref = a if isinstance(a, torch.Tensor) else b
    return tuple(v if isinstance(v, torch.Tensor) else torch.tensor(v, dtype=ref.dtype, device=ref.device)
                 for v in (a, b))


def has_nan(z):
    """A NaN in either part of a complex tensor."""
    return torch.isnan(z.real) | torch.isnan(z.imag)


def complex_order(a, b, greater, strict):
    """numpy's complex comparison (its CGT/CGE/CLT/CLE): the real parts
    decide where neither imaginary part is NaN, the imaginary parts where
    the real parts are equal."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    lead = ar > br if greater else ar < br
    if strict:
        tie = ai > bi if greater else ai < bi
    else:
        tie = ai >= bi if greater else ai <= bi
    return (lead & ~torch.isnan(ai) & ~torch.isnan(bi)) | ((ar == br) & tie)


def _ordered(torch_fn, np_ufunc, greater, strict):
    @_numpy_named(np_ufunc)
    def fn(a, b):
        pair = _complex_pair(a, b)
        if pair is None:
            return torch_fn(a, b)
        return complex_order(*pair, greater, strict)

    return fn


def _extremum(torch_fn, np_ufunc, greater, nan_side):
    """numpy's maximum/minimum (``nan_side`` 0: a NaN in the first operand
    wins, else the comparison) and fmax/fmin (``nan_side`` 1: a NaN in the
    second operand loses) of complex operands."""

    @_numpy_named(np_ufunc)
    def fn(a, b):
        pair = _complex_pair(a, b)
        if pair is None:
            return torch_fn(*_tensors(a, b))
        a, b = pair
        keep = has_nan(a if nan_side == 0 else b) | complex_order(a, b, greater, strict=False)
        return torch.where(keep, a, b)

    return fn


greater_ = _ordered(torch.gt, np.greater, greater=True, strict=True)
greater_equal_ = _ordered(torch.ge, np.greater_equal, greater=True, strict=False)
less_ = _ordered(torch.lt, np.less, greater=False, strict=True)
less_equal_ = _ordered(torch.le, np.less_equal, greater=False, strict=False)
maximum_ = _extremum(torch.maximum, np.maximum, greater=True, nan_side=0)
minimum_ = _extremum(torch.minimum, np.minimum, greater=False, nan_side=0)
fmax_ = _extremum(torch.fmax, np.fmax, greater=True, nan_side=1)
fmin_ = _extremum(torch.fmin, np.fmin, greater=False, nan_side=1)

# -- uint64 held as int64 bits (``_chunks``): the loops whose result
# depends on signedness, each on the bits


def _ult(a, b):
    """a < b as uint64 bits: the sign bit flipped, the order is signed."""
    return (a ^ INT64_MIN) < (b ^ INT64_MIN)


_INT64_MAX = ~INT64_MIN
_COMPARE = {"less": operator.lt, "less_equal": operator.le, "greater": operator.gt,
            "greater_equal": operator.ge, "equal": operator.eq, "not_equal": operator.ne}


def _u64_compare(cmp, a, b, ua, ub):
    """numpy's comparison of a uint64 with a uint64 (the order of the flipped
    bits) or with an int64 (a uint64 of 2**63 or more is the larger)."""
    a, b = _tensors(a, b)
    if ua and ub:
        return cmp(a ^ INT64_MIN, b ^ INT64_MIN)
    if ua:
        return torch.where(a < 0, cmp(1, 0), cmp(a, b))
    return torch.where(b < 0, cmp(0, 1), cmp(a, b))


def _u64_divmod(a, b):
    """Unsigned quotient and remainder of uint64 bits, numpy's 0 for a zero
    divisor: a divisor under 2**63 divides the halved dividend (exact in
    int64), doubles and corrects once; a larger one goes 0 or 1 times."""
    a, b = _tensors(a, b)
    zero = b == 0
    b = torch.where(zero, 1, b)
    small = torch.where(b < 0, 1, b)
    q = (((a >> 1) & _INT64_MAX) // small) << 1
    r = a - q * small
    over = ~_ult(r, small)
    q, r = q + over.to(torch.int64), torch.where(over, r - small, r)
    q_big = (~_ult(a, b)).to(torch.int64)
    q = torch.where(b < 0, q_big, q)
    r = torch.where(b < 0, a - q_big * b, r)
    return torch.where(zero, 0, q), torch.where(zero, 0, r)


def _u64_shift(a, s, left):
    """numpy's shift of uint64 bits: logical, and 0 for 64 places or more."""
    a, s = _tensors(a, s)
    inside = (s >= 0) & (s < 64)
    s = torch.where(inside, s, 0)
    if left:
        out = a << s
    else:
        out = (a >> s) & ~((-1 << (63 - s)) << 1)  # the top s bits cleared
    return torch.where(inside, out, 0)


def _u64_extremum(a, b, larger):
    """numpy's maximum (``larger``) or minimum of uint64 bits."""
    a, b = _tensors(a, b)
    return torch.where(_ult(a, b) == larger, b, a)


def _u64_power(a, e):
    """numpy's uint64 power: a product wrapped to 64 bits, square and
    multiply over the exponent's bits."""
    a, e = _tensors(a, e)
    out = torch.ones_like(a)
    for i in range(64):
        out = torch.where(((e >> i) & 1).bool(), out * a, out)
        a = a * a
    return out


_UINT64_LOOPS = {
    "floor_divide": lambda a, b: _u64_divmod(a, b)[0],
    "remainder": lambda a, b: _u64_divmod(a, b)[1],
    "fmod": lambda a, b: _u64_divmod(a, b)[1],
    "right_shift": lambda a, s: _u64_shift(a, s, left=False),
    "left_shift": lambda a, s: _u64_shift(a, s, left=True),
    "power": _u64_power,
    "maximum": lambda a, b: _u64_extremum(a, b, larger=True),
    "minimum": lambda a, b: _u64_extremum(a, b, larger=False),
    "absolute": lambda x: x,
    "sign": lambda x: (x != 0).to(torch.int64),
    "reciprocal": lambda x: (x == 1).to(torch.int64),
}
_UINT64_LOOPS["fmax"] = _UINT64_LOOPS["maximum"]
_UINT64_LOOPS["fmin"] = _UINT64_LOOPS["minimum"]


def compare_outside_range(func, args, loop_dtypes):
    """The result of a comparison of an integer loop with a Python int
    outside its loop dtype's range (numpy 2 compares such ints exactly:
    every uint8 is below 256, every uint64 above -1), else None."""
    from dask_array_tpu_torch._expr import _numpy_equivalent

    cmp = _COMPARE.get(_numpy_equivalent(func).__name__)
    if cmp is None or len(args) != 2:
        return None
    for pos, (v, dt) in enumerate(zip(args, loop_dtypes)):
        dt = np.dtype(dt)
        if dt.kind in "iu" and isinstance(v, int) and not isinstance(v, bool):
            info = np.iinfo(dt)
            if not info.min <= v <= info.max:
                first_smaller = (v < info.min) == (pos == 0)
                other = args[1 - pos]
                return torch.full(other.shape, cmp(0, 1) if first_smaller else cmp(1, 0), dtype=torch.bool,
                                  device=other.device)
    return None


def uint64_loop(func, loop_dtypes):
    """``func`` for operands in numpy loop dtypes of which at least one is
    uint64, held as int64 bits: numpy's unsigned semantics where the result
    depends on signedness (order, division, shifts, power, sign), ``func``
    itself where two's complement gives numpy's bits.  An int operand of a
    uint64 loop becomes its bits."""
    from dask_array_tpu_torch._expr import _numpy_equivalent

    name = _numpy_equivalent(func).__name__
    unsigned = [np.dtype(dt) == np.uint64 for dt in loop_dtypes]

    def loop(*args, **kwargs):
        cmp = _COMPARE.get(name)
        args = [uint64_bits(v) if u and isinstance(v, int) and not isinstance(v, bool) else v
                for v, u in zip(args, unsigned)]
        if cmp is not None:
            return _u64_compare(cmp, *args, *unsigned)
        impl = _UINT64_LOOPS.get(name)
        return impl(*args) if impl is not None else func(*args, **kwargs)

    return loop


# numpy name -> torch function (the Elemwise kernel)
_TABLE = {
    # unary math
    "abs": absolute_,
    "absolute": absolute_,
    "rint": rint_,
    "sign": sign_,
    "exp": torch.exp,
    "exp2": torch.exp2,
    "expm1": torch.expm1,
    "log": torch.log,
    "log2": torch.log2,
    "log10": torch.log10,
    "log1p": torch.log1p,
    "sqrt": torch.sqrt,
    "square": torch.square,
    "reciprocal": reciprocal_,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "deg2rad": torch.deg2rad,
    "rad2deg": torch.rad2deg,
    "invert": torch.bitwise_not,
    "bitwise_not": torch.bitwise_not,
    "negative": torch.neg,
    "positive": torch.positive,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "trunc": torch.trunc,
    "isfinite": torch.isfinite,
    "isinf": torch.isinf,
    "isnan": torch.isnan,
    "logical_not": torch.logical_not,
    "conj": torch.conj_physical,  # not torch.conj: a lazy conj bit is not data
    "conjugate": torch.conj_physical,
    # binary
    "add": torch.add,
    "subtract": torch.sub,
    "multiply": torch.mul,
    "divide": torch.true_divide,
    "true_divide": torch.true_divide,
    "floor_divide": floor_divide_,
    "mod": remainder_,
    "remainder": remainder_,
    "fmod": fmod_,
    "power": torch.pow,
    "arctan2": torch.atan2,
    "hypot": torch.hypot,
    "logaddexp": torch.logaddexp,
    "logaddexp2": torch.logaddexp2,
    "maximum": maximum_,
    "minimum": minimum_,
    "fmax": fmax_,
    "fmin": fmin_,
    "copysign": torch.copysign,
    "bitwise_and": torch.bitwise_and,
    "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor,
    "left_shift": torch.bitwise_left_shift,
    "right_shift": torch.bitwise_right_shift,
    "greater": greater_,
    "greater_equal": greater_equal_,
    "less": less_,
    "less_equal": less_equal_,
    "equal": torch.eq,
    "not_equal": torch.ne,
    "logical_and": torch.logical_and,
    "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
}

_BY_NAME = {name: ufunc(fn, name) for name, fn in _TABLE.items()}
globals().update(_BY_NAME)


def wrap_numpy_ufunc(np_ufunc):
    """Our wrapped equivalent of a numpy ufunc (for NEP-13 dispatch)."""
    return _BY_NAME.get(getattr(np_ufunc, "__name__", None))


__all__ = sorted(_BY_NAME) + ["ufunc", "wrap_numpy_ufunc"]
