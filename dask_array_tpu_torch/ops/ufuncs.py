"""The elementwise ufunc table + the ``ufunc`` wrapper class.

Port of ``dask_array_tpu/ops/ufuncs.py``.  Each entry wraps a torch
function in an ``Elemwise`` expression; result dtypes follow numpy (see
``_expr.compute_meta``), and operands are cast to numpy's loop dtypes
before the torch call (``Elemwise._build``).
"""

from __future__ import annotations

import functools
import operator

import numpy as np
import torch

from dask_array_tpu_torch._blockwise import elemwise
from dask_array_tpu_torch._chunks import INT64_MIN, computable, compute_dtype, numpy_dtype, to_compute, uint64_bits


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
        np_fn = getattr(np, self.__name__, None)
        if np_fn is not None:
            return np_fn(*args, **kwargs)
        return self._fn(*args, **kwargs)


def _numpy_named(np_ufunc, name=None, output=None, strict=False):
    """Mark a port function as standing in for ``np_ufunc`` (its name and
    numpy's dtype rules, ``_expr._numpy_equivalent``).  ``output`` picks one
    output of a ufunc of several; ``strict`` makes numpy's refusal of the
    operands raise (no torch guess).  ``name`` sets the function's name,
    which is its token: two functions must not share one."""

    def mark(fn):
        fn.__name__ = fn.__qualname__ = name or np_ufunc.__name__
        fn.numpy_ufunc = np_ufunc
        if output is not None:
            fn.numpy_output = output
        if strict:
            fn.numpy_strict = True
        return fn

    return mark


def _numpy_function(np_fn, name=None):
    """Mark a port function as standing in for numpy's non-ufunc ``np_fn``:
    metadata comes from numpy (its refusals raise), and the function takes
    its operands as given (held blocks, numbers, numpy scalars) and
    converts them itself (``numpy_operands``)."""

    def mark(fn):
        fn.__name__ = fn.__qualname__ = name or np_fn.__name__
        fn.numpy_function = np_fn
        fn.numpy_strict = True
        return fn

    return mark


def _device_of(args):
    return next((a.device for a in args if isinstance(a, torch.Tensor)), torch.device("cpu"))


def as_operand(a, dt, device):
    """One operand as a tensor in ``compute_dtype(dt)``: a held block
    converted as numpy's ``astype(dt)`` converts it; a number, numpy
    scalar or numpy array converted by numpy (a Python int out of an integer type's range
    wraps, as numpy's ``where`` wraps it)."""
    if isinstance(a, torch.Tensor):
        return to_compute(a, dt)
    with np.errstate(all="ignore"):
        v = np.asarray(a).astype(dt)
    return to_compute(torch.from_numpy(v.copy()), dt).to(device)


def numpy_operands(*args, device=None):
    """numpy's result dtype of ``args`` (held blocks by their numpy dtype,
    Python numbers weak as NEP 50 says, numpy scalars strong) and each
    operand as a tensor of it (``as_operand``)."""
    spec = [numpy_dtype(a.dtype) if isinstance(a, torch.Tensor) else a for a in args]
    dt = np.result_type(*spec)
    device = device or _device_of(args)
    return dt, [as_operand(a, dt, device) for a in args]


@functools.lru_cache(maxsize=None)
def _result_dtype(np_fn, dt, kwargs=()):
    with np.errstate(all="ignore"):
        return np.asarray(np_fn(np.ones(1, dt), **dict(kwargs))).dtype


def numpy_result(np_fn, x, **kwargs):
    """The dtype numpy's ``np_fn`` gives for a held block ``x``."""
    return _result_dtype(np_fn, numpy_dtype(x.dtype), tuple(sorted(kwargs.items())))


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
            out = torch_fn(a, b)
            if np_ufunc is np.remainder and dtype.is_floating_point:
                # numpy's zero remainder takes the divisor's sign (-0.0 % 2 is 0.0)
                out = torch.where(out == 0, torch.copysign(torch.zeros_like(out), torch.as_tensor(b, device=out.device)), out)
            return out
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


@_numpy_named(np.sign, strict=True)
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


def _u64_gcd(a, b):
    """numpy's gcd of uint64 bits: three unsigned Euclid steps leave both
    values under 2**63 (or the divisor 0), where torch's signed gcd is the
    unsigned one."""
    a, b = _tensors(a, b)
    for _ in range(3):
        nz = b != 0
        r = _u64_divmod(a, b)[1]
        a, b = torch.where(nz, b, a), torch.where(nz, r, b)
    return torch.where(b == 0, a, torch.gcd(a, b))


def _u64_lcm(a, b):
    """numpy's lcm of uint64 bits: a // gcd * b, wrapped to 64 bits."""
    return _u64_divmod(a, _u64_gcd(a, b))[0] * b


_UINT64_LOOPS["gcd"] = _u64_gcd
_UINT64_LOOPS["lcm"] = _u64_lcm
_UINT64_LOOPS["clip"] = lambda x, lo, hi: _u64_extremum(_u64_extremum(x, lo, larger=True), hi, larger=False)


# -- the rest of numpy's ufuncs, with numpy's dtypes and values


@_numpy_named(np.fabs, strict=True)
def fabs_(x):
    return torch.abs(x)


@_numpy_named(np.degrees, strict=True)
def degrees_(x):
    return torch.rad2deg(x)


@_numpy_named(np.radians, strict=True)
def radians_(x):
    return torch.deg2rad(x)


@_numpy_named(np.signbit, strict=True)
def signbit_(x):
    return torch.signbit(x)


@_numpy_named(np.cbrt, strict=True)
def cbrt_(x):
    """The real cube root, in float64 and rounded once to x's dtype: pow
    and one Newton step on |x| (scaled by a power of 2 into a range where
    y**3 neither underflows nor overflows), exact cubes snapped to their
    integer root, the sign restored; 0, inf and NaN are their own root."""
    t = x.to(torch.float64)
    a = t.abs()
    big, small = a > 2.0**600, a < 2.0**-600
    one = a.new_ones(())
    a = a * torch.where(big, one * 2.0**-600, torch.where(small, one * 2.0**600, one))
    y = a.pow(1.0 / 3.0)
    y = y - (y * y * y - a) / (3.0 * y * y)
    r = torch.round(y)
    y = torch.where(r * r * r == a, r, y)
    y = y * torch.where(big, one * 2.0**200, torch.where(small, one * 2.0**-200, one))
    y = torch.where((t == 0) | ~torch.isfinite(t), t, torch.copysign(y, t))
    return y.to(x.dtype)


@_numpy_named(np.spacing, strict=True)
def spacing_(x):
    """numpy's spacing: the step to the next float away from zero, signed
    as x (-0.0 steps up).  numpy's float16 loop always steps toward +inf,
    so its spacing of a negative half is positive; that is kept."""
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    toward = inf.expand(x.shape) if x.dtype == torch.float16 else torch.where(x < 0, -inf, inf)
    out = torch.nextafter(x, toward) - x
    return torch.where(torch.isinf(x), float("nan"), out)


@_numpy_named(np.float_power, strict=True)
def float_power_(a, b):
    return torch.pow(a, b)


@_numpy_named(np.nextafter, strict=True)
def nextafter_(a, b):
    return torch.nextafter(*_tensors(a, b))


@_numpy_named(np.ldexp, strict=True)
def ldexp_(x, e):
    if not isinstance(e, torch.Tensor):
        e = torch.tensor(e, dtype=torch.int64, device=x.device)
    return torch.ldexp(x, e)


@_numpy_named(np.heaviside, strict=True)
def heaviside_(x, h):
    """numpy's heaviside (the operands promoted first; NaN stays NaN)."""
    x, h = _tensors(x, h)
    return torch.where(torch.isnan(x), x, torch.heaviside(x, h))


@_numpy_named(np.gcd, strict=True)
def gcd_(a, b):
    """numpy's gcd: that of |a| and |b| taken unsigned.  Narrow types work
    in int64 (exact) and wrap back; 64-bit ones go through ``_u64_gcd``
    (|INT64_MIN| is the bits of 2**63)."""
    a, b = _tensors(a, b)
    if a.dtype == torch.int64:
        return _u64_gcd(a.abs(), b.abs())
    return torch.gcd(a.to(torch.int64).abs(), b.to(torch.int64).abs()).to(a.dtype)


@_numpy_named(np.lcm, strict=True)
def lcm_(a, b):
    """numpy's lcm: |a| // gcd * |b| taken unsigned and wrapped to the
    width (so an int64 overflow keeps numpy's sign; torch's differs)."""
    a, b = _tensors(a, b)
    if a.dtype == torch.int64:
        return _u64_lcm(a.abs(), b.abs())
    ua, ub = a.to(torch.int64).abs(), b.to(torch.int64).abs()
    g = torch.gcd(ua, ub)
    return torch.where(g == 0, 0, ua // torch.where(g == 0, 1, g) * ub).to(a.dtype)


@_numpy_named(np.frexp, name="frexp_mantissa", output=0, strict=True)
def frexp_mantissa(x):
    return torch.frexp(x)[0]


@_numpy_named(np.frexp, name="frexp_exponent", output=1, strict=True)
def frexp_exponent(x):
    return torch.frexp(x)[1]


@_numpy_named(np.modf, name="modf_fraction", output=0, strict=True)
def modf_fraction(x):
    """numpy's fractional part: signed as x (-2.0 gives -0.0), ±0 for ±inf."""
    frac = torch.where(torch.isinf(x), torch.zeros_like(x), x - torch.trunc(x))
    return torch.copysign(frac, x)


@_numpy_named(np.modf, name="modf_integral", output=1, strict=True)
def modf_integral(x):
    return torch.trunc(x)


_CLIP = np._core.umath.clip if hasattr(np, "_core") else np.core.umath.clip


@_numpy_named(_CLIP, strict=True)
def clip_(x, lo, hi):
    """numpy's clip loop: maximum with ``lo``, then minimum with ``hi``
    (NaN propagates, complex ordered as numpy orders it)."""
    return minimum_(maximum_(x, lo), hi)


# -- numpy functions that are not ufuncs: each converts its own operands


@_numpy_function(np.isneginf)
def isneginf_(x):
    if x.is_floating_point():
        return x == float("-inf")
    return torch.zeros(x.shape, dtype=torch.bool, device=x.device)


@_numpy_function(np.isposinf)
def isposinf_(x):
    if x.is_floating_point():
        return x == float("inf")
    return torch.zeros(x.shape, dtype=torch.bool, device=x.device)


@_numpy_function(np.real)
def real_(x):
    return x.real if x.is_complex() else x


@_numpy_function(np.imag)
def imag_(x):
    if x.is_complex():
        return x.imag
    return torch.zeros(x.shape, dtype=compute_dtype(numpy_dtype(x.dtype)), device=x.device)


@_numpy_function(np.isreal)
def isreal_(x):
    if x.is_complex():
        return x.imag == 0
    return torch.ones(x.shape, dtype=torch.bool, device=x.device)


@_numpy_function(np.iscomplex)
def iscomplex_(x):
    if x.is_complex():
        return x.imag != 0
    return torch.zeros(x.shape, dtype=torch.bool, device=x.device)


@_numpy_function(np.angle)
def angle_(z, deg=False):
    """numpy's angle: arctan2(imag, real) in numpy's dtype (an int8's is
    float16, -0.0's is pi)."""
    if z.is_complex():
        out = torch.atan2(z.imag, z.real)
    else:
        t = to_compute(z, numpy_result(np.angle, z))
        out = torch.atan2(torch.zeros_like(t), t)
    return out * (180.0 / np.pi) if deg else out


def _chbevl(x, coefs):
    """numpy's Chebyshev series evaluation (``np.i0``'s ``_chbevl``), step
    for step."""
    b0, b1, b2 = torch.full_like(x, coefs[0]), torch.zeros_like(x), torch.zeros_like(x)
    for c in coefs[1:]:
        b2, b1 = b1, b0
        b0 = x * b1 - b2 + c
    return 0.5 * (b0 - b2)


def _i0_coefficients():
    impl = getattr(np.lib, "_function_base_impl", None) or np.lib.function_base
    return [float(c) for c in impl._i0A], [float(c) for c in impl._i0B]


@_numpy_function(np.i0)
def i0_(x):
    """numpy's i0 by numpy's own Chebyshev series in float64 (torch's i0
    differs by up to 6 units), rounded once to numpy's dtype (numpy's own
    float16 and float32 loops are several units off)."""
    t = to_compute(x, numpy_result(np.i0, x))
    a = t.to(torch.float64).abs()
    coef_a, coef_b = _i0_coefficients()
    small = torch.exp(a) * _chbevl(a / 2.0 - 2, coef_a)
    large = torch.exp(a) * _chbevl(32.0 / a - 2.0, coef_b) / torch.sqrt(a)
    return torch.where(a <= 8.0, small, large).to(t.dtype)


@functools.lru_cache(maxsize=None)
def _sinc_at_zero(dt):
    """numpy's own sinc(0) in ``dt``: 1, but NaN in float16 for numpy
    before 2.1 (its 1e-20 underflows there)."""
    with np.errstate(all="ignore"):
        return np.sinc(np.zeros((), dt)).item()


@_numpy_function(np.sinc)
def sinc_(x):
    """numpy's sinc, by numpy's steps in x's float dtype: y = pi * x, then
    sin(y) / y; at 0 numpy's own value there."""
    dt = numpy_result(np.sinc, x)
    t = to_compute(x, dt)
    y = t * torch.tensor(np.pi, dtype=t.dtype, device=t.device)
    safe = torch.where(t == 0, torch.ones_like(y), y)
    return torch.where(t == 0, _sinc_at_zero(dt), torch.sin(safe) / safe)


@_numpy_function(np.nan_to_num)
def nan_to_num_(x, copy=True, nan=0.0, posinf=None, neginf=None):
    if x.is_complex():
        return torch.complex(nan_to_num_(x.real, nan=nan, posinf=posinf, neginf=neginf),
                             nan_to_num_(x.imag, nan=nan, posinf=posinf, neginf=neginf))
    if not x.is_floating_point():
        return x
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@_numpy_function(np.fix)
def fix_(x):
    return torch.trunc(to_compute(x, numpy_result(np.fix, x)))


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

# the rest of numpy's ufuncs, and numpy's elementwise functions that are not
# ufuncs (real ... fix)
_MORE = {
    "fabs": fabs_,
    "cbrt": cbrt_,
    "degrees": degrees_,
    "radians": radians_,
    "isneginf": isneginf_,
    "isposinf": isposinf_,
    "signbit": signbit_,
    "spacing": spacing_,
    "real": real_,
    "imag": imag_,
    "angle": angle_,
    "i0": i0_,
    "sinc": sinc_,
    "nan_to_num": nan_to_num_,
    "fix": fix_,
    "float_power": float_power_,
    "nextafter": nextafter_,
    "ldexp": ldexp_,
    "heaviside": heaviside_,
    "gcd": gcd_,
    "lcm": lcm_,
}

_BY_NAME = {name: ufunc(fn, name) for name, fn in {**_TABLE, **_MORE}.items()}
globals().update(_BY_NAME)


def clip(a, a_min=None, a_max=None, **kwargs):
    """numpy's clip: one bound may be None; a Python number out of the
    array's integer range raises as numpy's does."""
    if a_min is None and a_max is None:
        raise ValueError("One of max or min must be given")
    if a_min is None:
        return _BY_NAME["minimum"](a, a_max, **kwargs)
    if a_max is None:
        return _BY_NAME["maximum"](a, a_min, **kwargs)
    out = elemwise(clip_, a, a_min, a_max, **kwargs)
    out.dtype  # numpy's refusal (an out-of-range bound) raises here, as numpy's does
    return out


def frexp(x):
    """(mantissa, exponent) as two lazy arrays: numpy's float mantissa and
    int32 exponent (an integer input is taken in numpy's float type)."""
    return elemwise(frexp_mantissa, x), elemwise(frexp_exponent, x)


def modf(x):
    """(fractional, integral) parts as two lazy arrays."""
    return elemwise(modf_fraction, x), elemwise(modf_integral, x)


def divmod(x, y):
    return _BY_NAME["floor_divide"](x, y), _BY_NAME["remainder"](x, y)


def isreal(x):
    return elemwise(isreal_, x)


def iscomplex(x):
    return elemwise(iscomplex_, x)


def _vmapped(func, nout, i):
    """``func`` of scalars over the elements of broadcast blocks with
    ``torch.vmap`` (output ``i`` of ``nout``)."""

    def vec(*blocks):
        tensors = [computable(b) for b in blocks if isinstance(b, torch.Tensor)]
        shape = torch.broadcast_shapes(*(t.shape for t in tensors))
        args = [computable(b).expand(shape).reshape(-1) if isinstance(b, torch.Tensor) else b for b in blocks]
        in_dims = tuple(0 if isinstance(b, torch.Tensor) else None for b in blocks)
        out = torch.vmap(func, in_dims=in_dims)(*args)
        if nout > 1:
            out = out[i]
        return out.reshape(shape)

    vec.__name__ = vec.__qualname__ = getattr(func, "__name__", "frompyfunc") + (f"-out{i}" if nout > 1 else "")
    return vec


def frompyfunc(func, nin, nout, *, identity=None):
    """A function of scalars (written with torch operators) as a lazy
    ufunc: ``torch.vmap`` over each raveled block.  ``nout > 1`` gives a
    callable returning a tuple, one elemwise expression per output."""
    if nout == 1:
        return ufunc(_vmapped(func, 1, 0), getattr(func, "__name__", "frompyfunc"))
    outs = [_vmapped(func, nout, i) for i in range(nout)]

    def multi(*args):
        return tuple(elemwise(vec, *args) for vec in outs)

    multi.__name__ = getattr(func, "__name__", "frompyfunc")
    return multi


def wrap_elemwise(fn, name=None):
    """Wrap an elementwise torch callable as a lazy chunked ufunc: numpy
    broadcasting, blockwise fusion and slice pushdown."""
    return ufunc(fn, name or getattr(fn, "__name__", "ufunc"))


_MULTI = {"clip": clip, "frexp": frexp, "modf": modf, "divmod": divmod}


def wrap_numpy_ufunc(np_ufunc):
    """Our wrapped equivalent of a numpy ufunc (for NEP-13 dispatch)."""
    name = getattr(np_ufunc, "__name__", None)
    return _BY_NAME.get(name) or _MULTI.get(name)


# the JAX package's names beyond the reference's list: attributes, not in
# the star-import list
EXTRA_NAMES = ("gcd", "heaviside", "lcm", "wrap_elemwise")

__all__ = sorted(set(_BY_NAME) - set(EXTRA_NAMES)) + [
    "clip", "divmod", "frexp", "frompyfunc", "iscomplex", "isreal", "modf", "ufunc", "wrap_numpy_ufunc",
]
