"""The elementwise ufunc table + the ``ufunc`` wrapper class.

Port of ``dask_array_tpu/ops/ufuncs.py``.  Each entry wraps a torch
function in an ``Elemwise`` expression; result dtypes follow numpy (see
``_expr.compute_meta``), and operands are cast to numpy's loop dtypes
before the torch call (``Elemwise._build``).
"""

from __future__ import annotations

import numpy as np
import torch

from dask_array_tpu_torch._blockwise import elemwise


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


def _zero_safe(torch_fn, np_ufunc):
    """``torch_fn`` with numpy's integer division by zero: 0 where the
    divisor is 0.  torch raises on the CPU for it and is undefined on CUDA,
    so the quotient is taken with zero divisors replaced by 1, then 0 is
    selected there.  Float operands pass straight through (inf/nan as in
    numpy)."""

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

    fn.__name__ = fn.__qualname__ = np_ufunc.__name__
    fn.numpy_ufunc = np_ufunc
    return fn


floor_divide_ = _zero_safe(torch.floor_divide, np.floor_divide)
remainder_ = _zero_safe(torch.remainder, np.remainder)
fmod_ = _zero_safe(torch.fmod, np.fmod)

# numpy name -> torch function (the Elemwise kernel)
_TABLE = {
    # unary math
    "abs": torch.abs,
    "absolute": torch.abs,
    "rint": torch.round,
    "sign": torch.sign,
    "exp": torch.exp,
    "exp2": torch.exp2,
    "expm1": torch.expm1,
    "log": torch.log,
    "log2": torch.log2,
    "log10": torch.log10,
    "log1p": torch.log1p,
    "sqrt": torch.sqrt,
    "square": torch.square,
    "reciprocal": torch.reciprocal,
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
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "fmax": torch.fmax,
    "fmin": torch.fmin,
    "copysign": torch.copysign,
    "bitwise_and": torch.bitwise_and,
    "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor,
    "left_shift": torch.bitwise_left_shift,
    "right_shift": torch.bitwise_right_shift,
    "greater": torch.gt,
    "greater_equal": torch.ge,
    "less": torch.lt,
    "less_equal": torch.le,
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
