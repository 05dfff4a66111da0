"""Broadcast scale ``x * s`` in row blocks, with its plain PyTorch version.

Counterpart of ``bench/probe_pallas_min.py::k_copy`` (``o = x * 2.0`` on a
256 x 256 float32 array in (128, 256) row blocks).  ``x`` is viewed as 2-D
by merging its leading axes, and ``s`` takes one of three forms
(``scale_form``): a scalar, a row broadcast over the rows (``u * signs`` in
``svd_flip``), or a column (``vh * signs.T``).  ``Elemwise._build`` routes
every real floating multiply of those shapes here.

- ``scale_plain(x, s)`` is ``torch.mul`` with ``s`` as a tensor of x's dtype;
- ``scale_cuda(x, s)`` launches the CUDA kernel (``csrc/scale.cu``) and
  counts ``LAUNCHES``;
- ``scale(x, s)`` runs the plain version for a CPU tensor and the kernel
  for a CUDA tensor, with no fallback between them.

Both round as numpy does: ``s`` is a value of x's dtype before the
multiply, and a half product is rounded once from float32, where it is
exact.
"""

from __future__ import annotations

import ctypes
import functools
import math
import numbers

import torch

from dask_array_tpu_torch.kernels._build import Launcher

# kernel launches since the last reset; only scale_cuda adds to it
LAUNCHES = 0

# the kernel's dtype codes, and the integer type of the same width
_DTYPES = {
    torch.float16: (0, torch.int16),
    torch.bfloat16: (1, torch.int16),
    torch.float32: (2, torch.int32),
    torch.float64: (3, torch.int64),
}


def scale_form(x_shape, s_shape):
    """``(rows, cols, rs, cs)`` of the 2-D problem ``x * s``, or None when
    ``s`` is not a scalar, a row or a column of ``x``.

    ``s`` (numpy-broadcast against ``x``) is a scalar when it has one
    element; a row when only its last axis is longer than 1; a column when
    only axis k < last is, and x's axes before k are 1, so x is the
    (x_shape[k], prod(x_shape[k+1:])) matrix it scales row by row.
    """
    x_shape, s_shape = tuple(x_shape), tuple(s_shape)
    nd = len(x_shape)
    if len(s_shape) > nd:
        return None
    s_shape = (1,) * (nd - len(s_shape)) + s_shape
    cols = x_shape[-1] if nd else 1
    rows = math.prod(x_shape[:-1]) if nd else 1
    varying = [k for k in range(nd) if s_shape[k] != 1]
    if any(s_shape[k] != x_shape[k] for k in varying):
        return None
    if not varying:
        return rows, cols, 0, 0
    if len(varying) > 1:
        return None
    k = varying[0]
    if k == nd - 1:
        return rows, cols, 0, 1
    if math.prod(x_shape[:k]) != 1:
        return None
    return x_shape[k], math.prod(x_shape[k + 1:]), 1, 0


def _form(x: torch.Tensor, s):
    """``(rows, cols, rs, cs)`` of ``x * s`` (``scale_form``); raises if x's
    dtype is not one the kernel takes, or ``s`` is neither a real number nor
    a scalar, row or column of x's dtype."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"scale takes float16, bfloat16, float32 or float64, got {x.dtype}")
    if isinstance(s, numbers.Real):
        shape = ()
    elif isinstance(s, torch.Tensor) and s.dtype == x.dtype:
        shape = s.shape
    else:
        raise TypeError(f"scale needs a factor of x's dtype {x.dtype}, got {getattr(s, 'dtype', type(s))}")
    form = scale_form(x.shape, shape)
    if form is None:
        raise ValueError(f"scale: a factor of shape {tuple(shape)} is not a scalar, row or column of "
                         f"{tuple(x.shape)}")
    return form


def scale_plain(x: torch.Tensor, s) -> torch.Tensor:
    """``x * s`` in one torch op, a number ``s`` first rounded to x's dtype."""
    _form(x, s)
    return torch.mul(x, torch.tensor(s, dtype=x.dtype) if isinstance(s, numbers.Real) else s)


def scale(x: torch.Tensor, s) -> torch.Tensor:
    """``x * s``: the plain version for a CPU tensor, the CUDA kernel for a
    CUDA tensor."""
    if x.device.type == "cpu":
        return scale_plain(x, s)
    return scale_cuda(x, s)


@functools.lru_cache(maxsize=256)
def _number_bits(key, dtype: torch.dtype) -> int:
    """The bits of a number rounded to ``dtype`` as ``scale_plain`` rounds
    it.  ``key`` is an int, or a float's hex (which tells -0.0 from 0.0)."""
    value = key if isinstance(key, int) else float.fromhex(key)
    t = torch.tensor(value, dtype=dtype)
    return int(t.view(_DTYPES[dtype][1]).item()) & ((1 << (8 * t.element_size())) - 1)


def scale_cuda(x: torch.Tensor, s) -> torch.Tensor:
    """Launch the scale kernel on a CUDA tensor.

    ``x`` is read in place when its last axis has unit stride and the rest
    merge into one row stride (a column-slice view, say); any other layout
    is made contiguous first.  A number, or a one-element factor on the
    host, goes to the kernel by value; any other factor is read on the
    device.
    """
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"scale_cuda needs a CUDA tensor, got one on {x.device}")
    rows, cols, rs, cs = _form(x, s)
    # (the host's share of a call is most of it on a small array: each step
    # below takes the cheaper of two equal torch calls)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    code, bits_dtype = _DTYPES[x.dtype]
    if x.is_neg():
        x = x.resolve_neg()
    if x.is_contiguous():
        ld = cols
    else:
        if x.stride(-1) != 1:
            x = x.contiguous()
        x = x.reshape(rows, cols)  # a view when the leading axes merge, else a copy
        ld = x.stride(0) if rows > 1 else cols  # one row: its stride is never read
    if isinstance(s, numbers.Real):
        key = int(s) if isinstance(s, numbers.Integral) else float(s).hex()
        s_ptr, s_bits = None, _number_bits(key, x.dtype)
    elif s.numel() == 1 and s.device.type == "cpu":
        s_ptr, s_bits = None, int(s.reshape(()).view(bits_dtype).item()) & ((1 << (8 * s.element_size())) - 1)
        rs = cs = 0
    else:
        if s.device != x.device or not s.is_contiguous():
            s = s.to(x.device).contiguous()
        s_ptr, s_bits = s.data_ptr(), 0  # a scalar, row or column: its elements in order
    _launcher()(x.get_device(), x.data_ptr(), s_ptr, s_bits, out.data_ptr(), rows, cols, ld, rs, cs, code)
    LAUNCHES += 1
    return out


@functools.lru_cache(maxsize=None)
def _launcher():
    p, i, ll, ull = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
    return Launcher("scale", "scale_launch", [p, p, ull, p, ll, ll, ll, ll, ll, i], "scale")
