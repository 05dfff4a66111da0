"""FFT family over ``torch.fft``.

Port of ``dask_array_tpu/ops/fft.py`` (``fft_wrap``; the transformed axes
must each be one chunk).  The JAX package leaves the transforms to XLA;
the port leaves them to ``torch.fft`` (cuFFT on the card).

Result dtypes are numpy's, read from numpy itself on a small array:
integer and bool input is transformed in float64 (``torch.fft`` would
take int64 to complex64), and float16 in float32 (``torch.fft`` on the
card takes float16 only at power-of-two sizes, into complex32), then the
result is cast to numpy's dtype.
"""

from __future__ import annotations

import functools
from numbers import Integral

import numpy as np
import torch

from dask_array_tpu_torch._chunks import cast, torch_dtype, validate_axis
from dask_array_tpu_torch._executor import BlockView
from dask_array_tpu_torch._expr import ArrayExpr

_OUT_CHUNK_FNS = {
    "fft": lambda n, param: n if param is None else param,
    "ifft": lambda n, param: n if param is None else param,
    "hfft": lambda n, param: 2 * (n - 1) if param is None else param,
    "ihfft": lambda n, param: (n if param is None else param) // 2 + 1,
    "rfft": lambda n, param: (n if param is None else param) // 2 + 1,
    "irfft": lambda n, param: 2 * (n - 1) if param is None else param,
}

# the 1-D transform whose size rule an n-D transform follows on its axes
_KIND1 = {"fftn": "fft", "ifftn": "ifft", "rfftn": "rfft", "irfftn": "irfft",
          "fft2": "fft", "ifft2": "ifft", "rfft2": "rfft", "irfft2": "irfft"}


class FFT(ArrayExpr):
    _parameters = ("array", "kind", "n_param", "axes", "norm")

    def _name_prefix(self):
        return self.kind

    @functools.cached_property
    def chunks(self):
        kind1 = _KIND1.get(self.kind, self.kind)
        out = list(self.array.chunks)
        ns = self.n_param if isinstance(self.n_param, tuple) else (self.n_param,) * len(self.axes)
        for ax, n in zip(self.axes, ns):
            dim = self.array.shape[ax]
            if kind1 in ("rfft", "irfft") and self.kind != kind1 and ax != self.axes[-1]:
                size = dim if n is None else n  # the full axes of rfftn/irfftn
            else:
                size = _OUT_CHUNK_FNS[kind1](dim, n)
            out[ax] = (int(size),)
        return tuple(out)

    @functools.cached_property
    def _meta(self):
        # numpy's own result on a small array (its refusals raise here)
        probe = np.zeros((4,) * len(self.axes), self.array.dtype)
        fn = getattr(np.fft, self.kind)
        out = fn(probe) if self.kind in _OUT_CHUNK_FNS else fn(probe, axes=tuple(range(len(self.axes))))
        return np.empty((0,) * self.array.ndim, dtype=out.dtype)

    def _build(self, ctx):
        dense = ctx.build(self.array).dense()
        if self.array.dtype.kind in "biu":
            dense = cast(dense, np.float64)
        elif dense.dtype == torch.float16:
            dense = dense.float()
        fn = getattr(torch.fft, self.kind)
        if self.kind in ("fft", "ifft", "rfft", "irfft", "hfft", "ihfft"):
            out = fn(dense, n=self.n_param, dim=self.axes[0], norm=self.norm)
        else:
            out = fn(dense, s=self.n_param, dim=self.axes, norm=self.norm)
        # ihfft gives a conjugate view: lay out its values
        return BlockView(self.chunks, dense=out.resolve_conj().to(torch_dtype(self.dtype)))


def _check_single_chunk(a, axes):
    for ax in axes:
        if len(a.chunks[ax]) != 1:
            raise ValueError(
                "Dask-style FFT can only be applied along an axis with a "
                f"single chunk. Rechunk first: axis {ax} has chunks {a.chunks[ax]}"
            )


def fft_wrap(fft_func, kind=None, dtype=None, allow_fftpack=False):
    """Wrap a (numpy/scipy-style) fft function for lazy arrays.

    ``kind`` defaults to the function's name and must belong to the
    numpy.fft API (unknown kinds raise ValueError); ``scipy.fftpack``
    sources warn unless ``allow_fftpack=True``.  Execution runs the
    matching ``torch.fft`` routine.
    """
    import warnings

    mod = getattr(fft_func, "__module__", "") or ""
    if mod.startswith("scipy.fftpack") and not allow_fftpack:
        warnings.warn(
            f"Function {getattr(fft_func, '__name__', fft_func)} from "
            "`scipy.fftpack` does not match NumPy's API and is considered "
            "legacy. Please use `scipy.fft` instead. To suppress this "
            "warning and allow usage, set `allow_fftpack=True`.",
            FutureWarning,
        )
    name = kind or getattr(fft_func, "__name__", None)
    if not name or name.rstrip("2n") not in _OUT_CHUNK_FNS:
        raise ValueError(f"Given unknown `kind` {name}.")

    if name.endswith("2") or name.endswith("n"):
        def wrapped(a, s=None, axes=None, norm=None):
            return _dispatch(name, a, s=s, axes=axes, norm=norm)
    else:
        def wrapped(a, n=None, axis=-1, norm=None):
            return _dispatch(name, a, n=n, axis=axis, norm=norm)

    wrapped.__name__ = name
    return wrapped


def _dispatch(kind, a, n=None, axis=None, s=None, axes=None, norm=None):
    from dask_array_tpu_torch._collection import new_collection
    from dask_array_tpu_torch.ops._from_array import asarray

    a = asarray(a)
    if kind in ("fft", "ifft", "rfft", "irfft", "hfft", "ihfft"):
        ax = validate_axis(-1 if axis is None else axis, a.ndim)
        axes_t = (ax,)
        n_param = n
    else:
        if axes is not None:
            axes_t = tuple(validate_axis(x, a.ndim) for x in axes)
        elif kind.endswith("2") and s is None:
            axes_t = tuple(validate_axis(x, a.ndim) for x in (-2, -1))
        elif s is not None:
            # numpy semantics: s without axes means the LAST len(s) axes
            axes_t = tuple(range(a.ndim - len(s), a.ndim))
        elif kind.endswith("2"):
            axes_t = tuple(validate_axis(x, a.ndim) for x in (-2, -1))
        else:
            axes_t = tuple(range(a.ndim))
        if len(set(axes_t)) != len(axes_t):
            raise ValueError("Duplicate axes not allowed.")
        if kind.endswith("2") and len(axes_t) != 2:
            # numpy's *2 functions accept any number of axes (they are
            # fftn's specializations): take the *n transform
            kind = kind[:-1] + "n"
        n_param = tuple(s) if s is not None else None
    _check_single_chunk(a, axes_t)
    expr = FFT(a.expr, kind, n_param, axes_t, norm)
    expr._meta  # numpy's dtype, or its TypeError, now
    return new_collection(expr)


def fft(a, n=None, axis=-1, norm=None):
    return _dispatch("fft", a, n=n, axis=axis, norm=norm)


def ifft(a, n=None, axis=-1, norm=None):
    return _dispatch("ifft", a, n=n, axis=axis, norm=norm)


def rfft(a, n=None, axis=-1, norm=None):
    return _dispatch("rfft", a, n=n, axis=axis, norm=norm)


def irfft(a, n=None, axis=-1, norm=None):
    return _dispatch("irfft", a, n=n, axis=axis, norm=norm)


def hfft(a, n=None, axis=-1, norm=None):
    return _dispatch("hfft", a, n=n, axis=axis, norm=norm)


def ihfft(a, n=None, axis=-1, norm=None):
    return _dispatch("ihfft", a, n=n, axis=axis, norm=norm)


def fft2(a, s=None, axes=(-2, -1), norm=None):
    return _dispatch("fft2", a, s=s, axes=axes, norm=norm)


def ifft2(a, s=None, axes=(-2, -1), norm=None):
    return _dispatch("ifft2", a, s=s, axes=axes, norm=norm)


def rfft2(a, s=None, axes=(-2, -1), norm=None):
    return _dispatch("rfft2", a, s=s, axes=axes, norm=norm)


def irfft2(a, s=None, axes=(-2, -1), norm=None):
    return _dispatch("irfft2", a, s=s, axes=axes, norm=norm)


def fftn(a, s=None, axes=None, norm=None):
    return _dispatch("fftn", a, s=s, axes=axes, norm=norm)


def ifftn(a, s=None, axes=None, norm=None):
    return _dispatch("ifftn", a, s=s, axes=axes, norm=norm)


def rfftn(a, s=None, axes=None, norm=None):
    return _dispatch("rfftn", a, s=s, axes=axes, norm=norm)


def irfftn(a, s=None, axes=None, norm=None):
    return _dispatch("irfftn", a, s=s, axes=axes, norm=norm)


def fftfreq(n, d=1.0, chunks="auto"):
    """numpy's sample frequencies: one range of length n with the wrap
    applied elementwise (an explicit chunks spec describes the whole
    output), times ``1 / (n * d)`` as numpy scales it."""
    from dask_array_tpu_torch._blockwise import elemwise
    from dask_array_tpu_torch.ops.creation import arange

    n = int(n)
    i = arange(0, n, chunks=chunks, dtype="f8")
    cut = (n + 1) // 2
    shifted = elemwise(lambda v: torch.where(v >= cut, v - n, v), i)
    return shifted * (1.0 / (n * d))


def rfftfreq(n, d=1.0, chunks="auto"):
    from dask_array_tpu_torch.ops.creation import arange

    n = int(n)
    return arange(0, n // 2 + 1, chunks=chunks, dtype="f8") * (1.0 / (n * d))


def _shift(a, axes, inverse):
    from dask_array_tpu_torch.ops.manipulation import roll

    if axes is None:
        axes = tuple(range(a.ndim))
    elif isinstance(axes, Integral):
        axes = (axes,)
    out = a
    for ax in axes:
        ax = validate_axis(ax, a.ndim)
        n = a.shape[ax]
        shift = -(n // 2) if inverse else n // 2
        out = roll(out, shift, axis=ax)
    return out


def fftshift(x, axes=None):
    return _shift(x, axes, inverse=False)


def ifftshift(x, axes=None):
    return _shift(x, axes, inverse=True)
