"""Per-block functions (the ``dask_array.chunk`` namespace), for user code
inside ``map_blocks`` and ``blockwise``.

Port of ``dask_array_tpu/_chunk.py``: each function takes a torch tensor
(a block on the device) or a numpy array and answers in kind.  ``view``
waits for the host lane of odd dtypes (ROADMAP S9).
"""

from __future__ import annotations

import functools
from numbers import Integral

import numpy as np
import torch

from dask_array_tpu_torch._chunks import cast, order_key


def _is_numpy(x):
    return isinstance(x, np.ndarray) or np.isscalar(x)


def flatten(seq, container=list):
    for el in seq:
        if isinstance(el, container):
            yield from flatten(el, container)
        else:
            yield el


def concat(seqs):
    """Flatten nested lists of blocks and concatenate along axis 0."""
    parts = list(flatten(seqs))
    if _is_numpy(parts[0]):
        return np.concatenate(parts, axis=0)
    from dask_array_tpu_torch._chunks import cat

    return cat(parts, dim=0)


def astype(x, astype_dtype=None, **kwargs):
    if _is_numpy(x):
        return np.asarray(x).astype(astype_dtype)
    return cast(x, astype_dtype)


def view(x, dtype, order="C"):
    """numpy's ``view`` of one block (a tensor by ``Tensor.view``)."""
    if _is_numpy(x):
        if order == "C":
            return np.asarray(x).view(dtype)
        return np.asfortranarray(np.asarray(x)).T.view(dtype).T
    from dask_array_tpu_torch._chunks import torch_dtype

    if order == "C":
        return x.contiguous().view(torch_dtype(dtype))
    return x.mT.contiguous().view(torch_dtype(dtype)).mT if x.ndim > 1 else x.contiguous().view(torch_dtype(dtype))


def trim(x, axes=None):
    """Trim ``axes`` elements off both sides of every axis (an int for all
    axes, a sequence or a dict by axis)."""
    if isinstance(axes, Integral):
        axes = [axes] * x.ndim
    if isinstance(axes, dict):
        axes = [axes.get(i, 0) for i in range(x.ndim)]
    return x[tuple(slice(ax, -ax if ax else None) for ax in axes)]


def keepdims_wrapper(a_callable):
    """Wrap a reduction so that ``keepdims=True`` keeps the reduced axes."""

    @functools.wraps(a_callable)
    def keepdims_wrapped_callable(x, axis=None, keepdims=None, *args, **kwargs):
        r = a_callable(x, axis=axis, *args, **kwargs)
        if not keepdims:
            return r
        if axis is None:
            axes = range(x.ndim)
        elif isinstance(axis, Integral):
            axes = (axis,)
        else:
            axes = axis
        axes = sorted(a % x.ndim for a in axes)
        if _is_numpy(x):
            return np.expand_dims(r, tuple(axes))
        for a in axes:
            r = r.unsqueeze(a)
        return r

    return keepdims_wrapped_callable


def coarsen(reduction, x, axes, trim_excess=False, **kwargs):
    """``reduction`` over non-overlapping windows of one block (``axes``
    maps an axis to its window); the lazy form is ``routines.coarsen``."""
    if trim_excess:
        x = x[tuple(slice(0, (x.shape[i] // axes.get(i, 1)) * axes.get(i, 1)) for i in range(x.ndim))]
    new_shape = []
    red = []
    for i, s in enumerate(x.shape):
        f = axes.get(i, 1)
        new_shape.extend([s // f, f])
        red.append(2 * i + 1)
    return reduction(x.reshape(tuple(new_shape)), axis=tuple(red), **kwargs)


def _topk_indices(a, k, axis):
    """Indices of the ``k`` largest elements along ``axis`` (descending), or
    of the ``-k`` smallest (ascending) for k < 0, in numpy's sort order."""
    if _is_numpy(a):
        idx = np.argsort(a, axis=axis, kind="stable")
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(-k, None) if k >= 0 else slice(None, -k)
        out = idx[tuple(sl)]
        return np.flip(out, axis=axis) if k >= 0 else out
    _, idx = torch.topk(order_key(a), abs(k), dim=axis, largest=k >= 0, sorted=True)
    return idx


def topk(a, k, axis, keepdims=True):
    """The ``k`` largest values along ``axis`` (descending), or the ``-k``
    smallest (ascending) for k < 0."""
    idx = _topk_indices(a, k, axis)
    if _is_numpy(a):
        return np.take_along_axis(a, idx, axis=axis)
    from dask_array_tpu_torch._chunks import moved

    return moved(torch.gather, a, axis, idx)


def topk_aggregate(a, k, axis, keepdims=True):
    return topk(a, k, axis, keepdims)


def argtopk(a, k, axis, keepdims=True):
    """Indices of the ``k`` largest (descending) or ``-k`` smallest
    (ascending) elements along ``axis``."""
    return _topk_indices(a, k, axis)


def argtopk_aggregate(a_plus_idx, k, axis, keepdims=True):
    a, idx = a_plus_idx
    sel = argtopk(a, k, axis, keepdims)
    if _is_numpy(a):
        return np.take_along_axis(idx, sel, axis=axis)
    return torch.gather(idx, axis, sel)


def getitem(obj, index):
    return obj[index]


def arange(start, stop, step, length, dtype, like=None):
    from dask_array_tpu_torch._chunks import torch_dtype

    idx = torch.arange(length, dtype=torch.float64)
    return (start + idx * step).to(torch_dtype(dtype))


def linspace(start, stop, num, endpoint=True, dtype=None):
    from dask_array_tpu_torch._chunks import torch_dtype

    out = np.linspace(start, stop, num, endpoint=endpoint, dtype=dtype)
    return torch.from_numpy(out).to(torch_dtype(out.dtype))
