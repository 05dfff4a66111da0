"""Generalized ufuncs: ``apply_gufunc``, ``gufunc`` and ``as_gufunc``.

Port of ``dask_array_tpu/ops/_gufunc.py`` on the port's ``Blockwise``:
core dimensions are one chunk each (``allow_rechunk=True`` makes them so),
loop dimensions broadcast and stay chunked, one ``Blockwise`` per output.
The function takes torch tensors, one block of each argument per call;
``vectorize=True`` runs a function of one core slice under ``torch.vmap``
over the loop dimensions (flattened into one), as ``frompyfunc`` does.
"""

from __future__ import annotations

import functools
import math
import re

import numpy as np
import torch

from dask_array_tpu_torch._blockwise import Blockwise, _normalize_kwargs
from dask_array_tpu_torch._chunks import computable

_DIMENSION_NAME = r"\w+"
_CORE_DIMENSION_LIST = f"(?:{_DIMENSION_NAME}(?:,{_DIMENSION_NAME})*,?)?"
_ARGUMENT = rf"\({_CORE_DIMENSION_LIST}\)"
_INPUT_ARGUMENTS = f"(?:{_ARGUMENT}(?:,{_ARGUMENT})*,?)?"
_OUTPUT_ARGUMENTS = f"{_ARGUMENT}(?:,{_ARGUMENT})*"
_SIGNATURE = f"^{_INPUT_ARGUMENTS}->{_OUTPUT_ARGUMENTS}$"


def _parse_gufunc_signature(signature):
    signature = signature.replace(" ", "")
    if not re.match(_SIGNATURE, signature):
        raise ValueError(f"Not a valid gufunc signature: {signature}")
    ins, outs = signature.split("->")

    def parse(s):
        return [tuple(d for d in arg.strip("()").split(",") if d) for arg in re.findall(_ARGUMENT, s)]

    return parse(ins), parse(outs)


def _vectorized(func, in_dims, *blocks, **kwargs):
    """``func`` of one core slice per argument over the broadcast loop
    dimensions of ``blocks``: one ``torch.vmap`` over them flattened."""
    tensors = [computable(b) for b in blocks]
    loops = [t.shape[: t.ndim - len(cd)] for t, cd in zip(tensors, in_dims)]
    loop = torch.broadcast_shapes(*loops)
    flat = [t.expand(loop + t.shape[t.ndim - len(cd):]).reshape((math.prod(loop),) + t.shape[t.ndim - len(cd):])
            for t, cd in zip(tensors, in_dims)]
    out = torch.vmap(functools.partial(func, **kwargs))(*flat)
    if isinstance(out, (tuple, list)):
        return tuple(o.reshape(loop + o.shape[1:]) for o in out)
    return out.reshape(loop + out.shape[1:])


def _output(func, i, *args, **kwargs):
    return func(*args, **kwargs)[i]


def apply_gufunc(func, signature, *args, axes=None, axis=None, keepdims=False, output_dtypes=None,
                 output_sizes=None, vectorize=None, allow_rechunk=False, meta=None, **kwargs):
    """Apply the generalized ufunc ``func`` (torch tensors in, numpy's
    ``signature``) over chunked arrays: core dimensions must be one chunk
    (or ``allow_rechunk=True``), loop dimensions broadcast; several outputs,
    ``axes``/``axis``/``keepdims`` as numpy's gufuncs take them, and
    ``output_sizes`` for core dimensions only outputs have."""
    from dask_array_tpu_torch._collection import new_collection
    from dask_array_tpu_torch.ops._from_array import asarray
    from dask_array_tpu_torch.ops.manipulation import expand_dims, moveaxis

    in_dims, out_dims = _parse_gufunc_signature(signature)
    arrays = [asarray(a) for a in args]

    # axis= / axes=: the named axes move to the trailing core positions
    # before, and the outputs' core axes move back after
    if axis is not None:
        if axes is not None:
            raise ValueError("cannot pass both axis= and axes=")
        if any(len(cd) > 1 for cd in in_dims + out_dims):
            raise ValueError("axis= requires single-dimension core signatures")
        axes = [(axis,) if cd else () for cd in in_dims] + [(axis,) if cd else () for cd in out_dims]
    out_axes_spec = None
    if axes is not None:
        axes = [tuple(a) if isinstance(a, (tuple, list)) else (a,) for a in axes]
        if len(axes) == len(in_dims):
            in_axes = axes
        elif len(axes) == len(in_dims) + len(out_dims):
            in_axes, out_axes_spec = axes[: len(in_dims)], axes[len(in_dims):]
        else:
            raise ValueError(f"axes= must have {len(in_dims)} or {len(in_dims) + len(out_dims)} entries")
        moved_arrays = []
        for a, cd, ax in zip(arrays, in_dims, in_axes):
            if len(ax) != len(cd):
                raise ValueError("axes entry length must match core dims")
            core = tuple(range(a.ndim - len(cd), a.ndim))
            if ax and tuple(x % a.ndim for x in ax) != core:
                a = moveaxis(a, ax, core)
            moved_arrays.append(a)
        arrays = moved_arrays
    if len(arrays) != len(in_dims):
        raise ValueError(f"signature expects {len(in_dims)} arguments, got {len(arrays)}")

    nloop = max((a.ndim - len(cd) for a, cd in zip(arrays, in_dims)), default=0)
    if any(a.ndim < len(cd) for a, cd in zip(arrays, in_dims)):
        raise ValueError("input has fewer dimensions than its signature core dims")

    # core sizes agree; core dimensions become one chunk
    core_sizes: dict = dict(output_sizes or {})
    aligned = []
    for a, cd in zip(arrays, in_dims):
        nl = a.ndim - len(cd)
        target = list(a.chunks)
        needs = False
        for pos, label in enumerate(cd):
            ax = nl + pos
            size = a.shape[ax]
            if label in core_sizes and core_sizes[label] != size:
                raise ValueError(f"core dimension {label!r} has inconsistent sizes {core_sizes[label]} vs {size}")
            core_sizes.setdefault(label, size)
            if len(a.chunks[ax]) > 1:
                if not allow_rechunk:
                    raise ValueError(f"core dimension {label!r} is chunked along axis {ax}; pass allow_rechunk=True "
                                     "(or rechunk to a single chunk)")
                target[ax] = (size,)
                needs = True
        aligned.append(a.rechunk(tuple(target)) if needs else a)
    arrays = aligned
    for od in out_dims:
        for label in od:
            if label not in core_sizes:
                raise ValueError(f"output core dimension {label!r} has unknown size; pass output_sizes=")

    loop_labels = tuple(range(nloop))
    pairs = []
    for a, cd in zip(arrays, in_dims):
        nl = a.ndim - len(cd)
        pairs.extend([a.expr, tuple(loop_labels[nloop - nl:]) + tuple(f"c_{label}" for label in cd)])

    if vectorize:
        func = functools.partial(_vectorized, func, tuple(in_dims))
    if isinstance(output_dtypes, (list, tuple)):
        dtypes = list(output_dtypes)
    else:
        dtypes = [output_dtypes] * len(out_dims)
    input_core = {f"c_{label}" for cd in in_dims for label in cd}
    name = getattr(func, "__name__", None) or getattr(getattr(func, "func", None), "__name__", "gufunc")

    results = []
    for i, od in enumerate(out_dims):
        out_ind = loop_labels + tuple(f"c_{label}" for label in od)
        new_axes = {f"c_{label}": core_sizes[label] for label in od if f"c_{label}" not in input_core}
        fn = func if len(out_dims) == 1 else functools.partial(_output, func, i)
        dtype = dtypes[i]
        expr = Blockwise(fn, out_ind, name, np.dtype(dtype) if dtype is not None else None, None,
                         _normalize_kwargs(new_axes) if new_axes else None, True, _normalize_kwargs(kwargs), *pairs)
        out = new_collection(expr)
        if keepdims and not od:
            out = expand_dims(out, (axis if axis is not None else -1) % (out.ndim + 1))
        elif out_axes_spec is not None and od:
            want = tuple(x % out.ndim for x in out_axes_spec[i])
            have = tuple(range(out.ndim - len(od), out.ndim))
            if want != have:
                out = moveaxis(out, have, want)
        results.append(out)
    return results[0] if len(results) == 1 else tuple(results)


class gufunc:
    """A function bound to its gufunc signature and options; calling it
    is ``apply_gufunc``."""

    def __init__(self, pyfunc, *, signature=None, vectorize=None, axes=None, axis=None, keepdims=False,
                 output_sizes=None, output_dtypes=None, allow_rechunk=False):
        self.pyfunc = pyfunc
        self.signature = signature
        self.vectorize = vectorize
        self.axes = axes
        self.axis = axis
        self.keepdims = keepdims
        self.output_sizes = output_sizes
        self.output_dtypes = output_dtypes
        self.allow_rechunk = allow_rechunk
        self.__doc__ = getattr(pyfunc, "__doc__", None)
        self.__name__ = getattr(pyfunc, "__name__", "gufunc")

    def __call__(self, *args, **kwargs):
        return apply_gufunc(self.pyfunc, self.signature, *args, vectorize=self.vectorize, axes=self.axes,
                            axis=self.axis, keepdims=self.keepdims, output_sizes=self.output_sizes,
                            output_dtypes=self.output_dtypes, allow_rechunk=self.allow_rechunk, **kwargs)


def as_gufunc(signature=None, **kwargs):
    """Decorator form of ``gufunc``: ``@as_gufunc("(i),(i)->()")``."""

    def _as_gufunc(pyfunc):
        return gufunc(pyfunc, signature=signature, **kwargs)

    return _as_gufunc
