"""Shape manipulation: transpose.

Port of the transpose part of ``dask_array_tpu/ops/manipulation.py``
(``Transpose``, ``make_transpose``, ``transpose``).  Squeeze, expand_dims,
broadcast_to, flips and reshape wait for a later slice of the port.
"""

from __future__ import annotations

import functools
from numbers import Integral

import numpy as np

from dask_array_tpu_torch._blockwise import Blockwise, _NHEAD
from dask_array_tpu_torch._chunks import validate_axis
from dask_array_tpu_torch._executor import BlockView
from dask_array_tpu_torch._expr import ArrayExpr
from dask_array_tpu_torch._slicing import Slice, is_basic_index


def _transpose_fn(block, axes=None):
    return block.permute(axes)


class Transpose(Blockwise):
    """Axis permutation as a blockwise op with permuted block coordinates."""

    _pushdown_gate = "_transpose_pushdown"

    @property
    def array(self):
        return self.operands[_NHEAD]

    @property
    def axes(self):
        return self.out_ind

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * self.array.ndim, dtype=self.array.dtype)

    def _lower(self):
        return None  # no alignment needed: single operand

    def _simplify_down(self):
        if self.axes == tuple(range(self.array.ndim)):
            return self.array
        if type(self.array) is Transpose:
            inner = self.array
            composed = tuple(inner.axes[a] for a in self.axes)
            return make_transpose(inner.array, composed)
        return None

    def _build(self, ctx):
        dense = ctx.build(self.array).dense()
        return BlockView(self.chunks, dense=dense.permute(self.axes))

    def _accept_rechunk(self, target_chunks):
        from dask_array_tpu_torch._rechunk import Rechunk

        # rechunk(transpose(x)) == transpose(rechunk(x, inverse-permuted))
        inner_target = [None] * len(self.axes)
        for out_pos, in_ax in enumerate(self.axes):
            inner_target[in_ax] = tuple(target_chunks[out_pos])
        return make_transpose(Rechunk(self.array, tuple(inner_target)), self.axes)

    def _accept_slice(self, index):
        if not is_basic_index(index):
            return None
        axes = self.axes
        inner_index = [slice(None)] * len(axes)
        for out_pos, ind in enumerate(index):
            inner_index[axes[out_pos]] = ind
        sliced = Slice(self.array, tuple(inner_index))
        # integer indices drop axes: recompute the permutation on kept axes
        dropped = {axes[p] for p, ind in enumerate(index) if isinstance(ind, Integral)}
        kept_in = [a for a in range(len(axes)) if a not in dropped]
        remap = {a: i for i, a in enumerate(kept_in)}
        new_axes = tuple(remap[a] for a in axes if a not in dropped)
        if new_axes == tuple(range(len(new_axes))):
            return sliced
        return make_transpose(sliced, new_axes)


def make_transpose(expr: ArrayExpr, axes: tuple) -> ArrayExpr:
    axes = tuple(int(a) for a in axes)
    if axes == tuple(range(expr.ndim)):
        return expr
    return Transpose(
        _transpose_fn,
        axes,  # out_ind = axes (out dim i carries input axis axes[i])
        "transpose",
        expr.dtype,
        None,
        None,
        True,
        (("axes", axes),),
        expr,
        tuple(range(expr.ndim)),
    )


def transpose(a, axes=None):
    from dask_array_tpu_torch._collection import Array, new_collection

    expr = a.expr if isinstance(a, Array) else a
    if axes is None:
        axes = tuple(range(expr.ndim))[::-1]
    else:
        axes = tuple(validate_axis(ax, expr.ndim) for ax in axes)
        if len(set(axes)) != expr.ndim:
            raise ValueError("axes don't match array")
    if isinstance(a, Array) and axes == tuple(range(expr.ndim)):
        return a  # identity permutation: skip entirely
    return new_collection(make_transpose(expr, axes))
