"""The multi-statistic route: several reductions of one 2-D float32 array
in one read, through the hand-written kernel ``kernels/mstat.py``.

The ``reduction_tree`` workload asks for ``x.sum(0)``, ``x.mean(1)`` and
``x.std()`` of one array.  As typed reductions these are three or four
passes over ``x`` (``std`` is the one-pass shifted power sums ``T =
sum(x - s)`` and ``Q = sum((x - s)**2)`` of ``ops/reductions.var``).  The
reference leaves it to XLA to fuse them into fewer reads; here
``fuse_multi_stat`` finds, before optimization, the typed reductions of
one operand ``X`` that the kernel computes:

- ``sum(X, axis=0)``                    -> its column sums,
- ``mean(X, axis=1)``                   -> its row means,
- ``sum(X - X[0, 0])`` / ``sum(X)``     -> its shifted sum ``s``,
- ``sum(D * D)`` of the same ``D``      -> its shifted sum of squares ``ss``,

all float32 without keepdims, and when two or more of them appear in the
plans computed together, replaces each by a ``MultiStatPart`` of one
``MultiStat(X, shift)`` node.  The elementwise tail of ``var``/``std``
(clamp, divide, sqrt) stays as it is, so the values keep the shifted
one-pass formula; only the order of the float32 additions changes.
"""

from __future__ import annotations

import functools
from collections import defaultdict

import numpy as np
import torch

from dask_array_tpu_torch._executor import BlockView
from dask_array_tpu_torch._expr import ArrayExpr
from dask_array_tpu_torch._spans import call


class MultiStat(ArrayExpr):
    """``[colsum | rowmean | std | s | ss]`` of a 2-D float32 array, one
    launch of the multi-statistic kernel (its plain version on the CPU)."""

    _parameters = ("array", "shift")
    _defaults = {"shift": None}

    def _name_prefix(self):
        return "multi-stat"

    @functools.cached_property
    def chunks(self):
        m, n = self.array.shape
        return ((n + m + 3,),)

    @functools.cached_property
    def _meta(self):
        return np.empty((0,), dtype=np.float32)

    def _build(self, ctx):
        from dask_array_tpu_torch.kernels import mstat

        x = ctx.build(self.array).dense().contiguous()
        shift = ctx.build(self.shift).dense() if self.shift is not None else None
        return BlockView(self.chunks, dense=mstat.multi_stat_packed(x, shift))


class MultiStatPart(ArrayExpr):
    """One statistic out of a ``MultiStat`` buffer (a view)."""

    _parameters = ("stats", "part")

    def _name_prefix(self):
        return f"multi-stat-{self.part}"

    @functools.cached_property
    def chunks(self):
        m_chunks, n_chunks = self.stats.array.chunks
        return {"colsum": (n_chunks,), "rowmean": (m_chunks,)}.get(self.part, ())

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.chunks), dtype=np.float32)

    def _build(self, ctx):
        packed = ctx.build(self.stats).dense()
        m, n = self.stats.array.shape
        if self.part == "colsum":
            dense = packed[:n]
        elif self.part == "rowmean":
            dense = packed[n : n + m]
        else:  # std sits at n + m, then s, then ss
            dense = packed[n + m + {"s": 1, "ss": 2}[self.part]]
        return BlockView(self.chunks, dense=dense)


def _is_f32_2d(expr) -> bool:
    return (
        expr.ndim == 2
        and expr.dtype == np.float32
        and all(isinstance(s, int) and s > 0 for s in expr.shape)
    )


def _shift_of(d):
    """(X, shift) when ``d`` is ``X - X[0, 0]`` (the var shift), else None."""
    from dask_array_tpu_torch._blockwise import Elemwise
    from dask_array_tpu_torch._slicing import Slice

    if not (isinstance(d, Elemwise) and d.func is torch.sub and not d.kwargs and len(d.args) == 2):
        return None
    x, s = d.args
    if isinstance(x, ArrayExpr) and isinstance(s, Slice) and s.array is x and s.index == (0, 0):
        return x, s
    return None


def _statistic(node):
    """(X, shift or None or "any", part) when ``node`` is a reduction the
    kernel computes, else None."""
    from dask_array_tpu_torch._blockwise import Elemwise
    from dask_array_tpu_torch.ops.reductions import Reduction

    if not isinstance(node, Reduction) or node.keepdims or node.dtype != np.float32:
        return None
    arr, kind, axes = node.array, node.kind, tuple(node.axes)
    if kind == "sum" and axes == (0,) and _is_f32_2d(arr):
        return arr, "any", "colsum"
    if kind == "mean" and axes == (1,) and _is_f32_2d(arr):
        return arr, "any", "rowmean"
    if kind != "sum" or axes != (0, 1):
        return None
    if isinstance(arr, Elemwise) and arr.func is torch.mul and not arr.kwargs and len(arr.args) == 2:
        a, b = arr.args
        if a is b and isinstance(a, ArrayExpr):
            shifted = _shift_of(a)
            if shifted is not None and _is_f32_2d(shifted[0]):
                return shifted[0], shifted[1], "ss"
            if _is_f32_2d(a):
                return a, None, "ss"
        return None
    shifted = _shift_of(arr)
    if shifted is not None and _is_f32_2d(shifted[0]):
        return shifted[0], shifted[1], "s"
    if _is_f32_2d(arr):
        return arr, None, "s"
    return None


def fuse_multi_stat(roots):
    """Route the kernel's statistics of each operand through one
    ``MultiStat`` node, across all ``roots`` (computed together)."""
    return call("fuse_multistat", _fuse_multi_stat, roots)


def _fuse_multi_stat(roots):
    found = defaultdict(list)  # X name -> [(node, shift, part)]
    operands = {}
    seen = set()
    for root in roots:
        for node in root.walk():
            if node._name in seen:
                continue
            seen.add(node._name)
            stat = _statistic(node)
            if stat is not None:
                x, shift, part = stat
                found[x._name].append((node, shift, part))
                operands[x._name] = x
    mapping = {}
    for name, stats in found.items():
        shifts = {s._name: s for _, s, _ in stats if s not in ("any", None)}
        unshifted = any(s is None for _, s, _ in stats)
        if len(shifts) > 1 or (shifts and unshifted):
            continue  # two different shifts: the kernel takes one
        shift = next(iter(shifts.values()), None)
        if len({part for _, _, part in stats}) < 2:
            continue  # one statistic alone is one torch reduce already
        ms = MultiStat(operands[name], shift)
        for node, _, part in stats:
            mapping[node._name] = MultiStatPart(ms, part)
    if not mapping:
        return list(roots)
    return [root._substitute_many(mapping, {}) for root in roots]
