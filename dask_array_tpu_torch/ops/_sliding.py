"""Sliding and moving window reductions.

Port of ``dask_array_tpu/ops/_sliding.py``: ``SlidingWindowReduce`` (what
``reduce(sliding_window_view(x), axis=-1)`` fuses into) and
``MovingWindowReduction`` with bottleneck ``move_*`` semantics, including
``min_count``.

Where the JAX package runs one ``lax.reduce_window``, a window here is an
``unfold`` view of the source (no copy) reduced over its last axis; the
trailing windows of ``move_*`` first pad ``window - 1`` identity elements
in front, through ``kernels.halo.halo_pad``.  Every window is summed
directly: a difference of cumulative sums would cancel in float32.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from dask_array_tpu_torch._chunks import INT64_MIN, cast, computable, is_float_dtype, to_compute, validate_axis
from dask_array_tpu_torch._executor import BlockView
from dask_array_tpu_torch._expr import ArrayExpr
from dask_array_tpu_torch.kernels.halo import halo_pad
from dask_array_tpu_torch.ops._overlap import trim_tail


def _reduce_window(x, kind, window, axis, pad=0):
    """Reduce every length-``window`` window along ``axis`` (stride 1);
    ``pad`` identity elements of a sum, max or min (of a float ``x``) go in
    front first.  Sums and products keep ``x``'s dtype."""
    if pad:
        fill = {"max": -math.inf, "min": math.inf}.get(kind, 0)
        widths = [(0, 0)] * x.ndim
        widths[axis] = (pad, 0)
        x = halo_pad(x, widths, [fill] * x.ndim)
    win = x.unfold(axis, window, 1)
    if kind == "sum":
        return win.sum(-1, dtype=x.dtype)
    if kind == "prod":
        return win.prod(-1, dtype=x.dtype)
    if kind == "max":
        return win.amax(-1)
    if kind == "min":
        return win.amin(-1)
    raise NotImplementedError(kind)


class SlidingWindowReduce(ArrayExpr):
    """reduce(sliding_window_view(x, w, axis), axis=window_dim) fused.

    Output length n-w+1 along ``axis`` ("valid" windows).
    """

    _parameters = ("array", "kind", "window", "axis", "_dtype")

    def _name_prefix(self):
        return f"swr-{self.kind}"

    @functools.cached_property
    def chunks(self):
        out = list(self.array.chunks)
        out[self.axis] = tuple(trim_tail(out[self.axis], self.window - 1))
        return tuple(out)

    @functools.cached_property
    def _meta(self):
        dtype = self.operand("_dtype")
        if dtype is not None:
            return np.empty((0,) * self.array.ndim, dtype=np.dtype(dtype))
        probe = np.empty((1,) * self.array.ndim, dtype=self.array.dtype)
        out = getattr(np, self.kind)(probe, axis=self.axis)
        keep = self.kind in ("max", "min", "nanmax", "nanmin")
        return np.empty((0,) * self.array.ndim, dtype=probe.dtype if keep else out.dtype)

    def _build(self, ctx):
        dense = ctx.build(self.array).dense()
        w, axis, kind = self.window, self.axis, self.kind
        if kind in ("sum", "prod"):
            # accumulate in the output dtype (bool counts become ints, and an
            # explicit dtype= accumulates wide, as numpy does)
            out = _reduce_window(to_compute(dense, self.dtype), kind, w, axis)
        elif kind in ("max", "min", "nanmax", "nanmin") and not dense.is_floating_point():
            # integers carry no NaNs; uint64 bits with the sign bit flipped
            # order as signed
            flip = dense.dtype == torch.uint64
            x = dense.to(torch.int32) if dense.dtype == torch.bool else computable(dense)
            out = _reduce_window(x ^ INT64_MIN if flip else x, kind.removeprefix("nan"), w, axis)
            out = out ^ INT64_MIN if flip else out
        elif kind in ("max", "min"):
            out = _reduce_window(dense, kind, w, axis)
        elif kind == "mean":
            out = _reduce_window(to_compute(dense, self.dtype), "sum", w, axis) / w
        elif kind in ("var", "std"):
            # shifted power sums: without the shift, s2/w - mean^2 loses all
            # precision when |mean| >> std
            x = to_compute(dense, self.dtype)
            d = x - x.mean()
            s = _reduce_window(d, "sum", w, axis)
            s2 = _reduce_window(d * d, "sum", w, axis)
            out = torch.clamp_min(s2 / w - (s / w) ** 2, 0)
            if kind == "std":
                out = torch.sqrt(out)
        elif kind in ("any", "all"):
            s = _reduce_window(to_compute(dense, self.dtype).to(torch.int32), "sum", w, axis)
            out = (s > 0) if kind == "any" else (s == w)
        elif kind in ("nansum", "nanprod", "nanmean"):
            x = to_compute(dense, self.dtype)
            base = "prod" if kind == "nanprod" else "sum"
            if x.is_floating_point() or x.is_complex():
                valid = ~torch.isnan(x)  # complex: real or imaginary NaN, as numpy
                out = _reduce_window(torch.where(valid, x, 1 if kind == "nanprod" else 0), base, w, axis)
                if kind == "nanmean":
                    cnt = _reduce_window(valid.to(torch.int32), "sum", w, axis)
                    out = torch.where(cnt == 0, torch.nan, out / cnt.clamp(min=1))
            else:
                # no NaNs representable: the nan-kind degenerates
                out = _reduce_window(x, base, w, axis)
                if kind == "nanmean":
                    out = out / w
        elif kind in ("nanmin", "nanmax"):
            valid = ~torch.isnan(dense)
            fill = math.inf if kind == "nanmin" else -math.inf
            out = _reduce_window(torch.where(valid, dense, fill), kind[3:], w, axis)
            cnt = _reduce_window(valid.to(torch.int32), "sum", w, axis)
            out = torch.where(cnt == 0, torch.nan, out)
        else:
            raise NotImplementedError(kind)
        return BlockView(self.chunks, dense=cast(out, self.dtype))


# reduction kinds the fusion understands
FUSABLE_WINDOW_REDUCERS = {
    "sum", "prod", "max", "min", "mean", "var", "std", "any", "all",
    "nansum", "nanprod", "nanmin", "nanmax", "nanmean",
}


class MovingWindowReduction(ArrayExpr):
    """bottleneck move_* semantics: trailing windows, NaN below min_count."""

    _parameters = ("array", "kind", "window", "min_count", "axis")

    def _name_prefix(self):
        return f"move-{self.kind}"

    @property
    def chunks(self):
        return self.array.chunks

    @functools.cached_property
    def _meta(self):
        dt = self.array.dtype
        if not is_float_dtype(dt):
            dt = np.dtype("f8")
        return np.empty((0,) * self.array.ndim, dtype=dt)

    def _build(self, ctx):
        dense = to_compute(ctx.build(self.array).dense(), self.dtype)
        w, axis, kind = self.window, self.axis, self.kind
        mc = self.min_count if self.min_count is not None else w
        valid = ~torch.isnan(dense)
        count = _reduce_window(valid.to(torch.int32), "sum", w, axis, w - 1)
        if kind in ("sum", "mean"):
            s = _reduce_window(torch.where(valid, dense, 0), "sum", w, axis, w - 1)
            out = s if kind == "sum" else s / count.clamp(min=1)
        elif kind in ("max", "min"):
            fill = -math.inf if kind == "max" else math.inf
            out = _reduce_window(torch.where(valid, dense, fill), kind, w, axis, w - 1)
        elif kind in ("var", "std"):
            # shifted power sums with the global nanmean as the shift: it is
            # NaN only when every element is, and then count < min_count
            # masks the output anyway
            c = torch.nan_to_num(torch.nanmean(dense), nan=0.0)
            d = torch.where(valid, dense - c, 0)
            s = _reduce_window(d, "sum", w, axis, w - 1)
            s2 = _reduce_window(d * d, "sum", w, axis, w - 1)
            n = count.clamp(min=1)
            out = torch.clamp_min(s2 / n - (s / n) ** 2, 0)
            if kind == "std":
                out = torch.sqrt(out)
        else:
            raise NotImplementedError(kind)
        out = torch.where(count >= mc, out, torch.nan)
        return BlockView(self.chunks, dense=out)


def _move(a, kind, window, min_count=None, axis=-1):
    from dask_array_tpu_torch._collection import new_collection
    from dask_array_tpu_torch.ops._from_array import asarray

    a = asarray(a)
    axis = validate_axis(axis, a.ndim)
    if window < 1:
        raise ValueError("window must be >= 1")
    n = a.shape[axis]
    if not (isinstance(n, float) and math.isnan(n)) and window > n:
        raise ValueError(f"window {window} exceeds axis length {n}")
    return new_collection(
        MovingWindowReduction(a.expr, kind, int(window), int(min_count) if min_count else None, axis)
    )


def move_sum(a, window, min_count=None, axis=-1):
    return _move(a, "sum", window, min_count, axis)


def move_mean(a, window, min_count=None, axis=-1):
    return _move(a, "mean", window, min_count, axis)


def move_max(a, window, min_count=None, axis=-1):
    return _move(a, "max", window, min_count, axis)


def move_min(a, window, min_count=None, axis=-1):
    return _move(a, "min", window, min_count, axis)


def move_var(a, window, min_count=None, axis=-1):
    return _move(a, "var", window, min_count, axis)


def move_std(a, window, min_count=None, axis=-1):
    return _move(a, "std", window, min_count, axis)
