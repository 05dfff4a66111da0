"""histogram / histogram2d / histogramdd, and their counting step (K2).

Port of ``dask_array_tpu/ops/_histogram.py`` with its compare-accumulate
scan ``dask_array_tpu/kernels/histogram.py`` (K2).  Here K2 is
``kernels/histogram.py``: ``histogram_counts`` runs its plain version
(each value's bin by one ``searchsorted`` of numpy's order keys, then one
``torch.bincount``) for a CPU tensor and the hand CUDA kernel for a CUDA
tensor, which reads the data once with no host sync.  Each value is
compared in numpy's comparison dtype (int64 data against float edges in
float64, int against int in the integers, complex lexicographically), the
last bin closed, values outside the edges or NaN dropped; the counts are
int64, or the float64 (complex128) sums of the weights.

Edges given as numpy data, or derived from a numeric range, are numpy's
own (``np.histogram_bin_edges``).  Edges derived from the data's min/max
or from a lazy range (``LinspaceEdges``) bring their two endpoints to the
host in one sync: numpy's ValueError for a NaN or infinite range needs
them there; the edges are then numpy's linspace of those endpoints.
``histogramdd`` keeps its own ``searchsorted`` + ``bincount`` (the JAX
package does not reach K2 there).
"""

from __future__ import annotations

import builtins
import functools

import numpy as np
import torch

from dask_array_tpu_torch._chunks import array_of, cast, compute_dtype, numpy_dtype, tensor_of, to_compute, value_of
from dask_array_tpu_torch._executor import BlockView
from dask_array_tpu_torch._expr import ArrayExpr
from dask_array_tpu_torch.kernels.histogram import histogram_counts, positions


def _edges_tensor(edges, ctx):
    if isinstance(edges, ArrayExpr):
        return ctx.build(edges).dense()
    return tensor_of(np.ascontiguousarray(edges)).to(ctx.device)


class Histogram(ArrayExpr):
    """numpy's histogram of an array over host or lazy edges."""

    takes_narrow = True

    _parameters = ("array", "bins", "weights", "density", "nbins")

    def _name_prefix(self):
        return "histogram"

    @functools.cached_property
    def chunks(self):
        return ((self.nbins,),)

    @functools.cached_property
    def _meta(self):
        if self.density:
            dt = np.dtype("f8")
        elif self.weights is not None:
            dt = np.histogram(np.ones(1), bins=1, weights=np.ones(1, dtype=self.weights.dtype))[0].dtype
        else:
            dt = np.dtype(np.intp)
        return np.empty((0,), dtype=dt)

    def _build(self, ctx):
        x = ctx.build(self.array).dense()
        edges = self.edges(ctx)
        w = None if self.weights is None else ctx.build(self.weights).dense()
        return BlockView(self.chunks, dense=self.finish(self.counts(x, edges, w), edges))

    def edges(self, ctx):
        """The edges on the walk's device (built once a walk); narrow-typed
        edges (numpy's own for a narrow float's autodetected range) as
        their values."""
        edges = _edges_tensor(self.bins, ctx)
        return value_of(edges, self.bins.dtype if isinstance(self.bins, ArrayExpr) else np.asarray(self.bins).dtype)

    def counts(self, x, edges, w=None):
        """K2's counts of ``x`` (the whole array, or a slot's part of it),
        weighted by ``w`` (held as the data) where given."""
        if w is not None:
            w = to_compute(w, np.result_type(numpy_dtype(w.dtype), np.float64))
        return histogram_counts(x, edges, w, dtype=self.array.dtype)

    def finish(self, counts, edges):
        """The histogram from the counts of the whole array."""
        if self.density:
            # numpy: n / diff(edges) / n.sum(), the widths taken in the
            # edges' dtype, then in float64
            widths = to_compute(torch.diff(edges.reshape(-1)), np.float64)
            hist = counts.to(torch.float64) / widths / counts.sum().to(torch.float64)
        else:
            hist = counts
        return cast(hist, self.dtype) if hist.dtype != compute_dtype(self.dtype) else hist


class LinspaceEdges(ArrayExpr):
    """``npoints`` evenly spaced edges between two lazy scalars (the data's
    min and max, or a lazy range), numpy's linspace of them: the endpoints
    come to the host in one sync, where numpy checks them (a NaN or
    infinite range raises its ValueError) and spaces the edges."""

    takes_narrow = True

    _parameters = ("lo", "hi", "npoints", "data_dtype", "autodetected")

    def _name_prefix(self):
        return "linspace-edges"

    @functools.cached_property
    def chunks(self):
        return ((self.npoints,),)

    @functools.cached_property
    def _meta(self):
        dt = self.lo.dtype
        return np.empty((0,), dtype=self._edges(dt.type(0), dt.type(1)).dtype)

    def _edges(self, lo, hi):
        probe = np.empty(0, dtype=self.data_dtype)
        if self.autodetected:
            if not (np.isfinite(lo) and np.isfinite(hi)):
                raise ValueError(f"autodetected range of [{lo}, {hi}] is not finite")
            if lo == hi:
                lo, hi = lo - 0.5, hi + 0.5
        return np.histogram_bin_edges(probe, bins=self.npoints - 1, range=(lo, hi))

    def _build(self, ctx):
        from dask_array_tpu_torch._chunks import cat
        from dask_array_tpu_torch.ops._fancy_indexing import count_sync

        lo, hi = array_of(cat([ctx.build(e).dense().reshape(1) for e in (self.lo, self.hi)]).cpu(), self.lo.dtype)
        count_sync()
        return BlockView(self.chunks, dense=tensor_of(self._edges(lo, hi)).to(ctx.device))


def _scalar_expr(v):
    from dask_array_tpu_torch.ops._from_array import asarray

    return asarray(v).astype("f8").expr


def _resolve_edges(a, bins, range):
    """(edges: a numpy array or an expression, nbins, the edges' collection
    or None for numpy edges)."""
    from dask_array_tpu_torch._collection import Array, new_collection

    if isinstance(bins, Array):
        return bins.expr, bins.shape[0] - 1, bins
    if np.ndim(bins) == 1:
        edges = np.asarray(bins)
        if edges.dtype.kind not in "iufc":
            edges = edges.astype("f8")
        if np.any(edges[:-1] > edges[1:]):
            raise ValueError("`bins` must increase monotonically, when an array")
        return edges, len(edges) - 1, None
    n = int(bins)
    if n < 1:
        raise ValueError("`bins` must be positive, when an integer")
    if range is not None and not isinstance(range[0], Array) and not isinstance(range[1], Array):
        return np.histogram_bin_edges(np.empty(0, dtype=a.dtype), bins=n, range=tuple(range)), n, None
    if range is not None:
        lo, hi = _scalar_expr(range[0]), _scalar_expr(range[1])
        expr = LinspaceEdges(lo, hi, n + 1, a.dtype, False)
    elif a.size == 0:
        return np.histogram_bin_edges(np.empty(0, dtype=a.dtype), bins=n), n, None
    else:
        expr = LinspaceEdges(a.min().expr, a.max().expr, n + 1, a.dtype, True)
    return expr, n, new_collection(expr)


def _validate_bins_range(bins, range):
    from dask_array_tpu_torch._collection import Array

    if bins is None:
        raise ValueError("histogram requires a bins argument: pass bin edges or a bin count")
    if isinstance(bins, Array):
        if bins.ndim > 1:
            raise ValueError(f"bins must be a scalar count or 1-D edges, got {bins.ndim}-D")
    elif np.ndim(bins) > 1:
        raise ValueError(f"bins must be a scalar count or 1-D edges, got {np.ndim(bins)}-D")
    if range is not None:
        if isinstance(range, Array):
            if range.ndim != 1 or range.shape[0] != 2:
                raise ValueError(f"range must be a pair (lo, hi), got an array of shape {range.shape}")
        elif np.ndim(range) == 0:
            raise TypeError(f"range must be a pair (lo, hi), got {range!r}")
        elif np.ndim(range) > 1 or builtins.len(range) != 2:
            raise ValueError(f"range must be a pair (lo, hi), got {range!r}")


def histogram(a, bins=None, range=None, normed=False, weights=None, density=None):
    """numpy's histogram: (counts, edges).  ``bins`` is a count (edges from
    ``range``, or lazily from the data's min and max) or the edges
    themselves (numpy or lazy)."""
    from dask_array_tpu_torch._collection import Array, new_collection
    from dask_array_tpu_torch.ops._from_array import asarray, from_array

    if normed:
        raise ValueError("The normed= keyword is deprecated in numpy and unsupported here; use density=True instead")
    _validate_bins_range(bins, range)
    if isinstance(bins, Array) and bins.ndim == 0:
        # a lazy bin count fixes the result's shape: resolved when built
        if density:
            raise NotImplementedError("`bins` cannot be a scalar Dask object when density=True; compute it first "
                                      "or pass a concrete int")
        bins = int(bins.compute())
    a = asarray(a)
    if weights is not None:
        weights = asarray(weights)
        if weights.shape != a.shape:
            raise ValueError("weights should have the same shape as a.")
    edges, nbins, edges_coll = _resolve_edges(a, bins, range)
    hist = new_collection(Histogram(a.expr, edges, None if weights is None else weights.expr, bool(density), nbins))
    return hist, from_array(edges, chunks=-1) if edges_coll is None else edges_coll


class HistogramDD(ArrayExpr):
    """numpy's histogramdd: every coordinate's bin by ``searchsorted``
    (side right, a value on the last edge moved into the last bin), one
    outlier bin each side, one ``bincount`` of the raveled bins; float64
    counts.  Operands after the fixed ones: the coordinates, then the lazy
    edges (one per None in ``edge_arrays``)."""

    _parameters = ("weights", "density", "edge_arrays", "shape_", "ncoords", "sample_dtype")

    @property
    def coords(self):
        return self.operands[6:6 + self.ncoords]

    @property
    def lazy_edges(self):
        return self.operands[6 + self.ncoords:]

    @functools.cached_property
    def chunks(self):
        return tuple((s,) for s in self.shape_)

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.shape_), dtype=np.dtype("f8"))

    def _build(self, ctx):
        lazy = iter(self.lazy_edges)
        edges = [_edges_tensor(next(lazy) if e is None else e, ctx) for e in self.edge_arrays]
        nbin = [e.shape[0] + 1 for e in edges]
        flat = None
        for c, e, stride in zip(self.coords, edges, np.cumprod([1] + nbin[::-1])[::-1][1:].tolist()):
            pos, on_last = positions(cast(ctx.build(c).dense().reshape(-1), self.sample_dtype), e)
            idx = pos - on_last.to(torch.int64)
            flat = idx * stride if flat is None else flat + idx * stride
        total = int(np.prod(nbin))
        if self.weights is None:
            hist = torch.bincount(flat, minlength=total).to(torch.float64)
        else:
            w = to_compute(ctx.build(self.weights).dense().reshape(-1), np.float64)
            hist = torch.bincount(flat, weights=w, minlength=total)
        hist = hist.reshape(nbin)[(slice(1, -1),) * len(nbin)]
        if self.density:
            s = hist.sum()
            for i, e in enumerate(edges):
                shape = [1] * len(nbin)
                shape[i] = nbin[i] - 2
                hist = hist / to_compute(torch.diff(e), np.float64).reshape(shape)
            hist = hist / s
        return BlockView(self.chunks, dense=hist)


def histogramdd(sample, bins=10, range=None, normed=False, weights=None, density=None):
    """numpy's histogramdd of an (N, D) array or a sequence of D arrays:
    (float64 counts, a list of the edges)."""
    from dask_array_tpu_torch._collection import Array, new_collection
    from dask_array_tpu_torch.ops._from_array import asarray, from_array

    if normed and density:
        raise TypeError("Cannot specify both 'normed' and 'density'")
    if isinstance(sample, Array):
        if sample.ndim != 2:
            raise ValueError("Single array input to histogramdd should be columnar, i.e. have two dimensions (N, "
                             f"D); got {sample.ndim}-D")
        coords = [sample[:, i].ravel() for i in builtins.range(sample.shape[1])]
    else:
        coords = [asarray(s).ravel() for s in sample]
    d = len(coords)
    sample_dtype = np.result_type(*[c.dtype for c in coords])
    coords = [c.astype(sample_dtype) for c in coords]
    dens = bool(density) if density is not None else bool(normed)
    if isinstance(bins, (list, tuple)):
        if len(bins) != d:
            raise ValueError("The dimension of bins must be equal to the dimension of the sample x.")
    else:
        bins = [bins] * d
    if range is None:
        ranges = [None] * d
    else:
        ranges = list(range)
        if len(ranges) != d:
            raise ValueError("range argument must have one entry per dimension")
    edge_arrays = []
    for i in builtins.range(d):
        b = bins[i]
        if np.ndim(b) == 1:
            e = np.asarray(b)
            if np.any(e[:-1] > e[1:]):
                raise ValueError(f"`bins[{i}]` must be monotonically increasing, when an array")
            edge_arrays.append(e)
        elif np.ndim(b) == 0:
            if b < 1:
                raise ValueError(f"`bins[{i}]` must be positive, when an integer")
            n = int(b)
            r = ranges[i]
            if r is None:
                edge_arrays.append(LinspaceEdges(coords[i].min().expr, coords[i].max().expr, n + 1, sample_dtype,
                                                 True))
            else:
                lo, hi = r
                if lo > hi:
                    raise ValueError("max must be larger than min in range parameter.")
                if not (np.isfinite(lo) and np.isfinite(hi)):
                    raise ValueError(f"supplied range of [{lo}, {hi}] is not finite")
                lo, hi = (lo - 0.5, hi + 0.5) if lo == hi else (lo, hi)
                edge_arrays.append(np.linspace(lo, hi, n + 1))
        else:
            raise ValueError(f"`bins[{i}]` must be a scalar or 1d array")
    w = None
    if weights is not None:
        weights = asarray(weights)
        if weights.dtype.kind == "c":
            raise TypeError(f"Cannot cast array data from {weights.dtype!r} to dtype('float64') according to the "
                            "rule 'safe'")
        w = weights.ravel().expr
    shape_ = tuple((e.npoints if isinstance(e, ArrayExpr) else len(e)) - 1 for e in edge_arrays)
    static = tuple(None if isinstance(e, ArrayExpr) else e for e in edge_arrays)
    lazy = [e for e in edge_arrays if isinstance(e, ArrayExpr)]
    expr = HistogramDD(w, dens, static, shape_, d, sample_dtype, *[c.expr for c in coords], *lazy)
    edges = [new_collection(e) if isinstance(e, ArrayExpr) else from_array(e, chunks=-1) for e in edge_arrays]
    return new_collection(expr), edges


def histogram2d(x, y, bins=10, range=None, normed=False, weights=None, density=None):
    """numpy's histogram2d: ``histogramdd((x, y), ...)``, (counts, x
    edges, y edges)."""
    try:
        n = len(bins)
    except TypeError:
        n = 1
    if n not in (1, 2):
        bins = [np.asarray(bins), np.asarray(bins)]
    counts, edges = histogramdd((x, y), bins=bins, range=range, normed=normed, weights=weights, density=density)
    return counts, edges[0], edges[1]
