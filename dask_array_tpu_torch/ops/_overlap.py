"""Overlap / map_overlap: ghost-cell (halo) machinery for stencils, sliding
window views and forward fill.

Port of ``dask_array_tpu/ops/_overlap.py``: ``Overlap``, ``TrimInternal``,
``BandStencil``, ``overlap``, ``trim_internal``/``trim_overlap``,
``map_overlap``, ``SlidingWindowView``/``sliding_window_view`` and
``Push``/``push``, and ``ShardStencil``.  ``Overlap`` boundary-extends the
dense tensor over all axes in one ``kernels.halo.halo_pad`` (the halo kernel
on the card; numpy pad semantics, dask's "reflect" being numpy's
"symmetric") and takes each block with its halo as a view of it.  Under a
mesh, ``ShardStencil`` and ``BandStencil`` run per slot: one halo exchange
(two ``ppermute``s) a sharded axis, then the func on each slot's haloed
shard (``_shard_body``).
"""

from __future__ import annotations

import functools
import math
from numbers import Integral

import numpy as np
import torch

from dask_array_tpu_torch._chunks import cached_cumsum, cast, cat, is_float_dtype, to_compute, validate_axis
from dask_array_tpu_torch._executor import BlockView, iter_block_indices
from dask_array_tpu_torch._expr import ArrayExpr
from dask_array_tpu_torch.kernels.halo import halo_pad, numpy_mode, pad_axis_plain
from dask_array_tpu_torch.kernels.stencil import band_stencil_call
from dask_array_tpu_torch.parallel._sharded import ShardedView


def coerce_depth(ndim, depth):
    """depth -> {axis: (lo, hi)}"""
    if isinstance(depth, Integral):
        depth = (int(depth),) * ndim
    if isinstance(depth, (list, tuple)):
        depth = dict(enumerate(depth))
    out = {}
    for ax in range(ndim):
        d = depth.get(ax, 0)
        if isinstance(d, Integral):
            out[ax] = (int(d), int(d))
        else:
            out[ax] = (int(d[0]), int(d[1]))
    return out


def coerce_boundary(ndim, boundary):
    """boundary -> {axis: mode} with mode in {'reflect','periodic','nearest',
    'none'} or a constant fill value."""
    if boundary is None:
        boundary = "none"
    if not isinstance(boundary, dict):
        if isinstance(boundary, (list, tuple)):
            boundary = dict(enumerate(boundary))
        else:
            boundary = {ax: boundary for ax in range(ndim)}
    return {ax: boundary.get(ax, "none") for ax in range(ndim)}


def _halo_sides(i, n, lo, hi, bd, mlo, mhi):
    """(lo, hi) halo widths block ``i`` of ``n`` carries along one axis."""
    take_lo = lo if (i > 0 or bd != "none" or mlo) else 0
    take_hi = hi if (i < n - 1 or bd != "none" or mhi) else 0
    return take_lo, take_hi


class Overlap(ArrayExpr):
    """Each block grows by its halo (ghost cells from neighbors/boundary).

    ``margin`` (per-axis ``(mlo, mhi)``) marks extra source rows at the
    array's ends that serve as halo only: they belong to no block's body
    and suppress boundary handling at their edge.  A block-aligned slice of
    an overlap pipeline pushes down by converting the cut's neighbor rows
    into margins; ``body_chunks`` then carries the body grid.
    """

    _parameters = ("array", "depth", "boundary", "margin", "body_chunks")
    _defaults = {"margin": None, "body_chunks": None}

    @functools.cached_property
    def _margins(self):
        m = self.operand("margin")
        if m is None:
            return tuple((0, 0) for _ in self.depth)
        return tuple(tuple(x) for x in m)

    @functools.cached_property
    def _body_grid(self):
        b = self.operand("body_chunks")
        if b is None:
            return self.array.chunks
        return tuple(tuple(x) for x in b)

    @functools.cached_property
    def chunks(self):
        out = []
        for ax, c in enumerate(self._body_grid):
            lo, hi = self.depth[ax]
            mlo, mhi = self._margins[ax]
            n = len(c)
            out.append(tuple(
                size + sum(_halo_sides(i, n, lo, hi, self.boundary[ax], mlo, mhi))
                for i, size in enumerate(c)
            ))
        return tuple(out)

    @property
    def _meta(self):
        return self.array._meta

    def transfer_bytes(self):
        """Halo bytes moved between blocks."""
        itemsize = self.dtype.itemsize
        total = 0
        grid = self._body_grid
        for ax, c in enumerate(grid):
            lo, hi = self.depth[ax]
            mlo, mhi = self._margins[ax]
            other = math.prod(sum(c2) for ax2, c2 in enumerate(grid) if ax2 != ax)
            cuts = max(0, len(c) - 1) + bool(mlo) + bool(mhi)
            total += (lo + hi) * cuts * other * itemsize
        return (total, total)

    def _build(self, ctx):
        dense = ctx.build(self.array).dense()
        # boundary-extend every axis in one halo_pad (one kernel launch on
        # the card); sides with a margin already carry their halo rows in the
        # data and get no pad, and with no pad at all the input comes back
        widths, modes, offsets = [], [], []
        for ax in range(dense.ndim):
            lo, hi = self.depth[ax]
            bd = self.boundary[ax]
            mlo, mhi = self._margins[ax]
            plo = lo if (bd != "none" and not mlo) else 0
            phi = hi if (bd != "none" and not mhi) else 0
            widths.append((plo, phi))
            modes.append(numpy_mode(bd) if (plo or phi) else bd)  # not read without a width
            offsets.append(mlo + plo)
        dense = halo_pad(dense, widths, modes)

        grid = self._body_grid
        bounds = [cached_cumsum(c, initial_zero=True) for c in grid]
        n_ax = tuple(len(c) for c in grid)
        blocks = {}
        for idx in iter_block_indices(n_ax):
            sl = []
            for ax, i in enumerate(idx):
                lo, hi = self.depth[ax]
                mlo, mhi = self._margins[ax]
                take_lo, take_hi = _halo_sides(i, n_ax[ax], lo, hi, self.boundary[ax], mlo, mhi)
                start = bounds[ax][i] + offsets[ax]
                stop = bounds[ax][i + 1] + offsets[ax]
                sl.append(slice(start - take_lo, stop + take_hi))
            blocks[tuple(idx)] = dense[tuple(sl)]
        return BlockView(self.chunks, blocks=blocks)

    def _accept_slice(self, index):
        """Push a basic slice below the halo machinery.

        Non-halo axes commute; a halo axis accepts whole-OUTPUT-block
        slices: the cut's neighbor rows join the pushed slice as margins."""
        from dask_array_tpu_torch._slicing import Slice, is_basic_index, sliced_blockdim

        if not is_basic_index(index):
            return None
        body = self._body_grid
        out_chunks = self.chunks
        inner, outer, new_margin, new_body = [], [], [], []
        changed = False
        for ax, ind in enumerate(index):
            lo, hi = self.depth[ax]
            bd = self.boundary[ax]
            mlo, mhi = self._margins[ax]
            c = body[ax]
            n = len(c)

            def keep(ind=ind, c=c, mlo=mlo, mhi=mhi):
                # this axis stays outside (applied after the overlap)
                inner.append(slice(None))
                outer.append(ind)
                new_margin.append((mlo, mhi))
                new_body.append(c)

            if ind == slice(None) or isinstance(ind, Integral):
                keep()
                continue
            if not (lo or hi):
                nc, _ = sliced_blockdim(c, ind)
                inner.append(ind)
                outer.append(slice(None))
                new_margin.append((0, 0))
                new_body.append(tuple(nc))
                changed = True
                continue
            start, stop, step = ind.indices(int(sum(out_chunks[ax])))
            if step != 1 or stop <= start:
                keep()
                continue
            ob = np.cumsum((0,) + tuple(int(x) for x in out_chunks[ax]))
            i0 = int(np.searchsorted(ob, start))
            i1 = int(np.searchsorted(ob, stop))
            if ob[i0] != start or ob[i1] != stop or i1 <= i0:
                keep()  # not whole output blocks
                continue
            if i0 == 0 and i1 == n:
                keep(slice(None))
                continue
            if bd == "periodic" and (i0 == 0 or i1 == n):
                # a true-edge panel's wrap halo comes from the OTHER end of
                # the array: a contiguous leaf region cannot supply it
                keep()
                continue
            bb = np.cumsum((0,) + tuple(int(x) for x in c))
            a_in = 0 if i0 == 0 else mlo + int(bb[i0]) - lo
            b_in = mlo + int(bb[n]) + mhi if i1 == n else mlo + int(bb[i1]) + hi
            inner.append(slice(int(a_in), int(b_in), 1))
            outer.append(slice(None))
            new_margin.append((lo if i0 > 0 else mlo, hi if i1 < n else mhi))
            new_body.append(tuple(c[i0:i1]))
            changed = True
        if not changed:
            return None
        pushed = Overlap(
            Slice(self.array, tuple(inner)),
            self.depth,
            self.boundary,
            tuple(new_margin),
            tuple(new_body),
        )
        if all(o == slice(None) for o in outer):
            return pushed
        return Slice(pushed, tuple(outer))


class TrimInternal(ArrayExpr):
    """Shave halos back off every block.

    ``margin`` (per-axis ``(mlo, mhi)``) marks edge blocks that carry halos
    despite being first/last — the trace a block-aligned slice leaves when
    it cuts an overlap pipeline mid-array."""

    _parameters = ("array", "depth", "boundary", "margin")
    _defaults = {"margin": None}

    @functools.cached_property
    def _margins(self):
        m = self.operand("margin")
        if m is None:
            return tuple((0, 0) for _ in self.depth)
        return tuple(tuple(x) for x in m)

    @functools.cached_property
    def chunks(self):
        out = []
        for ax, c in enumerate(self.array.chunks):
            lo, hi = self.depth[ax]
            mlo, mhi = self._margins[ax]
            n = len(c)
            out.append(tuple(
                size - sum(_halo_sides(i, n, lo, hi, self.boundary[ax], mlo, mhi))
                for i, size in enumerate(c)
            ))
        return tuple(out)

    @property
    def _meta(self):
        return self.array._meta

    def _build(self, ctx):
        view = ctx.build(self.array)
        n_ax = view.numblocks
        blocks = {}
        for idx in iter_block_indices(n_ax):
            b = view.block(idx)
            sl = []
            for ax, i in enumerate(idx):
                lo, hi = self.depth[ax]
                mlo, mhi = self._margins[ax]
                cut_lo, cut_hi = _halo_sides(i, n_ax[ax], lo, hi, self.boundary[ax], mlo, mhi)
                sl.append(slice(cut_lo, b.shape[ax] - cut_hi))
            blocks[tuple(idx)] = b[tuple(sl)]
        return BlockView(self.chunks, blocks=blocks)

    def _accept_slice(self, index):
        """Non-halo axes commute; a halo axis accepts whole-OUTPUT-block
        slices, converting them to whole overlapped blocks of the child
        with margins marking the halos the new edge blocks carry."""
        from dask_array_tpu_torch._slicing import Slice, is_basic_index

        if not is_basic_index(index):
            return None
        out_chunks = self.chunks
        ov_chunks = self.array.chunks
        inner, outer, new_margin = [], [], []
        changed = False
        for ax, ind in enumerate(index):
            lo, hi = self.depth[ax]
            bd = self.boundary[ax]
            mlo, mhi = self._margins[ax]
            n = len(out_chunks[ax])

            def keep(ind=ind, mlo=mlo, mhi=mhi):
                inner.append(slice(None))
                outer.append(ind)
                new_margin.append((mlo, mhi))

            if ind == slice(None) or isinstance(ind, Integral):
                keep()
                continue
            if not (lo or hi):
                inner.append(ind)
                outer.append(slice(None))
                new_margin.append((0, 0))
                changed = True
                continue
            start, stop, step = ind.indices(int(sum(out_chunks[ax])))
            if step != 1 or stop <= start:
                keep()
                continue
            ob = np.cumsum((0,) + tuple(int(x) for x in out_chunks[ax]))
            i0 = int(np.searchsorted(ob, start))
            i1 = int(np.searchsorted(ob, stop))
            if ob[i0] != start or ob[i1] != stop or i1 <= i0:
                keep()  # not whole output blocks
                continue
            if i0 == 0 and i1 == n:
                keep(slice(None))
                continue
            if bd == "periodic" and (i0 == 0 or i1 == n):
                keep()  # wrap halo needs the array's other end (see Overlap)
                continue
            ovb = np.cumsum((0,) + tuple(int(x) for x in ov_chunks[ax]))
            inner.append(slice(int(ovb[i0]), int(ovb[i1]), 1))
            outer.append(slice(None))
            new_margin.append((lo if i0 > 0 else mlo, hi if i1 < n else mhi))
            changed = True
        if not changed:
            return None
        pushed = TrimInternal(
            Slice(self.array, tuple(inner)),
            self.depth,
            self.boundary,
            tuple(new_margin),
        )
        if all(o == slice(None) for o in outer):
            return pushed
        return Slice(pushed, tuple(outer))


class BandStencil(ArrayExpr):
    """2-D ``map_overlap`` as one band-stencil call over the dense tensor.

    ``taps`` is the stencil spec ``kernels.stencil.stencil_spec`` read off
    ``func`` (its extra keywords already bound): a linear stencil's taps or
    a program of pointwise ops over shifted windows.  A CUDA kernel
    computes it, and on a CPU tensor the plain version runs ``func``
    itself (``kernels.stencil.band_stencil_call``); the result is cast to
    the meta dtype, as the reference's node casts the kernel's.  Same
    locality contract as the reference's node: ``func`` is local within
    ``depth`` and size-preserving.

    ``margin`` (per-axis ``(mlo, mhi)``) marks rows at the input's ends
    that serve as halo only, as in ``Overlap``: a slice pushed below the
    node (``_accept_slice``) reads its cut's neighbor rows as margins,
    computes over the slab and trims them, so the boundary applies only at
    the array's true edges; ``body_chunks`` is then the output grid.
    """

    _parameters = ("array", "func", "depth", "boundary", "_dtype", "taps", "margin", "body_chunks")
    _defaults = {"margin": None, "body_chunks": None}

    @functools.cached_property
    def _margins(self):
        m = self.operand("margin")
        if m is None:
            return tuple((0, 0) for _ in self.depth)
        return tuple(tuple(x) for x in m)

    @functools.cached_property
    def chunks(self):
        b = self.operand("body_chunks")
        return self.array.chunks if b is None else tuple(tuple(x) for x in b)

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * self.array.ndim, dtype=self._dtype)

    def transfer_bytes(self):
        """Halo bytes the stencil reads across block edges (the JAX
        package's ``ShardStencil`` model)."""
        itemsize = self.dtype.itemsize
        shape = self.array.shape
        total = 0
        for ax, (lo, hi) in enumerate(self.depth):
            total += (lo + hi) * math.prod(s for ax2, s in enumerate(shape) if ax2 != ax) * itemsize
        return (0, total)

    def _build(self, ctx):
        dep = tuple(lo for lo, _hi in self.depth)
        src = None
        if ctx.mesh is not None and not any(mlo or mhi for mlo, mhi in self._margins):
            src = _mesh_input(self, ctx)
        if src is not None:
            # under a mesh: the ShardStencil body, the band-stencil kernel
            # once a slot over its shard with halos from its neighbors (the
            # kernel pads the whole axes with the boundary itself)
            def func(padded, sharded_axes):
                out = band_stencil_call(padded.contiguous(), self.func, dep, tuple(self.boundary), self.taps)
                return out[tuple(
                    slice(d, out.shape[ax] - d) if ax in sharded_axes else slice(None) for ax, d in enumerate(dep)
                )]

            out = _shard_body(src, ctx.mesh, self.depth, self.boundary, func, self._dtype, pad_whole=False)
            return ShardedView(self.chunks, out)
        dense = ctx.build(self.array).dense().contiguous()
        out = band_stencil_call(dense, self.func, dep, tuple(self.boundary), self.taps)
        if any(mlo or mhi for mlo, mhi in self._margins):
            # rows computed from the pad, not from data: trimmed
            out = out[tuple(slice(mlo, out.shape[ax] - mhi) for ax, (mlo, mhi) in enumerate(self._margins))]
        return BlockView(self.chunks, dense=cast(out, self._dtype))

    def _accept_slice(self, index):
        """Push a basic slice below the stencil.

        On an axis without depth the slice commutes.  On an axis with depth
        a unit-step slice widens by the depth into the input; a side that
        stops short of the array's end reads its neighbor rows as a margin,
        and a side at the true edge keeps the boundary.  A cut closer to an
        edge than the depth, a stepped slice or an integer stays outside,
        and so does a periodic axis's slice that reaches an edge (its wrap
        halo comes from the other end of the array)."""
        from dask_array_tpu_torch._slicing import Slice, is_basic_index, sliced_blockdim

        if not is_basic_index(index) or len(index) != len(self.depth):
            return None
        body = self.chunks
        inner, outer, new_margin, new_body = [], [], [], []
        changed = False
        for ax, ind in enumerate(index):
            lo, hi = self.depth[ax]
            mlo, mhi = self._margins[ax]
            c = body[ax]
            n = int(sum(c))
            start, stop, step = ind.indices(n) if isinstance(ind, slice) else (0, n, 1)
            cut = None
            if isinstance(ind, slice) and step == 1 and stop > start and (start, stop) != (0, n):
                if not (lo or hi):
                    cut = (start + mlo, stop + mlo, 0, 0)
                else:
                    length = mlo + n + mhi
                    a_in, b_in = mlo + start - lo, mlo + stop + hi
                    top = (a_in, lo) if a_in >= 0 else (0, 0) if start == 0 and mlo == 0 else None
                    bottom = (b_in, hi) if b_in <= length else (length, 0) if stop == n and mhi == 0 else None
                    edge = top is not None and bottom is not None and (top[1] == 0 or bottom[1] == 0)
                    if top is not None and bottom is not None and not (edge and self.boundary[ax] == "periodic"):
                        cut = (top[0], bottom[0], top[1], bottom[1])
            if cut is None:
                inner.append(slice(None))
                outer.append(ind)
                new_margin.append((mlo, mhi))
                new_body.append(c)
                continue
            a, b, nlo, nhi = cut
            inner.append(slice(a, b, 1))
            outer.append(slice(None))
            new_margin.append((nlo, nhi))
            new_body.append(tuple(sliced_blockdim(c, slice(start, stop, 1))[0]))
            changed = True
        if not changed:
            return None
        pushed = BandStencil(
            Slice(self.array, tuple(inner)),
            self.func,
            self.depth,
            self.boundary,
            self._dtype,
            self.taps,
            tuple(new_margin),
            tuple(new_body),
        )
        if all(o == slice(None) for o in outer):
            return pushed
        return Slice(pushed, tuple(outer))


class ShardStencil(ArrayExpr):
    """``map_overlap`` as one shard-level stencil with explicit collectives.

    Opt-in via config ``"overlap-method": "shard"`` (for a func the
    band-stencil kernel does not take).  Under a mesh each slot
    ring-exchanges one lo/hi halo per sharded axis (two ``ppermute``s),
    realizes the boundary locally on the edge slots and on whole axes (the
    halo kernel), applies ``func`` to its whole haloed shard and trims.
    Without a mesh, or with a halo deeper than a shard, it is pad -> func
    -> trim over the whole array.

    Contract: ``func`` is local (output at a point depends only on inputs
    within ``depth``) and size-preserving, the standard ``map_overlap``
    assumption; block boundaries inside a shard are never cut.
    """

    _parameters = ("array", "func", "depth", "boundary", "kwargs", "_dtype")

    @functools.cached_property
    def chunks(self):
        return self.array.chunks

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * self.array.ndim, dtype=self._dtype)

    transfer_bytes = BandStencil.transfer_bytes

    def _func(self, padded):
        return self.func(padded, **dict(self.kwargs or ()))

    def _apply_global(self, dense):
        """Mesh-free form: pad -> func -> trim over the whole array (equal
        to the per-block form under the locality contract)."""
        widths = [(lo, hi) for lo, hi in self.depth]
        modes = [numpy_mode(bd) if (lo or hi) else "edge" for (lo, hi), bd in zip(self.depth, self.boundary)]
        out = self._func(halo_pad(dense, widths, modes))
        out = out[tuple(slice(lo, out.shape[ax] - hi) for ax, (lo, hi) in enumerate(self.depth))]
        return cast(out, self._dtype)

    def _build(self, ctx):
        src = _mesh_input(self, ctx) if ctx.mesh is not None else None
        if src is None:
            return BlockView(self.chunks, dense=self._apply_global(ctx.build(self.array).dense()))

        def func(padded, sharded_axes):
            out = self._func(padded)
            return out[tuple(slice(lo, out.shape[ax] - hi) for ax, (lo, hi) in enumerate(self.depth))]

        out = _shard_body(src, ctx.mesh, self.depth, self.boundary, func, self._dtype, pad_whole=True)
        return ShardedView(self.chunks, out)


def _mesh_input(node, ctx):
    """A stencil's input under a mesh, as the shard body takes it: a sharded
    input as it is where its parts are deep enough (else resharded to the
    stencil's layout, ``partition.stencil_input``), a dense one with the
    layout it is sharded under; None where the stencil runs whole."""
    from dask_array_tpu_torch.parallel.partition import stencil_input

    spec = _stencil_spec(node.array, node.depth, ctx.mesh)
    st = stencil_input(node, ctx, spec)
    if st is not None or spec is None:
        return st
    return ctx.build(node.array).dense(), spec


def _stencil_spec(array, depth, mesh):
    """The mesh layout a stencil runs under (``plan_layout`` of its input),
    or None where it runs whole: no axis is sharded, or a shard is
    shallower than its halo (a nested entry like ``("dcn", "x")``
    shards over the group's product)."""
    from dask_array_tpu_torch.parallel._sharded import spec_size
    from dask_array_tpu_torch.parallel.layout import plan_layout

    spec = plan_layout(array.shape, array.chunks, mesh)
    for ax, name in enumerate(spec):
        lo, hi = depth[ax]
        if name is not None and (lo or hi) and array.shape[ax] // spec_size(mesh, name) < max(lo, hi):
            return None
    return None if all(s is None for s in spec) else spec


def _edge_fill(shard, ax, width, bd, side):
    """A global edge's halo from the slot's own edge rows."""
    lo, hi = (width, 0) if side == "lo" else (0, width)
    padded = pad_axis_plain(shard, ax, lo, hi, numpy_mode(bd))
    start = 0 if side == "lo" else padded.shape[ax] - width
    return padded.narrow(ax, start, width)


def _shard_body(src, mesh, depth, boundary, func, dtype, pad_whole):
    """The per-slot stencil over ``src``: a ``ShardedTensor``, or a dense
    tensor and the spec to shard it under.  Along each sharded axis with
    depth exchange one halo each way between ring neighbors (the edge slots
    realize the boundary, a periodic ring wraps); with ``pad_whole`` pad
    the whole axes with their boundary (one ``halo_pad`` a slot); then
    ``func(padded, sharded_axes)`` returns the slot's trimmed output.
    Returns the ``ShardedTensor`` of outputs, in the input's layout."""
    from dask_array_tpu_torch.parallel._sharded import ShardedTensor, entry_names, shard
    from dask_array_tpu_torch.parallel.collectives import group_size, ppermute

    st = src if isinstance(src, ShardedTensor) else shard(src[0], mesh, src[1])
    spec = st.spec
    shards = list(st.shards)
    sharded_axes = set()
    for ax, (lo, hi) in enumerate(depth):
        name = spec[ax]
        if name is None or not (lo or hi):
            continue
        sharded_axes.add(ax)
        names = entry_names(name)
        n = group_size(mesh, names)
        bd = boundary[ax]
        wrap = bd == "periodic"
        from_left = from_right = None
        if lo:
            tails = [t.narrow(ax, t.shape[ax] - lo, lo) for t in shards]
            fwd = [(i, (i + 1) % n) for i in range(n if wrap else n - 1)]
            from_left = ppermute(tails, mesh, names, fwd)
        if hi:
            heads = [t.narrow(ax, 0, hi) for t in shards]
            bwd = [(i, (i - 1) % n) for i in range(n) if wrap or i > 0]
            from_right = ppermute(heads, mesh, names, bwd)
        grown = []
        for s, t in enumerate(shards):
            parts = []
            if lo:
                parts.append(from_left[s] if from_left[s] is not None else _edge_fill(t, ax, lo, bd, "lo"))
            parts.append(t)
            if hi:
                parts.append(from_right[s] if from_right[s] is not None else _edge_fill(t, ax, hi, bd, "hi"))
            grown.append(cat(parts, dim=ax) if len(parts) > 1 else t)
        shards = grown
    outs = []
    for t in shards:
        if pad_whole:
            widths = [(lo, hi) if ax not in sharded_axes else (0, 0) for ax, (lo, hi) in enumerate(depth)]
            modes = [numpy_mode(bd) if w != (0, 0) else "edge" for w, bd in zip(widths, boundary)]
            t = halo_pad(t, widths, modes)
        outs.append(cast(func(t, sharded_axes), dtype))
    return ShardedTensor(mesh, st.spec, outs, st.global_shape, st.bounds)


def _shard_stencil_eligible(arrays, depths, bounds, trim, kwargs):
    """Route map_overlap through ShardStencil?  (opt-in method="shard")"""
    if len(arrays) != 1 or not trim:
        return False
    if any(k in kwargs for k in ("chunks", "new_axis", "drop_axis", "meta")):
        return False  # shape-changing funcs keep the per-block pipeline
    d, b = depths[0], bounds[0]
    for ax in range(arrays[0].ndim):
        lo, hi = d[ax]
        if (lo or hi) and b[ax] == "none":
            return False  # 'none' shrinks edge halos: inherently per-block
    return True


def _normalize(x, depth, boundary):
    depth_map = coerce_depth(x.ndim, depth)
    bd_map = coerce_boundary(x.ndim, boundary)
    dep = tuple(depth_map[ax] for ax in range(x.ndim))
    bd = tuple(bd_map[ax] for ax in range(x.ndim))
    return dep, bd


def overlap(x, depth, boundary=None, *, allow_rechunk=True):
    """Add ghost cells to every block."""
    from dask_array_tpu_torch._collection import new_collection
    from dask_array_tpu_torch.ops._from_array import asarray

    x = asarray(x)
    dep, bd = _normalize(x, depth, boundary)
    # every chunk must be at least as large as the halo it donates
    for ax, (lo, hi) in enumerate(dep):
        need = max(lo, hi)
        if not need or len(x.chunks[ax]) == 1 or min(x.chunks[ax]) >= need:
            continue
        if not allow_rechunk:
            raise ValueError(
                f"overlap depth {need} exceeds the smallest chunk "
                f"({min(x.chunks[ax])}) along axis {ax}; rechunk first"
            )
        # merge neighboring chunks until each is >= the halo depth
        merged = []
        acc = 0
        for c in x.chunks[ax]:
            acc += c
            if acc >= need:
                merged.append(acc)
                acc = 0
        if acc:
            if merged:
                merged[-1] += acc
            else:
                merged.append(acc)
        target = list(x.chunks)
        target[ax] = tuple(merged)
        x = x.rechunk(tuple(target))
    return new_collection(Overlap(x.expr, dep, bd))


def trim_internal(x, axes, boundary=None):
    """Trim ``axes[ax]`` elements off every internal block boundary of ``x``
    (the inverse of :func:`overlap`)."""
    from dask_array_tpu_torch._collection import new_collection

    dep, bd = _normalize(x, axes, boundary)
    return new_collection(TrimInternal(x.expr, dep, bd))


def _align(arrays):
    """Rechunk several arrays (right-aligned) onto the common refinement of
    their chunks per axis (the reference's ``unify_chunks``)."""
    from dask_array_tpu_torch._chunks import common_blockdim

    ndim = max(a.ndim for a in arrays)
    inds = [tuple(range(ndim - a.ndim, ndim)) for a in arrays]
    by_label: dict = {}
    for a, ind in zip(arrays, inds):
        for pos, label in enumerate(ind):
            prev = by_label.get(label)
            c = a.chunks[pos]
            by_label[label] = c if prev is None or prev == c else common_blockdim([prev, c])
    return [a.rechunk(tuple(by_label[label] for label in ind)) for a, ind in zip(arrays, inds)]


def trim_overlap(x, depth, boundary=None):
    """Alias of :func:`trim_internal` taking a map_overlap-style ``depth``."""
    return trim_internal(x, depth, boundary=boundary)


def map_overlap(func, *args, depth=None, boundary=None, trim=True, align_arrays=True,
                allow_rechunk=True, **kwargs):
    """Apply ``func`` to blocks (of one or more arrays) with ghost cells.

    The pipeline is align -> overlap each array -> map_blocks -> trim.  An
    eligible 2-D single-array stencil (``kernels.stencil.use_band_stencil``:
    a linear stencil or a program of pointwise ops over shifted windows,
    its scalar keywords bound) becomes one ``BandStencil`` node instead.
    ``depth``/``boundary`` may be lists with one entry per array; trimming
    uses the highest-rank array's depth.
    """
    from dask_array_tpu_torch._collection import Array, new_collection
    from dask_array_tpu_torch._expr import compute_meta
    from dask_array_tpu_torch.kernels.stencil import bind_kwargs, use_band_stencil
    from dask_array_tpu_torch.ops._map_blocks import map_blocks

    if isinstance(func, Array) and args and callable(args[0]):
        # legacy map_overlap(x, func, ...) signature
        func, args = args[0], (func,) + args[1:]
    if not callable(func):
        raise TypeError(f"First argument must be callable function, not {type(func).__name__}")
    if not args or not all(isinstance(a, Array) for a in args):
        raise TypeError(
            f"All variadic arguments must be arrays, not {[type(a).__name__ for a in args]}"
        )
    arrays = list(args)

    def coerce(xs, arg, fn):
        if not isinstance(arg, list):
            arg = [arg] * len(xs)
        if len(arg) != len(xs):
            raise ValueError(
                f"got {len(arg)} entries for {len(xs)} array arguments; a "
                "list-form depth/boundary needs one entry per array"
            )
        return [fn(x.ndim, a) for x, a in zip(xs, arg)]

    depths = coerce(arrays, 0 if depth is None else depth, coerce_depth)
    bounds = coerce(arrays, boundary, coerce_boundary)

    if align_arrays and len(arrays) > 1:
        arrays = _align(arrays)

    # depth 0 everywhere: plain map_blocks
    if all(lo == 0 and hi == 0 for d in depths for (lo, hi) in d.values()):
        return map_blocks(func, *arrays, **kwargs)

    for i, (a, d, b) in enumerate(zip(arrays, depths, bounds)):
        for ax in range(a.ndim):
            lo, hi = d[ax]
            if lo != hi and b[ax] != "none":
                raise NotImplementedError(
                    "Asymmetric overlap is currently only implemented "
                    "for boundary='none', however boundary for dimension "
                    f"{ax} in array argument {i} is {b[ax]}"
                )

    dtype = kwargs.pop("dtype", None)
    fkw = {k: v for k, v in kwargs.items() if k not in ("name", "token")}
    spec = use_band_stencil(arrays, depths, bounds, trim, func, fkw)
    if spec is not None:
        a = arrays[0]
        bound = bind_kwargs(func, fkw)
        if dtype is None:
            meta = compute_meta(bound, a.ndim, a.expr)
            dtype = meta.dtype if meta is not None else a.dtype
        return new_collection(BandStencil(
            a.expr,
            bound,
            tuple(depths[0][ax] for ax in range(2)),
            tuple(bounds[0][ax] for ax in range(2)),
            np.dtype(dtype),
            spec,
        ))

    from dask_array_tpu_torch import config

    if config.get("overlap-method", "auto") == "shard" and _shard_stencil_eligible(
            arrays, depths, bounds, trim, kwargs):
        from dask_array_tpu_torch._blockwise import _normalize_kwargs

        a = arrays[0]
        if dtype is None:
            meta = compute_meta(func, a.ndim, a.expr, **fkw)
            dtype = getattr(meta, "dtype", a.dtype) if meta is not None else a.dtype
        return new_collection(ShardStencil(
            a.expr, func, tuple(depths[0][ax] for ax in range(a.ndim)),
            tuple(bounds[0][ax] for ax in range(a.ndim)), _normalize_kwargs(fkw), np.dtype(dtype),
        ))

    if dtype is not None:
        kwargs["dtype"] = dtype
    overlapped = [
        overlap(a, d, b, allow_rechunk=allow_rechunk)
        for a, d, b in zip(arrays, depths, bounds)
    ]
    mapped = map_blocks(func, *overlapped, **kwargs)
    if trim:
        # trim by the highest-rank array's halo (ties -> first)
        i = sorted(enumerate(arrays), key=lambda v: (v[1].ndim, -v[0]))[-1][0]
        return trim_internal(mapped, depths[i], bounds[i])
    return mapped


# ---------------------------------------------------------------------------
# sliding windows
# ---------------------------------------------------------------------------


class SlidingWindowView(ArrayExpr):
    """numpy.lib.stride_tricks.sliding_window_view semantics.

    Window axes are appended as trailing single-chunk dims; the windowed
    source axes lose (window-1) from their final chunk.  The view is
    ``Tensor.unfold`` per windowed axis, a strided view of the source that
    copies nothing (the JAX package gathers the windows with ``jnp.take``);
    ``unfold`` appends each window axis last, in the order of ``axes``.
    """

    _parameters = ("array", "window_shape", "axes")

    @functools.cached_property
    def chunks(self):
        out = [list(c) for c in self.array.chunks]
        for w, ax in zip(self.window_shape, self.axes):
            out[ax] = trim_tail(out[ax], w - 1)
        return tuple(tuple(c) for c in out) + tuple((w,) for w in self.window_shape)

    @property
    def _meta(self):
        return np.empty((0,) * (self.array.ndim + len(self.axes)), dtype=self.array.dtype)

    def _simplify_up(self, parent, dependents):
        # reduce(sliding_window_view(x)) over the window dim fuses into one
        # windowed reduction, and a scalar elementwise op sinks below the view
        from dask_array_tpu_torch._blockwise import Elemwise
        from dask_array_tpu_torch.ops._sliding import FUSABLE_WINDOW_REDUCERS, SlidingWindowReduce
        from dask_array_tpu_torch.ops.reductions import Reduction

        if (
            type(parent) is Reduction
            and parent.kind in FUSABLE_WINDOW_REDUCERS
            and len(self.window_shape) == 1
            and parent.axes == (self.array.ndim,)  # exactly the window dim
            and not (
                self.array.dtype.kind == "c"
                and parent.kind in ("min", "max", "nanmin", "nanmax", "any", "all")
            )
        ):
            if any(d._name != parent._name for d in dependents.get(self._name, ())):
                return None
            swr = SlidingWindowReduce(self.array, parent.kind, self.window_shape[0], self.axes[0], parent.dtype)
            if parent.keepdims:
                from dask_array_tpu_torch.ops.manipulation import ExpandDims

                return ExpandDims(swr, (self.array.ndim,))
            return swr
        if type(parent) is Elemwise:
            # elemwise commutes with the window view, and running it before
            # windowing is less work (n vs n*w elements); sinking the view
            # also lets var/std/nanvar/nanstd (elemwise chains over the view
            # ending in window-axis sums) fuse.  Only scalar (0-d) co-operands
            # are safe: anything with dims would broadcast against the window.
            new_args = []
            hit = False
            for a in parent.args:
                if isinstance(a, ArrayExpr):
                    if a._name == self._name:
                        new_args.append(self.array)
                        hit = True
                    elif a.ndim == 0:
                        new_args.append(a)
                    else:
                        return super()._simplify_up(parent, dependents)
                else:
                    if isinstance(a, np.ndarray) and a.ndim > 0:
                        return super()._simplify_up(parent, dependents)
                    new_args.append(a)
            if hit:
                inner = Elemwise(*parent.operands[:2], *new_args)
                return SlidingWindowView(inner, self.window_shape, self.axes)
        return super()._simplify_up(parent, dependents)

    def _accept_slice(self, index):
        """Push basic slicing through the window view.

        Two shapes: an all-int index addresses one source element
        (``view[i.., k..] == x[.., i+k, ..]``: the moment shift
        ``view[(0,)*nd]``), and lead-axis slicing with the window dims
        untouched maps to a slice of the source extended by ``window-1`` on
        windowed axes.
        """
        from dask_array_tpu_torch._slicing import Slice, is_basic_index

        if not is_basic_index(index):
            return None
        nd_in = self.array.ndim
        if len(index) != nd_in + len(self.axes):
            return None
        lead, trail = index[:nd_in], index[nd_in:]
        if all(isinstance(i, Integral) for i in index):
            xi = [int(i) for i in lead]
            for j, ax in enumerate(self.axes):
                xi[ax] += int(trail[j])
            return Slice(self.array, tuple(xi))
        if any(t != slice(None) for t in trail):
            return None
        windowed = set(self.axes)
        xi = []
        changed = False
        drop_before = {}
        dropped = 0
        for ax in range(nd_in):
            drop_before[ax] = dropped
            ind = lead[ax]
            if ax in windowed:
                if isinstance(ind, Integral):
                    return None  # window-collapse: only the all-int rule
                w = self.window_shape[self.axes.index(ax)]
                dim = self.array.shape[ax]
                if isinstance(dim, float) and math.isnan(dim):
                    return None
                start, stop, step = ind.indices(int(dim) - w + 1)
                if step != 1 or stop <= start:
                    return None
                xi.append(slice(start, stop - 1 + w, 1))
                if (start, stop) != (0, int(dim) - w + 1):
                    changed = True
            else:
                xi.append(ind)
                if isinstance(ind, Integral):
                    dropped += 1
                    changed = True
                elif ind != slice(None):
                    changed = True
        if not changed:
            return None
        new_axes = tuple(ax - drop_before[ax] for ax in self.axes)
        return SlidingWindowView(Slice(self.array, tuple(xi)), self.window_shape, new_axes)

    def _build(self, ctx):
        out = ctx.build(self.array).dense()
        for w, ax in zip(self.window_shape, self.axes):
            out = out.unfold(ax, w, 1)
        return BlockView(self.chunks, dense=out)


def trim_tail(chunks, n):
    """``chunks`` of one axis with ``n`` elements cut from the end (empty
    chunks dropped, ``[0]`` when nothing is left)."""
    out = list(chunks)
    i = len(out) - 1
    while n > 0 and i >= 0:
        cut = min(n, out[i])
        out[i] -= cut
        n -= cut
        i -= 1
    return [c for c in out if c > 0] or [0]


def sliding_window_view(x, window_shape, axis=None, **kwargs):
    from dask_array_tpu_torch._collection import new_collection
    from dask_array_tpu_torch.ops._from_array import asarray

    x = asarray(x)
    if isinstance(window_shape, Integral):
        window_shape = (int(window_shape),)
    window_shape = tuple(int(w) for w in window_shape)
    if axis is None:
        if len(window_shape) != x.ndim:
            raise ValueError("window_shape must match ndim when axis is None")
        axes = tuple(range(x.ndim))
    elif isinstance(axis, Integral):
        axes = (validate_axis(axis, x.ndim),)
    else:
        axes = tuple(validate_axis(a, x.ndim) for a in axis)
    if len(axes) != len(window_shape):
        raise ValueError("window_shape and axis must have the same length")
    for w, ax in zip(window_shape, axes):
        if w > x.shape[ax]:
            raise ValueError("window shape cannot be larger than input array shape")
        if w < 1:
            raise ValueError("`window_shape` must contain positive values")
    return new_collection(SlidingWindowView(x.expr, window_shape, axes))


# ---------------------------------------------------------------------------
# push (forward-fill)
# ---------------------------------------------------------------------------


class Push(ArrayExpr):
    """bottleneck.push semantics: forward-fill NaNs along an axis, at most
    ``n`` positions (None = unlimited).

    One ``torch.cummax`` over ``where(valid, position, -1)`` gives each
    position the index of the last valid value at or before it; a gather
    reads that value (the JAX package runs an associative scan).  NaN where
    no valid value came before, or where it lies more than ``n`` back.
    """

    _parameters = ("array", "n", "axis")

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
        dense = ctx.build(self.array).dense()
        if not isinstance(dense, torch.Tensor):
            return BlockView(self.chunks, dense=_push_numpy(dense.astype(self.dtype), self.n, self.axis))
        dense = to_compute(dense, self.dtype)
        axis = self.axis
        shape = [1] * dense.ndim
        shape[axis] = dense.shape[axis]
        pos = torch.arange(dense.shape[axis], device=dense.device).reshape(shape)
        last = torch.where(torch.isnan(dense), -1, pos).cummax(dim=axis).values
        out = torch.gather(dense, axis, last.clamp(min=0))
        stale = last < 0
        if self.n is not None:
            stale = stale | (pos - last > self.n)
        out = torch.where(stale, torch.nan, out)
        return BlockView(self.chunks, dense=out)


def _push_numpy(x, n, axis):
    """``Push`` of a host block with numpy's functions (a duck block
    dispatches through its type)."""
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    pos = np.arange(x.shape[axis]).reshape(shape)
    last = np.maximum.accumulate(np.where(np.isnan(x), -1, pos), axis=axis)
    out = np.take_along_axis(x, np.maximum(last, 0), axis=axis)
    stale = np.less(last, 0)  # (numpy's functions: a duck type need not have operators)
    if n is not None:
        stale = np.logical_or(stale, np.greater(np.subtract(pos, last), n))
    return np.where(stale, np.nan, out)


def push(array, n=None, axis=-1):
    """Forward-fill NaNs along ``axis`` (bottleneck-style ``push``); ``n``
    bounds how far a value propagates (default: unlimited)."""
    from dask_array_tpu_torch._collection import new_collection
    from dask_array_tpu_torch.ops._from_array import asarray

    array = asarray(array)
    axis = validate_axis(axis, array.ndim)
    return new_collection(Push(array.expr, int(n) if n is not None else None, axis))
