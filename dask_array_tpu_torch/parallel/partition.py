"""The partitioned walk: the port's counterpart of the JAX package's GSPMD
lane.

Under a mesh the JAX package puts every leaf up sharded and constrains it
(``dask_array_tpu/_executor.py``: ``_device_put_leaves``, the
``constrain_to_mesh`` of ``make_compute_fn``, ``BuildContext._constrain``
at ``Rechunk``/``Shuffle``), and XLA's SPMD partitioner keeps every op
sharded, inserting the collectives it needs.  The port has no partitioner;
this module is its rule table.  ``BuildContext.build`` asks ``build`` here
once for each node under a mesh:

* a leaf is bound sharded under ``plan_layout(shape, None, mesh,
  allow_uneven=True)`` (a persisted ``ShardedTensor`` under the same mesh
  as it is);
* a node whose family has a rule, and whose operands are sharded, runs per
  slot: each slot runs the node's own torch code or hand kernel on its
  shard (its own ``_build`` in a context seeded with the slot's operand
  tensors), collectives are inserted only where the rule needs them
  (recorded in ``_sharded.COLLECTIVES``), and the value stays a
  ``ShardedTensor``;
* any other node runs its dense ``_build``: an operand held sharded is
  gathered once to the mesh's first slot (``ShardedView.dense``).  So
  does a node with a narrow operand or result (``_chunks.is_narrow``)
  whose rule is not marked ``_takes_narrow``: a typed combine of its parts
  would order bit patterns as numbers or round once a part.

The rules, by node family:

=====================  ===========================================================
Elemwise               per slot; operands under the first full-shape operand's
                       layout (a broadcast operand cut to the slot's region,
                       another layout resharded); the scale kernel once a slot
Transpose              per slot, the spec permuted; the transpose kernel once a slot
Slice (basic)          per slot; a slice of a sharded axis narrows each part (the
                       part offsets become irregular), an integer on a sharded
                       axis takes the holder's value (one ``psum``)
Reduction              per slot over unsharded axes; over a sharded axis a partial
                       a slot and one ``psum``/``pmin``/``pmax`` (the shard lane's
                       typed combine), mean over the global count
ArgReduction           per slot along an unsharded axis; else the shard lane's
                       vote with global indices
CumReduction           per slot along an unsharded axis; else the shard lane's
                       scan (one ``all_gather`` of the totals)
Einsum                 per slot with the operands laid out by the first sharded
                       operand's labels; a sharded contraction label adds one
                       ``psum``; an operand the rule needs whole, one ``all_gather``
Rechunk                put under ``plan_layout(shape, chunks, mesh,
                       allow_uneven=True)`` (the explicit relayout schedule where
                       the input is under the old grid's layout), handed on sharded
Shuffle                gathered, permuted, put back under the new grid's layout
MultiStat(+Part)       row shards, the multi-statistic kernel once a slot, the
                       column sums and shifted sums combined by one ``psum``
Histogram, Bincount    the histogram kernel once a slot, the counts combined by one
                       ``psum`` (``bincount``'s length: one pmin, one pmax, one sync)
BandStencil,           the input's own layout where each sharded part is as deep as
ShardStencil           the halo (else resharded to the stencil's), the ShardStencil
                       body, handed on sharded
ChunksFreeze           the value handed on under the frozen chunks
=====================  ===========================================================

``PARTITIONED`` records, by node type, the nodes walked per slot
(``slots``), bound sharded (``bound``), handed on sharded by their own
``_build`` (``passed``), built dense from a gathered operand
(``gathered``), the contiguous copies a rule made for a kernel
(``contiguous``) and the empty parts a kernel was not launched on
(``skipped``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dask_array_tpu_torch._chunks import is_narrow, torch_dtype
from dask_array_tpu_torch._executor import BlockView, BuildContext
from dask_array_tpu_torch._expr import ArrayExpr
from dask_array_tpu_torch.parallel._sharded import (
    ShardedTensor,
    ShardedView,
    as_sharded,
    entry_names,
    part_index,
    shard,
    slot_coords,
)

KINDS = ("slots", "bound", "passed", "gathered", "contiguous", "skipped")


class PartitionRecord(dict):
    """``{kind: {node type: count}}`` over ``KINDS``."""

    def __init__(self):
        super().__init__({k: {} for k in KINDS})

    def add(self, kind, node_type, n=1):
        self[kind][node_type] = self[kind].get(node_type, 0) + n

    def reset(self):
        for k in KINDS:
            self[k].clear()

    def snapshot(self) -> dict:
        return {k: dict(v) for k, v in self.items()}

    def delta(self, before: dict) -> dict:
        """The counts that moved since ``before`` (a ``snapshot()``), by kind."""
        out = {}
        for k in KINDS:
            d = {t: n - before.get(k, {}).get(t, 0) for t, n in self[k].items() if n != before.get(k, {}).get(t, 0)}
            if d:
                out[k] = d
        return out


PARTITIONED = PartitionRecord()


# -- the walk -------------------------------------------------------------------------


def build(expr: ArrayExpr, ctx) -> BlockView:
    """``expr``'s value in a walk under ``ctx.mesh``: its rule where it has
    one and an operand is sharded, its leaf binding, or its dense
    ``_build`` (gathering a sharded operand once)."""
    name = type(expr).__name__
    if _is_leaf(expr):
        view = expr._build(ctx)
        bound = _bind_leaf(expr, view, ctx.mesh)
        if bound is not None:
            PARTITIONED.add("bound", name)
            return bound
        return view
    rule = RULES.get(name)
    if rule is not None and (getattr(rule, "takes_narrow", False) or not _narrow(expr)):
        view = rule(expr, ctx)
        if view is not None:
            # (a stencil deeper than its shards ran whole; a shuffle gathers)
            held = isinstance(view, (ShardedView, StatsView)) and name != "Shuffle"
            PARTITIONED.add("slots" if held else "gathered", name)
            return view
    view = expr._build(ctx)
    if isinstance(view, ShardedView):
        PARTITIONED.add("passed", name)
    elif any(isinstance(v, ShardedView) and v.gathered for v in (ctx.cache.get(d._name) for d in expr.dependencies())):
        PARTITIONED.add("gathered", name)
    return view


def _narrow(expr) -> bool:
    """Whether ``expr`` has a narrow operand or result (``_chunks.is_narrow``)."""
    return any(is_narrow(node.dtype) for node in (expr, *expr.dependencies()))


def _takes_narrow(rule):
    """Mark a rule that takes narrow data: it moves a carrier's patterns,
    or runs the node's own build once a slot and combines exact counts.
    Any other rule leaves a narrow node to its dense build (which decodes
    it, gathering a sharded operand once)."""
    rule.takes_narrow = True
    return rule


def _is_leaf(expr) -> bool:
    return not expr.dependencies() or getattr(expr, "_leaf_stop", False)


def leaf_spec(shape, mesh) -> tuple:
    """The layout a leaf is bound under: the JAX package's ``make_compute_fn``
    constraint."""
    from dask_array_tpu_torch.parallel.layout import plan_layout

    return plan_layout(tuple(shape), None, mesh, allow_uneven=True)


def _known(shape) -> bool:
    return all(isinstance(s, (int, np.integer)) for s in shape)


def _bind_leaf(expr, view, mesh):
    """A leaf's value sharded, or None where it stays dense: a host block
    (masked, duck, record, object), datetime ticks, a 0-d value, unknown
    chunks, or a shape no mesh axis fits."""
    dense = view._dense if view._blocks is None else None
    if isinstance(dense, ShardedTensor):
        return ShardedView(view.chunks, dense)  # a leaf persisted under this mesh
    if expr.dtype.kind not in "biufc" or not _known(expr.shape) or len(expr.shape) == 0:
        return None
    if dense is None:
        dense = view.dense()
    if not isinstance(dense, torch.Tensor) or tuple(dense.shape) != tuple(expr.shape):
        return None
    spec = leaf_spec(dense.shape, mesh)
    if all(e is None for e in spec):
        return None
    return ShardedView(view.chunks, shard(dense, mesh, spec), dense=dense)


# -- helpers --------------------------------------------------------------------------


def sharded_of(view):
    return view.sharded if isinstance(view, ShardedView) else None


def slot_values(view, mesh, spec, bounds=None) -> list:
    """One tensor a slot of an operand under ``(spec, bounds)``: a sharded
    value passes or reshards, a dense one is cut (``as_sharded``)."""
    st = sharded_of(view)
    return as_sharded(view.dense() if st is None else st, mesh, spec, bounds).shards


def _host_or_dense_block(view) -> bool:
    from dask_array_tpu_torch._host import is_host_block

    return not isinstance(view, ShardedView) and is_host_block(view.dense())


def run_slots(expr, operands: dict, mesh, skip_empty=None) -> list:
    """``expr._build`` once a slot, each in a context seeded with the slot's
    operand tensors (``{operand name: [one tensor a slot]}``).  Where
    ``skip_empty`` names an operand, a slot whose tensor of it is empty
    runs nothing (None; its kernel is not launched), counted in
    ``skipped``."""
    outs = []
    for s, dev in enumerate(mesh.slots):
        if skip_empty is not None and operands[skip_empty][s].numel() == 0:
            outs.append(None)
            PARTITIONED.add("skipped", type(expr).__name__)
            continue
        sctx = BuildContext({}, dev)
        for name, vals in operands.items():
            sctx.cache[name] = BlockView((), dense=vals[s])
        outs.append(expr._build(sctx).dense())
    return outs


def _names(entries) -> tuple:
    out = []
    for e in entries:
        out.extend(entry_names(e))
    return tuple(out)


def _view(expr, st):
    return ShardedView(expr.chunks, st)


# -- elementwise ----------------------------------------------------------------------


def _operand_layout(op_shape, out_shape, spec, bounds):
    """An operand's layout under an output layout: the output's entries on
    its axes, None where it broadcasts (size 1)."""
    off = len(out_shape) - len(op_shape)
    ospec, obounds = [], []
    for i, dim in enumerate(op_shape):
        j = i + off
        if dim == out_shape[j]:
            ospec.append(spec[j])
            obounds.append(bounds[j] if bounds is not None else None)
        else:
            ospec.append(None)
            obounds.append(None)
    return tuple(ospec), tuple(obounds)


def _elemwise(expr, ctx):
    arrays = [a for a in expr.args if isinstance(a, ArrayExpr)]
    if not _known(expr.shape) or expr.dtype.kind in "MmOSUV" or any(a.dtype.kind in "MmOSUV" for a in arrays):
        return None
    views = {a._name: ctx.build(a) for a in arrays}
    if any(_host_or_dense_block(v) for v in views.values()):
        return None
    out_shape = tuple(int(s) for s in expr.shape)
    ref = next((v.sharded for v in views.values() if isinstance(v, ShardedView)
                and v.sharded.global_shape == out_shape), None)
    if ref is None:
        return None
    mesh = ctx.mesh
    operands = {}
    for a in arrays:
        spec, bounds = _operand_layout(tuple(int(s) for s in a.shape), out_shape, ref.spec, ref.bounds)
        operands[a._name] = slot_values(views[a._name], mesh, spec, bounds)
    outs = run_slots(expr, operands, mesh)
    return _view(expr, ShardedTensor(mesh, ref.spec, outs, out_shape, ref.bounds))


def _blockwise(expr, ctx):
    """``map_blocks``/``blockwise`` per slot, where each sharded output label
    splits at block boundaries (every slot holds a whole run of blocks): the
    slot calls the function on its blocks with their global coordinates.
    A label the first sharded operand shards is sharded alike on every
    operand that carries it unbroadcast; other labels stay whole."""
    from dask_array_tpu_torch._blockwise import _store
    from dask_array_tpu_torch._chunks import cached_cumsum, has_unknown_chunks
    from dask_array_tpu_torch._executor import _assemble, iter_block_indices

    if not _known(expr.shape) or has_unknown_chunks(expr.chunks) or expr.dtype.kind in "MmOSUV":
        return None
    pairs = expr.array_args
    views = {a._name: ctx.build(a) for a, _ in pairs}
    first = next((i for i, (a, _) in enumerate(pairs) if isinstance(views[a._name], ShardedView)), None)
    if first is None or any(_host_or_dense_block(v) for v in views.values()):
        return None
    skip = set(dict(expr.new_axes or ())) | set(dict(expr.adjust_chunks or ()))
    a0, ind0 = pairs[first]
    st = views[a0._name].sharded
    out_chunks = dict(zip(expr.out_ind, expr.chunks))
    assign = {}
    for pos, lab in enumerate(ind0):
        if st.spec[pos] is None:
            continue
        offs = st.axis_bounds(pos)
        if lab in skip or lab not in out_chunks or not set(offs) <= set(cached_cumsum(out_chunks[lab], True)):
            return None
        assign[lab] = (st.spec[pos], offs)
    mesh = ctx.mesh
    local_views = []
    slot_vals = {}
    for a, ind in pairs:
        sharded = [lab in assign and tuple(a.chunks[pos]) == tuple(out_chunks[lab]) for pos, lab in enumerate(ind)]
        spec = tuple(assign[lab][0] if sh else None for lab, sh in zip(ind, sharded))
        bounds = tuple(assign[lab][1] if sh else None for lab, sh in zip(ind, sharded))
        slot_vals[a._name] = slot_values(views[a._name], mesh, spec, bounds)
        local_views.append((a, ind, sharded))

    def run(lab, chunks, region):
        # the blocks of ``chunks`` inside the slot's part of label ``lab``
        offs = cached_cumsum(chunks, True)
        a, b = region[lab]
        i0, i1 = int(np.searchsorted(offs, a)), int(np.searchsorted(offs, b))
        return i0, tuple(chunks[i0:i1])

    kwargs = expr._kwargs_dict
    out_spec = tuple(assign[lab][0] if lab in assign else None for lab in expr.out_ind)
    out_bounds = tuple(assign[lab][1] if lab in assign else None for lab in expr.out_ind)
    outs = []
    for s, dev in enumerate(mesh.slots):
        coords = slot_coords(mesh, s)
        region = {}
        for lab, (entry, offs) in assign.items():
            p = part_index(mesh, coords, entry)[0]
            region[lab] = (offs[p], offs[p + 1])
        local = {}
        for a, ind, sharded in local_views:
            chunks = tuple(run(lab, a.chunks[pos], region)[1] if sh else tuple(a.chunks[pos])
                           for pos, (lab, sh) in enumerate(zip(ind, sharded)))
            local[a._name] = BlockView(chunks, dense=slot_vals[a._name][s])
        starts, nb, shape = [], [], []
        for lab in expr.out_ind:
            if lab in assign:
                i0, ch = run(lab, out_chunks[lab], region)
            else:
                i0, ch = 0, tuple(out_chunks[lab])
            starts.append(i0)
            nb.append(len(ch))
            shape.append(int(sum(ch)))
        if 0 in nb:
            outs.append(torch.empty(shape, dtype=torch_dtype(expr.dtype), device=dev))
            continue
        blocks = {}
        for lc in iter_block_indices(tuple(nb)):
            coord_of = {lab: lc[i] for i, lab in enumerate(expr.out_ind) if lab not in dict(expr.new_axes or ())}
            args = [arg if ind is None or not isinstance(arg, ArrayExpr) else
                    expr._arg_block(local[arg._name], ind, coord_of) for arg, ind in expr.arg_pairs]
            glob = tuple(i + o for i, o in zip(lc, starts))
            blocks[tuple(lc)] = _store(expr._call(args, kwargs, glob, dev), expr.dtype)
        out = _assemble(blocks, tuple(nb))
        if not isinstance(out, torch.Tensor) or list(out.shape) != shape:
            return None  # the function changed its blocks' shapes (``ChunksOverride``): dense
        outs.append(out)
    return _view(expr, ShardedTensor(mesh, out_spec, outs, tuple(int(d) for d in expr.shape), out_bounds))


# -- layout ---------------------------------------------------------------------------


@_takes_narrow
def _transpose(expr, ctx):
    st = sharded_of(ctx.build(expr.array))
    if st is None:
        return None
    axes = tuple(expr.axes)
    outs = run_slots(expr, {expr.array._name: st.shards}, ctx.mesh)
    spec = tuple(st.spec[a] for a in axes)
    bounds = None if st.bounds is None else tuple(st.bounds[a] for a in axes)
    return _view(expr, ShardedTensor(ctx.mesh, spec, outs, tuple(st.global_shape[a] for a in axes), bounds))


@_takes_narrow
def _slice(expr, ctx):
    """A basic slice per slot.  On a sharded axis a slice keeps each part's
    selected elements (ascending steps only; a part may end up empty) and
    an integer is taken by the slot holding it, then every slot of its
    group gets it by one ``psum`` (the others add nothing)."""
    from numbers import Integral

    from dask_array_tpu_torch._slicing import getitem_tensor
    from dask_array_tpu_torch.parallel.collectives import all_reduce

    st = sharded_of(ctx.build(expr.array))
    index = tuple(expr.index)
    if st is None or len(index) != st.ndim or not all(isinstance(i, (Integral, slice)) for i in index):
        return None
    mesh = ctx.mesh
    out_spec, out_bounds, picked = [], [], []
    local = [[None] * st.ndim for _ in range(mesh.size)]
    holder = [True] * mesh.size
    for ax, ind in enumerate(index):
        dim = st.global_shape[ax]
        entry = st.spec[ax]
        offs = st.axis_bounds(ax)
        if entry is None:
            for s in range(mesh.size):
                local[s][ax] = ind
            if not isinstance(ind, Integral):
                out_spec.append(None)
                out_bounds.append(None)
            continue
        regions = [st.region(s)[ax] for s in range(mesh.size)]
        if isinstance(ind, Integral):
            i = int(ind) + (dim if ind < 0 else 0)
            for s, r in enumerate(regions):
                if r.start <= i < r.stop:
                    local[s][ax] = i - r.start
                else:
                    holder[s] = False
            picked.append(entry)
            continue
        start, stop, step = ind.indices(dim)
        if step < 0:
            return None
        counts = []
        for p in range(len(offs) - 1):
            a, b = offs[p], offs[p + 1]
            first = start + max(0, -(-(max(a, start) - start) // step)) * step
            counts.append(len(range(first, min(b, stop), step)) if first < min(b, stop) else 0)
        for s, r in enumerate(regions):
            first = start + max(0, -(-(max(r.start, start) - start) // step)) * step
            end = min(r.stop, stop)
            local[s][ax] = slice(first - r.start, end - r.start, step) if first < end else slice(0, 0, 1)
        out_spec.append(entry)
        out_bounds.append(tuple(int(v) for v in np.concatenate([[0], np.cumsum(counts)])))
    vals = [getitem_tensor(t, tuple(local[s])) if holder[s] else None for s, t in enumerate(st.shards)]
    if picked:
        vals = all_reduce("psum", vals, mesh, _names(picked))
    out_shape = tuple(int(s) for s in expr.shape)
    return _view(expr, ShardedTensor(mesh, tuple(out_spec), vals, out_shape, tuple(out_bounds)))


@_takes_narrow
def _freeze(expr, ctx):
    st = sharded_of(ctx.build(expr.array))
    return None if st is None else _view(expr, st)


@_takes_narrow
def _rechunk(expr, ctx):
    """The JAX package's sharding boundary: the value goes under
    ``plan_layout(shape, chunks, mesh, allow_uneven=True)``.  Where the
    input is under the old grid's layout, the explicit relayout schedule
    (``mesh_collective_relayout``) moves it; otherwise one reshard.  Under
    ``array.rechunk.method: tasks`` the value passes as it is."""
    from dask_array_tpu_torch import config
    from dask_array_tpu_torch._chunks import has_unknown_chunks
    from dask_array_tpu_torch.parallel.collectives import mesh_collective_relayout
    from dask_array_tpu_torch.parallel.layout import plan_layout

    old, new = expr.array.chunks, expr.target_chunks
    if has_unknown_chunks(old) or has_unknown_chunks(new):
        return None
    view = ctx.build(expr.array)
    mesh = ctx.mesh
    shape = tuple(int(sum(c)) for c in old)
    target = plan_layout(shape, new, mesh, allow_uneven=True)
    st = sharded_of(view)
    if st is None:
        dense = view.dense()
        if not isinstance(dense, torch.Tensor) or all(e is None for e in target):
            return None
        return ShardedView(expr.chunks, shard(dense, mesh, target), dense=dense)
    if config.get("array.rechunk.method", "auto") == "tasks" or st.same_layout(target):
        return _view(expr, st)
    if st.same_layout(plan_layout(shape, old, mesh)):
        out = mesh_collective_relayout(st, old, new, mesh)
        if out is not None:
            st = out
    return _view(expr, as_sharded(st, mesh, target))


@_takes_narrow
def _shuffle(expr, ctx):
    """Gather, permute and put back under the new grid's layout (the JAX
    package's boundary): recorded as ``gathered``."""
    from dask_array_tpu_torch.parallel.layout import plan_layout

    if sharded_of(ctx.build(expr.array)) is None or not _known(expr.shape):
        return None
    dense = expr._build(ctx).dense()
    spec = plan_layout(tuple(dense.shape), expr.chunks, ctx.mesh, allow_uneven=True)
    return ShardedView(expr.chunks, shard(dense, ctx.mesh, spec), dense=dense)


# -- reductions -----------------------------------------------------------------------


def _kept_layout(st, axes, keepdims):
    spec, bounds = [], []
    for ax in range(st.ndim):
        if ax in axes:
            if keepdims:
                spec.append(None)
                bounds.append(None)
            continue
        spec.append(st.spec[ax])
        bounds.append(st.bounds[ax] if st.bounds is not None else None)
    return tuple(spec), tuple(bounds)


def _reduction(expr, ctx):
    """Per slot over unsharded axes; over a sharded axis a partial a slot
    combined by ONE collective over the mesh axes of the reduced axes (the
    shard lane's typed combine), so the kept axes stay sharded."""
    from dask_array_tpu_torch._chunks import cast, to_compute
    from dask_array_tpu_torch.ops.reductions import reduce_dense
    from dask_array_tpu_torch.parallel.collectives import all_reduce
    from dask_array_tpu_torch.parallel.shardlane import _COLLECTIVE, _COMBINE_KIND, _combiner, _identity

    st = sharded_of(ctx.build(expr.array))
    if st is None:
        return None
    mesh = ctx.mesh
    axes = tuple(expr.axes)
    spec, bounds = _kept_layout(st, axes, expr.keepdims)
    out_shape = tuple(int(s) for s in expr.shape)
    names = _names(st.spec[ax] for ax in axes)
    if not names:
        outs = run_slots(expr, {expr.array._name: st.shards}, mesh)
        return _view(expr, ShardedTensor(mesh, spec, outs, out_shape, bounds))
    kind, dtype = expr.kind, np.dtype(expr.dtype)
    if kind not in _COMBINE_KIND or kind in ("prod", "nanprod") or 0 in st.global_shape:
        return None  # (a cross-slot prod keeps the shard lane's decline)
    if _COMBINE_KIND[kind] == "sum" and dtype.itemsize <= 2 and dtype.kind == "f":
        return None  # a 2-byte sum is rounded once in the dense walk, not once a part
    part_kind = {"mean": "sum", "nanmean": "nansum"}.get(kind, kind)
    parts = []
    for t in st.shards:
        if t.numel() == 0:
            shape = tuple(d for ax, d in enumerate(t.shape) if ax not in axes)
            parts.append(_identity(kind, shape, dtype, t.device))
        else:
            parts.append(reduce_dense(part_kind, t, axes, False, dtype))
    combine = _combiner(kind, dtype)
    tot = all_reduce(_COLLECTIVE[_COMBINE_KIND[kind]], parts, mesh, names, combine=combine)
    if kind == "mean":
        count = math.prod(st.global_shape[ax] for ax in axes)
        tot = [cast(to_compute(t, dtype) / count, dtype) for t in tot]
    elif kind == "nanmean":
        counts = [(~torch.isnan(t)).sum(dim=axes) if t.is_floating_point() or t.is_complex()
                  else torch.full(p.shape, math.prod(t.shape[ax] for ax in axes), dtype=torch.int64, device=t.device)
                  for t, p in zip(st.shards, parts)]
        cnt = all_reduce("psum", counts, mesh, names)
        tot = [cast(to_compute(t, dtype) / c.to(to_compute(t, dtype).dtype), dtype) for t, c in zip(tot, cnt)]
    if expr.keepdims:
        tot = [t.reshape(tuple(1 if ax in axes else d for ax, d in enumerate(s.shape))) for t, s in zip(tot, st.shards)]
    return _view(expr, ShardedTensor(mesh, spec, tot, out_shape, bounds))


def walk_lane(st: ShardedTensor):
    """The shard lane's ``_Lane`` over a sharded value: one piece for each
    distinct non-empty part (its first slot), indexed by its part along the
    sharded axes; the lane's collectives then run over every mesh axis, and
    the slots holding no piece sit them out."""
    from dask_array_tpu_torch.parallel.shardlane import _Lane, _Piece

    mesh = st.mesh
    dims = tuple(ax for ax, e in enumerate(st.spec) if e is not None)
    pieces, seen = [], set()
    for s in range(mesh.size):
        region = st.region(s)
        if region in seen or any(r.stop <= r.start for r in region):
            continue
        seen.add(region)
        c = slot_coords(mesh, s)
        idx = tuple(part_index(mesh, c, st.spec[ax])[0] for ax in dims)
        pieces.append(_Piece(s, mesh.slots[s], idx, tuple((r.start, r.stop) for r in region)))
    grid = tuple((d,) for d in st.global_shape)
    numblocks = tuple(len(st.axis_bounds(ax)) - 1 for ax in dims)
    return _Lane(mesh, grid, dims, pieces, numblocks)


def _holders(st, lane, values):
    """Per-slot values from per-piece ones: each slot takes its part's."""
    by_region = {p.region: v for p, v in zip(lane.pieces, values)}
    out = []
    for s, dev in enumerate(st.mesh.slots):
        key = tuple((r.start, r.stop) for r in st.region(s))
        v = by_region.get(key)
        out.append(None if v is None else v.to(dev, non_blocking=True))
    return out


def _cumreduction(expr, ctx):
    from dask_array_tpu_torch.parallel.shardlane import _lane_scan

    st = sharded_of(ctx.build(expr.array))
    if st is None:
        return None
    mesh = ctx.mesh
    if st.spec[expr.axis] is None:
        outs = run_slots(expr, {expr.array._name: st.shards}, mesh)
        return _view(expr, ShardedTensor(mesh, st.spec, outs, st.global_shape, st.bounds))
    if np.dtype(expr.dtype).itemsize <= 2 and np.dtype(expr.dtype).kind == "f":
        return None  # a step-rounded scan (K3): gathered, then K3 runs once on the dense block
    lane = walk_lane(st)
    if not lane.pieces:
        return None
    for p in lane.pieces:
        p.seed(expr.array._name, st.shards[p.slot])
    outs = _holders(st, lane, _lane_scan(lane, expr, expr.axis))
    empty = run_slots(expr, {expr.array._name: st.shards}, mesh) if any(o is None for o in outs) else None
    outs = [o if o is not None else empty[s] for s, o in enumerate(outs)]
    return _view(expr, ShardedTensor(mesh, st.spec, outs, st.global_shape, st.bounds))


def _argreduction(expr, ctx):
    from dask_array_tpu_torch.parallel.shardlane import _lane_arg

    st = sharded_of(ctx.build(expr.array))
    if st is None:
        return None
    mesh = ctx.mesh
    axis = expr.axis
    out_shape = tuple(int(s) for s in expr.shape)
    if axis is not None and st.spec[axis] is None:
        spec, bounds = _kept_layout(st, (axis,), expr.keepdims)
        outs = run_slots(expr, {expr.array._name: st.shards}, mesh)
        return _view(expr, ShardedTensor(mesh, spec, outs, out_shape, bounds))
    if expr.kind not in ("argmin", "argmax") or 0 in st.global_shape or expr.array.dtype.kind not in "biuf":
        return None
    lane = walk_lane(st)
    res = _lane_arg(lane, expr.kind, [st.shards[p.slot] for p in lane.pieces], axis)
    outs = [r.reshape(out_shape).to(torch_dtype(np.intp)) for r in res]
    return _view(expr, ShardedTensor(mesh, (None,) * len(out_shape), outs, out_shape))


# -- contraction ----------------------------------------------------------------------


def _einsum(expr, ctx):
    """Each operand laid out by the labels the first sharded operand shards
    (a label it shards is sharded alike on every operand that has it,
    other labels whole); each slot contracts its parts; a sharded
    contraction label adds ONE ``psum`` over its mesh axes."""
    from dask_array_tpu_torch.parallel.collectives import all_reduce
    from dask_array_tpu_torch.parallel.shardlane import _combiner

    arrays, labels, out = expr.arrays, expr.input_labels, expr.out_labels
    if not _known(expr.shape) or any(not _known(a.shape) for a in arrays):
        return None
    if any(len(set(lab)) != len(lab) for lab in labels) or len(set(out)) != len(out):
        return None  # a diagonal
    views = [ctx.build(a) for a in arrays]
    first = next((i for i, v in enumerate(views) if isinstance(v, ShardedView)), None)
    if first is None or any(_host_or_dense_block(v) for v in views):
        return None
    st = views[first].sharded
    assign = {}
    for pos, lab in enumerate(labels[first]):
        if st.spec[pos] is not None:
            assign[lab] = (st.spec[pos], st.axis_bounds(pos))
    for lab in assign:
        dims = {int(a.shape[labs.index(lab)]) for a, labs in zip(arrays, labels) if lab in labs}
        if len(dims) != 1:
            return None  # a broadcast label
    mesh = ctx.mesh
    slot_vals = []
    for v, labs in zip(views, labels):
        spec = tuple(assign[lab][0] if lab in assign else None for lab in labs)
        bounds = tuple(assign[lab][1] if lab in assign else None for lab in labs)
        slot_vals.append(slot_values(v, mesh, spec, bounds))
    prods = [expr.contract([vals[s] for vals in slot_vals]) for s in range(mesh.size)]
    contracted = [lab for lab in assign if lab not in out]
    if contracted:
        prods = all_reduce("psum", prods, mesh, _names(assign[lab][0] for lab in contracted),
                           combine=_combiner("sum", expr.dtype))
    spec = tuple(assign[lab][0] if lab in assign else None for lab in out)
    bounds = tuple(assign[lab][1] if lab in assign else None for lab in out)
    return _view(expr, ShardedTensor(mesh, spec, prods, tuple(int(s) for s in expr.shape), bounds))


# -- the multi-statistic kernel (P4) -------------------------------------------------


class StatsView(BlockView):
    """A ``MultiStat`` node's value in the partitioned walk: per slot the
    column sums, shifted sum and sum of squares (combined over the row
    parts) and the slot's own row means.  ``MultiStatPart`` reads it by
    its rule; ``dense()`` packs it as ``MultiStat._build`` does (gathering
    the row means)."""

    __slots__ = ("mesh", "rows", "colsum", "rowmean", "s", "ss", "shape")

    def __init__(self, chunks, rows, colsum, rowmean, s, ss, shape):
        self.chunks = chunks
        self._blocks = None
        self._dense = None
        self.rows, self.colsum, self.rowmean, self.s, self.ss, self.shape = rows, colsum, rowmean, s, ss, shape
        self.mesh = rows.mesh

    def part(self, name) -> ShardedTensor:
        mesh = self.mesh
        m, n = self.shape
        if name == "colsum":
            return ShardedTensor(mesh, (None,), self.colsum, (n,))
        if name == "rowmean":
            return ShardedTensor(mesh, (self.rows.spec[0],), self.rowmean, (m,), (self.rows.axis_bounds(0),))
        return ShardedTensor(mesh, (), self.s if name == "s" else self.ss, ())

    def dense(self):
        if self._dense is None:
            m, n = self.shape
            s, ss = self.s[0], self.ss[0]
            count = torch.tensor(m, dtype=s.dtype, device=s.device) * n
            std = torch.sqrt(ss / count - (s / count) ** 2)
            rowmean = self.part("rowmean").gather()
            self._dense = torch.cat([self.colsum[0], rowmean, torch.stack([std, s, ss])])
        return self._dense

    def block(self, index):
        return self.dense()


def _multistat(expr, ctx):
    """Row parts: the kernel once a slot, then ONE ``psum`` of
    ``[column sums | s | ss]`` over the row axes' mesh axes; the row means
    stay per slot.  A column-sharded input is resharded to row parts first
    (every mesh axis that shards it, on the rows)."""
    from dask_array_tpu_torch.parallel.collectives import all_reduce

    st = sharded_of(ctx.build(expr.array))
    if st is None or st.ndim != 2:
        return None
    mesh = ctx.mesh
    if st.spec[1] is not None:
        names = _names(st.spec)
        st = as_sharded(st, mesh, (names if len(names) > 1 else names[0], None))
    rows = []
    for t in st.shards:
        if t.numel() and not t.is_contiguous():
            t = t.contiguous()
            PARTITIONED.add("contiguous", "MultiStat")
        rows.append(t)
    operands = {expr.array._name: rows}
    if expr.shift is not None:
        operands[expr.shift._name] = slot_values(ctx.build(expr.shift), mesh, ())
    packed = run_slots(expr, operands, mesh, skip_empty=expr.array._name)
    m, n = st.global_shape
    sums = []
    for s, (t, p) in enumerate(zip(rows, packed)):
        if p is None:
            sums.append(torch.zeros(n + 2, dtype=torch.float32, device=mesh.slots[s]))
        else:
            mm = t.shape[0]
            sums.append(torch.cat([p[:n], p[n + mm + 1:n + mm + 3]]))
    tot = all_reduce("psum", sums, mesh, _names((st.spec[0],)))
    rowmean = [p[n:n + t.shape[0]] if p is not None else torch.zeros(0, dtype=torch.float32, device=t.device)
               for t, p in zip(rows, packed)]
    return StatsView(expr.chunks, st, [t[:n] for t in tot], rowmean, [t[n] for t in tot], [t[n + 1] for t in tot],
                     (m, n))


def _multistat_part(expr, ctx):
    view = ctx.build(expr.stats)
    if not isinstance(view, StatsView):
        return None
    return _view(expr, view.part(expr.part))


# -- the histogram kernel (K2) -------------------------------------------------------


@_takes_narrow
def _histogram(expr, ctx):
    """The counts once a slot (the kernel on the slot's part), ONE ``psum``
    over the mesh axes that shard the data, then numpy's density on the
    totals.  The edges are built once for the walk."""
    from dask_array_tpu_torch.parallel.collectives import all_reduce

    st = sharded_of(ctx.build(expr.array))
    if st is None:
        return None
    mesh = ctx.mesh
    edges = expr.edges(ctx)
    weights = None
    if expr.weights is not None:
        weights = slot_values(ctx.build(expr.weights), mesh, st.spec, st.bounds)
    counts = []
    for s, t in enumerate(st.shards):
        if t.numel() == 0:
            counts.append(None)
            PARTITIONED.add("skipped", "Histogram")
            continue
        if not t.is_contiguous():
            PARTITIONED.add("contiguous", "Histogram")  # the kernel's wrapper lays it out
        e = edges.to(t.device, non_blocking=True)
        counts.append(expr.counts(t, e, None if weights is None else weights[s]))
    like = next((c for c in counts if c is not None), None)
    if like is None:
        return None
    counts = [torch.zeros_like(like, device=dev) if c is None else c for c, dev in zip(counts, mesh.slots)]
    tot = all_reduce("psum", counts, mesh, _names(st.spec))
    outs = [expr.finish(c, edges.to(c.device, non_blocking=True)) for c in tot]
    return _view(expr, ShardedTensor(mesh, (None,), outs, (expr.nbins,)))


def _bincount(expr, ctx):
    """The length from one pmin and one pmax of the slots' extremes and one
    sync, the counts once a slot, ONE ``psum``."""
    from dask_array_tpu_torch._chunks import computable, compute_dtype, to_compute
    from dask_array_tpu_torch.kernels.histogram import bincount_counts
    from dask_array_tpu_torch.ops._fancy_indexing import count_sync
    from dask_array_tpu_torch.parallel.collectives import all_reduce

    st = sharded_of(ctx.build(expr.array))
    if st is None or st.ndim != 1 or st.global_shape[0] == 0:
        return None
    mesh = ctx.mesh
    names = _names(st.spec)
    xs = [computable(t).to(torch.int64) for t in st.shards]
    big = torch.iinfo(torch.int64)
    lo = [t.amin() if t.numel() else torch.tensor(big.max, device=t.device) for t in xs]
    hi = [t.amax() if t.numel() else torch.tensor(big.min, device=t.device) for t in xs]
    lo = all_reduce("pmin", lo, mesh, names)[0]
    hi = all_reduce("pmax", hi, mesh, names)[0]
    lo, hi = torch.stack([lo, hi]).tolist()
    count_sync()
    if lo < 0:
        raise ValueError("'list' argument must have no negative elements")
    length = max(hi + 1, expr.minlength)
    weights = None
    if expr.weights is not None:
        weights = [to_compute(w, np.float64) for w in slot_values(ctx.build(expr.weights), mesh, st.spec, st.bounds)]
    counts = []
    for s, t in enumerate(xs):
        if t.numel() == 0:
            PARTITIONED.add("skipped", "Bincount")
            dt = torch.int64 if weights is None else torch.float64
            counts.append(torch.zeros(length, dtype=dt, device=t.device))
            continue
        counts.append(bincount_counts(t, length, None if weights is None else weights[s]))
    tot = all_reduce("psum", counts, mesh, names)
    return _view(expr, ShardedTensor(mesh, (None,), [t.to(compute_dtype(expr.dtype)) for t in tot], (length,)))


# -- stencils -------------------------------------------------------------------------


def stencil_input(expr, ctx, spec):
    """A stencil's input as a ``ShardedTensor`` it can run on, or None
    (its dense path): the input's own layout where every sharded axis with
    depth has parts at least as deep as the halo, else the stencil's layout
    ``spec`` (resharded) where it has one."""
    st = sharded_of(ctx.build(expr.array))
    if st is None:
        return None
    ok = any(e is not None for e in st.spec)
    for ax, (lo, hi) in enumerate(expr.depth):
        if st.spec[ax] is None or not (lo or hi):
            continue
        offs = st.axis_bounds(ax)
        if min(b - a for a, b in zip(offs, offs[1:])) < max(lo, hi, 1):
            ok = False
    if ok:
        return st
    return None if spec is None else as_sharded(st, st.mesh, spec)


def _stencil(expr, ctx):
    """``BandStencil``/``ShardStencil`` on a sharded input: their own
    ``_build`` takes it as it is (``ops/_overlap._mesh_input``)."""
    if sharded_of(ctx.build(expr.array)) is None:
        return None
    return expr._build(ctx)


RULES = {
    "Blockwise": _blockwise,
    "MapBlocks": _blockwise,
    "_MapBlocksWithId": _blockwise,
    "MapBlocksInfo": _blockwise,
    "BandStencil": _stencil,
    "ShardStencil": _stencil,
    "Elemwise": _elemwise,
    "Transpose": _transpose,
    "Slice": _slice,
    "ChunksFreeze": _freeze,
    "Rechunk": _rechunk,
    "Shuffle": _shuffle,
    "Reduction": _reduction,
    "CumReduction": _cumreduction,
    "ArgReduction": _argreduction,
    "Einsum": _einsum,
    "MultiStat": _multistat,
    "MultiStatPart": _multistat_part,
    "Histogram": _histogram,
    "Bincount": _bincount,
}
