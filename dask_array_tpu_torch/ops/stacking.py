"""Concatenate / stack / block.

Port of ``dask_array_tpu/ops/stacking.py`` without its host lanes, the
``FromMap`` merge and the shuffle hook.  The executor concatenates the
parts' dense tensors once with ``torch.cat``, after casting each to the
result dtype, which follows numpy's promotion (``np.promote_types``), not
torch's.  At expression level a slice distributes onto the surviving parts
so their upstream work is culled, and a rechunk distributes onto the parts
where its boundaries land on their seams.
"""

from __future__ import annotations

import functools
import math
from numbers import Integral

import numpy as np
import torch

from dask_array_tpu_torch import _host
from dask_array_tpu_torch._chunks import cast, cat, common_blockdim, has_unknown_chunks, validate_axis
from dask_array_tpu_torch._executor import BlockView
from dask_array_tpu_torch._expr import ArrayExpr
from dask_array_tpu_torch._slicing import Slice, is_basic_index, normalize_slice


class Concatenate(ArrayExpr):
    takes_narrow = True

    _parameters = ("axis",)
    # operands[1:] are the input expressions

    @property
    def arrays(self):
        return self.operands[1:]

    @functools.cached_property
    def chunks(self):
        axis = self.axis
        first = self.arrays[0]
        out = []
        for ax in range(first.ndim):
            if ax == axis:
                out.append(tuple(c for a in self.arrays for c in a.chunks[ax]))
            else:
                cands = [a.chunks[ax] for a in self.arrays]
                out.append(cands[0] if all(c == cands[0] for c in cands) else common_blockdim(cands))
        return tuple(out)

    @functools.cached_property
    def _meta(self):
        dtype = functools.reduce(np.promote_types, [a.dtype for a in self.arrays])
        return np.empty((0,) * self.arrays[0].ndim, dtype=dtype)

    def _accept_rechunk(self, target_chunks):
        """Distribute a rechunk onto the inputs: non-concat axes apply to
        every input; the concat axis only when the target boundaries land
        on every input seam (a crossing chunk needs the seam-spanning
        relayout, so the Rechunk stays above and owns it)."""
        from dask_array_tpu_torch._rechunk import Rechunk

        axis = self.axis
        if has_unknown_chunks(self.chunks) or any(
            isinstance(c, float) and math.isnan(c) for t in target_chunks for c in t
        ):
            return None
        tgt_axis = list(target_chunks[axis])
        per_input = []
        pos = 0
        for a in self.arrays:
            span = sum(a.chunks[axis])
            if span == 0:
                return None  # a zero-span input would get an empty profile
            grp = []
            left = span
            while left > 0:
                if pos >= len(tgt_axis) or tgt_axis[pos] > left:
                    return None  # target chunk crosses an input seam
                grp.append(tgt_axis[pos])
                left -= tgt_axis[pos]
                pos += 1
            per_input.append(tuple(grp))
        if pos != len(tgt_axis):
            return None  # trailing zero-width target chunks: decline
        new_inputs = []
        for a, grp in zip(self.arrays, per_input):
            tgt = tuple(grp if ax == axis else target_chunks[ax] for ax in range(a.ndim))
            new_inputs.append(a if tgt == a.chunks else Rechunk(a, tgt))
        return Concatenate(self.axis, *new_inputs)

    def _simplify_down(self):
        if len(self.arrays) == 1:
            return self.arrays[0]
        # flatten nested concatenates along the same axis
        if any(type(a) is Concatenate and a.axis == self.axis for a in self.arrays):
            flat = []
            for a in self.arrays:
                if type(a) is Concatenate and a.axis == self.axis:
                    flat.extend(a.arrays)
                else:
                    flat.append(a)
            return Concatenate(self.axis, *flat)
        return self._merge_from_map()

    def _merge_from_map(self):
        """concatenate(from_map, from_map, ...) -> one FromMap: N loader
        leaves become one plan node with N block args (the read-many-files
        pattern keeps an O(1) plan).  Declines where the function (by
        identity), kwargs, dtype or off-axis grids differ, or a leaf is
        pinned (a user's name, opaque payloads)."""
        from dask_array_tpu_torch.io._from_map import FromMap, fm_pinned

        arrs = self.arrays
        if not all(type(a) is FromMap for a in arrs) or any(fm_pinned(a) for a in arrs):
            return None
        f0 = arrs[0]
        axis = self.axis
        if not all(
            a.func is f0.func and a.kwargs == f0.kwargs and a.dtype == f0.dtype and a.ndim == f0.ndim
            for a in arrs[1:]
        ):
            return None
        if not all(a.chunks[ax] == f0.chunks[ax] for a in arrs[1:] for ax in range(f0.ndim) if ax != axis):
            return None
        from dask_array_tpu_torch._executor import iter_block_indices

        grids = [tuple(len(c) for c in a.chunks) for a in arrs]
        child_of = []  # merged axis-block -> (child, local axis-block)
        for ci, g in enumerate(grids):
            child_of.extend((ci, j) for j in range(g[axis]))
        merged_grid = list(grids[0])
        merged_grid[axis] = len(child_of)
        args = []
        for idx in iter_block_indices(tuple(merged_grid)):
            ci, local = child_of[idx[axis]]
            lidx = list(idx)
            lidx[axis] = local
            args.append(arrs[ci].args_per_block[int(np.ravel_multi_index(lidx, grids[ci]))])
        merged_chunks = tuple(
            tuple(c for a in arrs for c in a.chunks[ax]) if ax == axis else f0.chunks[ax]
            for ax in range(f0.ndim)
        )
        return FromMap(f0.func, tuple(args), merged_chunks, f0.operand("_dtype"), f0.kwargs)

    def _lower(self):
        from dask_array_tpu_torch._rechunk import Rechunk

        want = self.chunks
        axis = self.axis
        changed = False
        new = []
        for a in self.arrays:
            target = tuple(a.chunks[ax] if ax == axis else want[ax] for ax in range(a.ndim))
            if target != a.chunks and not has_unknown_chunks(a.chunks):
                a = Rechunk(a, target)
                changed = True
            new.append(a)
        if changed:
            return Concatenate(self.axis, *new)
        return None

    def _build(self, ctx):
        # flattened parts may differ in dtype: cast each to numpy's promoted
        # dtype first (torch.cat promotes by torch's rules)
        parts = [ctx.build(a).dense() for a in self.arrays]
        if _host.any_host_block(parts):
            # masked, duck and record parts concatenate on the host as
            # numpy does (a duck part dispatches, a masked one keeps its mask)
            return BlockView(self.chunks, dense=_host.concatenate(parts, self.axis))
        parts = [cast(p, self.dtype) for p in parts]
        return BlockView(self.chunks, dense=cat(parts, dim=self.axis))

    def _accept_slice(self, index):
        if not is_basic_index(index):
            return None
        axis = self.axis
        ind = index[axis] if axis < len(index) else slice(None)

        def part_index(axis_ind):
            out = list(index)
            out[axis] = axis_ind
            return tuple(out)

        sizes = [a.shape[axis] for a in self.arrays]
        if any(isinstance(s, float) and np.isnan(s) for s in sizes):
            return None
        bounds = np.cumsum([0] + sizes)
        if isinstance(ind, Integral):
            i = int(ind)
            part = int(np.searchsorted(bounds, i, side="right")) - 1
            return Slice(self.arrays[part], part_index(i - int(bounds[part])))
        if ind.step is not None and ind.step < 0:
            return None  # keep the outer slice (still correct, just unpushed)
        start, stop, step = ind.indices(int(bounds[-1]))
        pieces = []
        for p, a in enumerate(self.arrays):
            lo, hi = int(bounds[p]), int(bounds[p + 1])
            lo_eff = max(lo, start)
            hi_eff = min(hi, stop)
            if hi_eff <= lo_eff:
                continue
            k0 = -(-(lo_eff - start) // step)
            first = start + k0 * step
            if first >= hi_eff:
                continue
            inner = normalize_slice(slice(first - lo, hi_eff - lo, step), a.shape[axis])
            pieces.append(Slice(a, part_index(inner)))
        if not pieces:
            return Slice(self.arrays[0], part_index(slice(0, 0, 1)))
        if len(pieces) == 1:
            return pieces[0]
        # count surviving output axes before `axis` (ints drop axes)
        new_axis = sum(1 for pos in range(axis) if not isinstance(index[pos], Integral))
        return Concatenate(new_axis, *pieces)


def concatenate(seq, axis=0, allow_unknown_chunksizes=False, **kwargs):
    from dask_array_tpu_torch._collection import new_collection
    from dask_array_tpu_torch.ops._from_array import asarray

    seq = [asarray(a) for a in seq]
    if not seq:
        raise ValueError("Need array(s) to concatenate")
    if axis is None:
        from dask_array_tpu_torch.ops._reshape import ravel

        seq = [ravel(a) for a in seq]
        axis = 0
    ndim = seq[0].ndim
    axis = validate_axis(axis, ndim)
    for a in seq:
        if a.ndim != ndim:
            raise ValueError(f"Arrays must have same number of dimensions: got {[s.ndim for s in seq]}")
        for ax in range(ndim):
            if ax == axis:
                continue
            s0, s1 = seq[0].shape[ax], a.shape[ax]
            unknown = (isinstance(s0, float) and np.isnan(s0)) or (isinstance(s1, float) and np.isnan(s1))
            if not allow_unknown_chunksizes and unknown:
                raise ValueError(
                    f"Tried to concatenate arrays with unknown chunk sizes "
                    f"along non-concatenated axis {ax}: {[s.shape for s in seq]}. "
                    f"Pass allow_unknown_chunksizes=True (or call "
                    f"compute_chunk_sizes()) to proceed."
                )
            if not allow_unknown_chunksizes and not unknown and s0 != s1:
                raise ValueError(f"Shapes do not align along non-concatenated axis {ax}: {[s.shape for s in seq]}")
    if len(seq) == 1:
        return seq[0]
    return new_collection(Concatenate(axis, *[a.expr for a in seq]))


def stack(seq, axis=0, allow_unknown_chunksizes=False):
    from dask_array_tpu_torch.ops._from_array import asarray
    from dask_array_tpu_torch.ops.manipulation import expand_dims

    seq = [asarray(a) for a in seq]
    if not seq:
        raise ValueError("Need array(s) to stack")
    ndim = seq[0].ndim
    if not all(a.ndim == ndim for a in seq):
        raise ValueError("Stacked arrays must have the same number of dimensions")
    shapes = {a.shape for a in seq}
    if not allow_unknown_chunksizes and len(shapes) > 1:
        raise ValueError(f"Stacked arrays must have the same shape, got {shapes}")
    axis = validate_axis(axis, ndim + 1)
    parts = [expand_dims(a, axis) for a in seq]
    return concatenate(parts, axis=axis, allow_unknown_chunksizes=allow_unknown_chunksizes)


def vstack(tup, allow_unknown_chunksizes=False):
    from dask_array_tpu_torch.ops.manipulation import atleast_2d

    tup = tuple(atleast_2d(t) for t in tup)
    return concatenate(tup, axis=0, allow_unknown_chunksizes=allow_unknown_chunksizes)


def hstack(tup, allow_unknown_chunksizes=False):
    tup = tuple(tup)
    axis = 0 if all(t.ndim == 1 for t in tup) else 1
    return concatenate(tup, axis=axis, allow_unknown_chunksizes=allow_unknown_chunksizes)


def dstack(tup, allow_unknown_chunksizes=False):
    from dask_array_tpu_torch.ops.manipulation import atleast_3d

    tup = tuple(atleast_3d(t) for t in tup)
    return concatenate(tup, axis=2, allow_unknown_chunksizes=allow_unknown_chunksizes)


def block(arrays, allow_unknown_chunksizes=False):
    """Assemble an array from nested lists of blocks (numpy.block)."""
    from dask_array_tpu_torch.ops._from_array import asarray
    from dask_array_tpu_torch.ops.manipulation import expand_dims

    def max_depth(arrs):
        if isinstance(arrs, list):
            return 1 + max((max_depth(a) for a in arrs), default=0)
        return 0

    depth = max_depth(arrays)

    def lift(a, nd):
        while a.ndim < nd:
            a = expand_dims(a, 0)
        return a

    def assemble(arrs, level):
        if not isinstance(arrs, list):
            return lift(asarray(arrs), depth)
        parts = [assemble(a, level + 1) for a in arrs]
        nd = max(p.ndim for p in parts)
        parts = [lift(p, nd) for p in parts]
        return concatenate(parts, axis=nd - (depth - level), allow_unknown_chunksizes=allow_unknown_chunksizes)

    return assemble(arrays, 0)
