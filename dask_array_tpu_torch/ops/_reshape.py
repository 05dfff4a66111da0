"""Reshape with dask-compatible chunk planning.

Port of ``dask_array_tpu/ops/_reshape.py`` (``reshape_rechunk`` planning,
``Reshape`` -> pre-rechunk + ``ReshapeLowered``, ``reshape_blockwise``),
without its host lanes.  The executor reshapes the dense tensor in one
``torch.reshape``: a view when the layout allows it (a reshape of a
transposed array after the transpose kernel laid it out), else a copy.
The planning defines the output chunk grid the way dask does and inserts
the pre-rechunk that makes the block mapping exact, so per-block consumers
see the same blocks as in the JAX package.
"""

from __future__ import annotations

import functools
from numbers import Integral

import numpy as np

from dask_array_tpu_torch._chunks import has_unknown_chunks, normalize_chunks
from dask_array_tpu_torch._executor import BlockView, iter_block_indices
from dask_array_tpu_torch._expr import ArrayExpr


def reshape_rechunk(inshape, outshape, inchunks):
    """Plan: (input chunks to rechunk to, output chunks).

    Walks axes right-to-left matching dimension products; merged trailing
    axes must be single-chunk (we rechunk them so), split axes must divide
    by the trailing factor (we snap them so).
    """
    ileft = len(inshape) - 1
    oleft = len(outshape) - 1
    result_in = [None] * len(inshape)
    result_out = [None] * len(outshape)

    while ileft >= 0 or oleft >= 0:
        if ileft >= 0 and oleft >= 0 and inshape[ileft] == outshape[oleft]:
            result_in[ileft] = tuple(inchunks[ileft])
            result_out[oleft] = tuple(inchunks[ileft])
            ileft -= 1
            oleft -= 1
            continue
        if oleft >= 0 and outshape[oleft] == 1 and (ileft < 0 or inshape[ileft] != 1):
            result_out[oleft] = (1,)
            oleft -= 1
            continue
        if ileft >= 0 and inshape[ileft] == 1 and (oleft < 0 or outshape[oleft] != 1):
            result_in[ileft] = (1,)
            ileft -= 1
            continue
        if ileft >= 0 and oleft >= 0 and inshape[ileft] < outshape[oleft]:
            # merge several input axes into outshape[oleft]
            prod = 1
            i0 = ileft
            while prod < outshape[oleft] and i0 >= 0:
                prod *= inshape[i0]
                i0 -= 1
            if prod != outshape[oleft]:
                raise NotImplementedError(
                    f"reshape across interleaved axis boundaries: {inshape} -> {outshape}"
                )
            i0 += 1  # axes i0..ileft merge
            # trailing merged axes become single-chunk
            trailing = 1
            for ax in range(i0 + 1, ileft + 1):
                result_in[ax] = (inshape[ax],)
                trailing *= inshape[ax]
            result_in[i0] = tuple(inchunks[i0])
            result_out[oleft] = tuple(c * trailing for c in inchunks[i0])
            ileft = i0 - 1
            oleft -= 1
            continue
        if ileft >= 0 and oleft >= 0 and inshape[ileft] > outshape[oleft]:
            # split one input axis into several output axes
            prod = 1
            o0 = oleft
            while prod < inshape[ileft] and o0 >= 0:
                prod *= outshape[o0]
                o0 -= 1
            if prod != inshape[ileft]:
                raise NotImplementedError(
                    f"reshape across interleaved axis boundaries: {inshape} -> {outshape}"
                )
            o0 += 1  # out axes o0..oleft come from in axis ileft
            fac = 1
            for ax in range(o0 + 1, oleft + 1):
                result_out[ax] = (outshape[ax],)
                fac *= outshape[ax]
            c_in = inchunks[ileft]
            if all(c % fac == 0 for c in c_in):
                new_in = tuple(c_in)
            else:
                # snap chunk boundaries to multiples of fac (single pass)
                new_in = []
                carry = 0
                for c in c_in:
                    c += carry
                    keep = (c // fac) * fac
                    carry = c - keep
                    if keep:
                        new_in.append(keep)
                if carry:
                    if new_in:
                        new_in[-1] += carry
                    else:
                        new_in.append(carry)
                new_in = tuple(new_in)
            result_in[ileft] = new_in
            result_out[o0] = tuple(c // fac for c in new_in)
            ileft -= 1
            oleft = o0 - 1
            continue
        # leftover singleton axes
        if ileft >= 0:
            result_in[ileft] = (inshape[ileft],) if inshape[ileft] else (0,)
            ileft -= 1
            continue
        if oleft >= 0:
            result_out[oleft] = (outshape[oleft],) if outshape[oleft] else (0,)
            oleft -= 1
    return tuple(result_in), tuple(result_out)


class Reshape(ArrayExpr):
    """Logical reshape; lowers to pre-rechunk + ReshapeLowered.

    When the axis products interleave (e.g. ``(4, 6) -> (6, 4)``) no block
    mapping exists; the dense executor makes any reshape one torch op, so
    the plan falls back to no pre-rechunk and auto output chunks, as in
    the JAX package.
    """

    takes_narrow = True

    _parameters = ("array", "shape_")

    @functools.cached_property
    def _plan(self):
        try:
            return reshape_rechunk(self.array.shape, self.shape_, self.array.chunks)
        except NotImplementedError:
            return None, normalize_chunks("auto", self.shape_, dtype=self.array.dtype)

    @functools.cached_property
    def chunks(self):
        return self._plan[1]

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.shape_), dtype=self.array.dtype)

    def _simplify_down(self):
        if self.shape_ == self.array.shape:
            return self.array
        if type(self.array) is Reshape:
            return Reshape(self.array.array, self.shape_)
        return None

    def _lower(self):
        from dask_array_tpu_torch._rechunk import Rechunk

        in_chunks, out_chunks = self._plan
        arr = self.array
        if in_chunks is not None and in_chunks != arr.chunks:
            arr = Rechunk(arr, in_chunks)
        return ReshapeLowered(arr, self.shape_, out_chunks)

    def _accept_slice(self, index):
        """Push a basic slice below the reshape onto preserved axes.

        Reshape regroups only the axes whose sizes differ between the two
        shapes; axes in the longest common prefix and suffix of the shapes
        index whole rows/columns of the regrouped middle, so a slice that
        touches only those commutes: ``x.reshape(s)[i] == x[i'].reshape(s')``.
        """
        from dask_array_tpu_torch._slicing import Slice, is_basic_index, normalize_index

        if not is_basic_index(index):
            return None
        in_shape = self.array.shape
        out_shape = self.shape_
        if has_unknown_chunks(self.array.chunks):
            return None
        lead = 0
        for a, b in zip(in_shape, out_shape):
            if a != b:
                break
            lead += 1
        cap = min(len(in_shape), len(out_shape)) - lead
        trail = 0
        for a, b in zip(reversed(in_shape), reversed(out_shape)):
            if trail >= cap or a != b:
                break
            trail += 1
        if lead == 0 and trail == 0:
            return None
        out_nd = len(out_shape)
        mid = index[lead : out_nd - trail]
        if any(isinstance(i, Integral) or i != slice(None) for i in mid):
            return None
        head = tuple(index[:lead])
        tail = tuple(index[out_nd - trail :]) if trail else ()
        if all(not isinstance(i, Integral) and i == slice(None) for i in head + tail):
            return None  # nothing pushable
        inner = head + (slice(None),) * (len(in_shape) - lead - trail) + tail
        sliced = Slice(self.array, normalize_index(inner, in_shape))

        def _dim(ind, size):
            return len(range(*ind.indices(int(size))))

        new_out = [_dim(ind, out_shape[pos]) for pos, ind in enumerate(head) if not isinstance(ind, Integral)]
        new_out.extend(out_shape[lead : out_nd - trail])
        new_out.extend(
            _dim(ind, out_shape[out_nd - trail + pos])
            for pos, ind in enumerate(tail)
            if not isinstance(ind, Integral)
        )
        return Reshape(sliced, tuple(new_out))


class ReshapeLowered(ArrayExpr):
    takes_narrow = True

    _parameters = ("array", "shape_", "chunks_")

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.shape_), dtype=self.array.dtype)

    def _build(self, ctx):
        dense = ctx.build(self.array).dense()
        return BlockView(self.chunks_, dense=dense.reshape(self.shape_))


def reshape(x, shape, merge_chunks=True, limit=None):
    from dask_array_tpu_torch._collection import Array, new_collection

    expr = x.expr if isinstance(x, Array) else x
    if isinstance(shape, Integral):
        shape = (shape,)
    shape = tuple(int(s) for s in shape)
    known = not has_unknown_chunks(expr.chunks)
    size = expr.size
    if -1 in shape:
        if shape.count(-1) > 1:
            raise ValueError("can only specify one unknown dimension")
        if not known:
            raise ValueError(
                "cannot reshape with -1 on an array with unknown chunk sizes; "
                "call compute_chunk_sizes() first"
            )
        rest = int(np.prod([s for s in shape if s != -1])) if len(shape) > 1 else 1
        shape = tuple(size // max(1, rest) if s == -1 else s for s in shape)
    if known and int(np.prod(shape) if shape else 1) != size:
        raise ValueError(f"cannot reshape array of size {size} into shape {shape}")
    if shape == expr.shape:
        return new_collection(expr)
    if not known:
        if len(shape) == 1 and expr.ndim == 1:
            return new_collection(expr)
        raise ValueError(
            "reshape of arrays with unknown chunk sizes is only supported for "
            "no-ops; call compute_chunk_sizes() first"
        )
    return new_collection(Reshape(expr, shape))


def ravel(x):
    from dask_array_tpu_torch.ops._from_array import asarray

    x = asarray(x)
    if x.ndim == 1:
        return x
    return reshape(x, (-1,))


class ReshapeBlockwise(ArrayExpr):
    """Reshape each block independently (dask's reshape_blockwise).

    Valid when the reshape factors along block boundaries: every block's
    shape reshapes to the same relative split/merge.
    """

    takes_narrow = True

    _parameters = ("array", "shape_", "chunks_")

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.shape_), dtype=self.array.dtype)

    def _build(self, ctx):
        view = ctx.build(self.array)
        blocks = {}
        in_nb = view.numblocks
        for idx in iter_block_indices(self.numblocks):
            if len(idx) >= len(in_nb):
                in_idx = tuple(idx)[: len(in_nb)]
            else:
                # dimension-reducing: the merged trailing input axes are
                # single-block by construction
                in_idx = tuple(idx) + (0,) * (len(in_nb) - len(idx))
            out_shape = tuple(self.chunks_[ax][idx[ax]] for ax in range(len(idx)))
            blocks[tuple(idx)] = view.block(in_idx).reshape(out_shape)
        return BlockView(self.chunks_, blocks=blocks)


def reshape_blockwise(x, shape, chunks=None):
    """Reshape block-wise: each block reshapes independently (no data moves
    between blocks, unlike :func:`reshape`, which may rechunk).  The target
    ``shape`` must be consistent with a per-block reshape; pass ``chunks``
    when expanding dimensions.
    """
    from dask_array_tpu_torch._collection import Array, new_collection

    expr = x.expr if isinstance(x, Array) else x
    if isinstance(shape, Integral):
        shape = (shape,)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape) if shape else 1) != expr.size and -1 not in shape:
        raise ValueError(f"cannot reshape array of size {expr.size} into shape {shape}")
    if chunks is None:
        if len(shape) > expr.ndim:
            raise ValueError("reshape_blockwise without chunks= only supports reducing dimensionality")
        # merge trailing axes per block: only valid when merged axes are single-chunk
        in_chunks, out_chunks = reshape_rechunk(expr.shape, shape, expr.chunks)
        if in_chunks != expr.chunks:
            raise ValueError("reshape_blockwise would need a rechunk; pass chunks= explicitly")
        chunks = out_chunks
    else:
        chunks = normalize_chunks(chunks, shape, dtype=expr.dtype)
    return new_collection(ReshapeBlockwise(expr, shape, chunks))
