"""map_blocks: apply a function to every block.

Port of ``dask_array_tpu/ops/_map_blocks.py``: dtype, chunks, drop_axis,
new_axis, ``block_id``/``block_info`` injection, and
``map_blocks_multi_output`` for a function of several outputs.  The
function runs once per block on torch tensors, or on their numpy copies
where it is written in numpy (``_host.py``).
"""

from __future__ import annotations

import inspect
import math
import numbers
from numbers import Integral, Number

import numpy as np

from dask_array_tpu_torch import _host
from dask_array_tpu_torch._blockwise import Blockwise, _normalize_kwargs, _store
from dask_array_tpu_torch._chunks import cached_cumsum, validate_axis
from dask_array_tpu_torch._executor import BlockView, iter_block_indices
from dask_array_tpu_torch._expr import ArrayExpr


class MapBlocks(Blockwise):
    """Blockwise with optional block_id injection."""

    _inject_block_id = False

    def _accept_slice(self, index):
        if type(self)._inject_block_id:
            # culling blocks renumbers block_id beneath the func — the slice
            # must stay above the computed result
            return None
        return super()._accept_slice(index)

    def _block_kwargs(self, kwargs, out_coord):
        if type(self)._inject_block_id:
            return dict(kwargs, block_id=tuple(out_coord))
        return kwargs


class _MapBlocksWithId(MapBlocks):
    _inject_block_id = True


class MapBlocksInfo(Blockwise):
    """map_blocks with full block_info dicts (locations, chunk bounds)."""

    def _accept_slice(self, index):
        # slicing the inputs changes every block's coordinates and
        # array-locations as seen by the func
        return None

    def _block_kwargs(self, kwargs, out_coord):
        kwargs = dict(kwargs)
        info = {}
        for i, (arr, ind) in enumerate(self.arg_pairs):
            if ind is None or not isinstance(arr, ArrayExpr):
                continue
            coord = tuple(out_coord[self.out_ind.index(lbl)] if lbl in self.out_ind else 0 for lbl in ind)
            bounds = [cached_cumsum(c, initial_zero=True) for c in arr.chunks]
            loc = []
            for ax, c in enumerate(coord):
                c = min(c, len(arr.chunks[ax]) - 1)
                loc.append((int(bounds[ax][c]), int(bounds[ax][c + 1])))
            info[i] = {
                "shape": arr.shape,
                "num-chunks": arr.numblocks,
                "chunk-location": coord,
                "array-location": loc,
            }
        out_bounds = [cached_cumsum(c, initial_zero=True) for c in self.chunks]
        info[None] = {
            "shape": self.shape,
            "num-chunks": self.numblocks,
            "chunk-location": tuple(out_coord),
            "array-location": [
                (int(out_bounds[ax][c]), int(out_bounds[ax][c + 1])) for ax, c in enumerate(out_coord)
            ],
            "chunk-shape": tuple(self.chunks[ax][c] for ax, c in enumerate(out_coord)),
            "dtype": self.dtype,
        }
        kwargs["block_info"] = info
        return kwargs


class ChunksFreeze(ArrayExpr):
    """Layout pin: the chunks advertised here are load-bearing, whatever
    the optimizer does to the subtree below (``block_id``/``block_info``
    payloads are computed against them)."""

    takes_narrow = True

    _parameters = ("array", "chunks_")
    _defaults = {"chunks_": None}

    @property
    def chunks(self):
        if self.operand("chunks_") is not None:
            return self.operand("chunks_")
        return self.array.chunks

    @property
    def _meta(self):
        return self.array._meta

    def _build(self, ctx):
        view = ctx.build(self.array)
        if self.operand("chunks_") is None or view.chunks == self.chunks:
            return view
        return BlockView(self.chunks, dense=view.dense())


def freeze(expr: ArrayExpr) -> ArrayExpr:
    """Pin ``expr``'s current chunk layout (idempotent)."""
    if type(expr) is ChunksFreeze:
        return expr
    return ChunksFreeze(expr, tuple(tuple(c) for c in expr.chunks))


class ChunksOverride(ArrayExpr):
    """Declare the true output chunks of a map_blocks (the function changed
    block shapes)."""

    takes_narrow = True

    _parameters = ("array", "chunks_")

    @property
    def chunks(self):
        return self.chunks_

    @property
    def _meta(self):
        return self.array._meta

    def _build(self, ctx):
        view = ctx.build(self.array)
        # the inner node's declared chunks are wrong; keep its blocks, adopt ours
        if view._blocks is not None:
            return BlockView(self.chunks_, blocks=view.blocks_dict())
        return BlockView(self.chunks_, dense=view.dense())

    def _accept_slice(self, index):
        """Coarse block-cull through the declared grid: out block i is inner
        block i, so a unit-step range keeps blocks [b0, b1) on both sides."""
        from dask_array_tpu_torch._slicing import Slice, is_basic_index

        if not is_basic_index(index) or any(isinstance(i, numbers.Integral) for i in index):
            return None
        inner_index = []
        new_declared = []
        expect_inner = []
        residual = []
        culled = False
        for ax, ind in enumerate(index):
            c = self.chunks_[ax]
            in_c = self.array.chunks[ax]

            def keep(res):
                inner_index.append(slice(None))
                new_declared.append(tuple(c))
                expect_inner.append(tuple(in_c))
                residual.append(res)

            if ind == slice(None):
                keep(slice(None))
                continue
            if ind.step not in (1, None):
                return None
            if any(isinstance(x, float) and math.isnan(x) for x in c + in_c):
                return None
            bounds = cached_cumsum(c, initial_zero=True)
            total = int(bounds[-1])
            start = 0 if ind.start is None else int(ind.start)
            stop = total if ind.stop is None else min(int(ind.stop), total)
            if stop <= start or (start == 0 and stop == total):
                keep(ind)
                continue
            b0 = int(np.searchsorted(bounds, start, side="right")) - 1
            b1 = int(np.searchsorted(bounds, stop, side="left"))
            if b0 <= 0 and b1 >= len(c):
                keep(ind)
                continue
            in_bounds = cached_cumsum(in_c, initial_zero=True)
            inner_index.append(slice(int(in_bounds[b0]), int(in_bounds[b1]), 1))
            new_declared.append(tuple(c[b0:b1]))
            expect_inner.append(tuple(in_c[b0:b1]))
            if start == int(bounds[b0]) and stop == int(bounds[b1]):
                residual.append(slice(None))
            else:
                residual.append(slice(start - int(bounds[b0]), stop - int(bounds[b0]), 1))
            culled = True
        if not culled:
            return None
        # the cut is in the inner node's DECLARED coordinates, which lie
        # about the real output extents: sound only if the inner node
        # absorbs it as a whole-block cut
        cut = self.array._accept_slice(tuple(inner_index))
        if cut is None or tuple(cut.chunks) != tuple(expect_inner):
            return None
        out = ChunksOverride(cut, tuple(new_declared))
        if any(r != slice(None) for r in residual):
            out = Slice(out, tuple(residual))
        return out


def map_blocks(
    func,
    *args,
    name=None,
    token=None,
    dtype=None,
    chunks=None,
    drop_axis=None,
    new_axis=None,
    meta=None,
    **kwargs,
):
    """Apply ``func`` to every block of one or more chunked arrays.

    ``func`` receives aligned blocks as torch tensors (plus
    ``block_info``/``block_id`` when its signature asks for them) and may
    change dtype (``dtype=``), chunk sizes (``chunks=``), or dimensionality
    (``drop_axis=``/``new_axis=``).
    """
    from dask_array_tpu_torch._collection import Array, new_collection

    if not callable(func):
        raise TypeError("First argument must be callable")
    arrays = [a for a in args if isinstance(a, Array)]
    if not arrays:
        raise ValueError("map_blocks requires at least one Array argument")
    ndim = max(a.ndim for a in arrays)

    if drop_axis is None:
        drop_axis = []
    elif isinstance(drop_axis, Integral):
        drop_axis = [drop_axis]
    drop_axis = [validate_axis(ax, ndim) for ax in drop_axis]
    out_ndim = ndim - len(drop_axis)
    if new_axis is None:
        new_axis = []
    elif isinstance(new_axis, Integral):
        new_axis = [new_axis]
    new_axis = list(new_axis)
    out_ndim += len(new_axis)

    try:
        params = inspect.signature(func).parameters
    except (TypeError, ValueError):
        params = {}
    inject_id = "block_id" in params and "block_id" not in kwargs
    inject_info = "block_info" in params and "block_info" not in kwargs

    # out labels: kept input axes relabeled + new axes
    kept_iter = iter(ax for ax in range(ndim) if ax not in drop_axis)
    new_positions = sorted(validate_axis(ax, out_ndim) for ax in new_axis)
    out_labels = []
    new_axes_spec = {}
    next_label = ndim
    for pos in range(out_ndim):
        if pos in new_positions:
            out_labels.append(next_label)
            new_axes_spec[next_label] = 1
            next_label += 1
        else:
            out_labels.append(next(kept_iter))

    if chunks is not None and len(chunks) != out_ndim:
        raise ValueError(f"provided chunks have {len(chunks)} dims; expected {out_ndim}")

    # block_id/block_info payloads are computed against the inputs' layout
    # at construction; pin it so optimizer rewrites cannot desynchronize them
    pin_inputs = inject_id or inject_info
    pairs = []
    for a in args:
        if isinstance(a, Array):
            pairs.extend([freeze(a.expr) if pin_inputs else a.expr, tuple(range(ndim - a.ndim, ndim))])
        else:
            pairs.extend([a, None])

    if inject_info:
        cls = MapBlocksInfo
    elif inject_id:
        cls = _MapBlocksWithId
    else:
        cls = MapBlocks
    expr = cls(
        func,
        tuple(out_labels),
        token or name or getattr(func, "__name__", "map-blocks") or "map-blocks",
        np.dtype(dtype) if dtype is not None else (getattr(meta, "dtype", None) if meta is not None else None),
        None,
        _normalize_kwargs(new_axes_spec) if new_axes_spec else None,
        True,
        _normalize_kwargs(kwargs),
        *pairs,
    )
    if chunks is None:
        return new_collection(expr)
    norm = []
    for pos, c in enumerate(chunks):
        if isinstance(c, (tuple, list)):
            norm.append(tuple(c))
        elif isinstance(c, Number):
            norm.append((int(c),) * len(expr.chunks[pos]))
        else:
            raise ValueError(f"unsupported chunks entry {c!r}")
    # explicit chunks declare block SIZES; the block GRID is fixed by the inputs
    for pos, c in enumerate(norm):
        if len(c) != len(expr.chunks[pos]):
            raise ValueError(
                f"map_blocks chunks= declares {len(c)} blocks along axis "
                f"{pos} but the computation produces {len(expr.chunks[pos])}; "
                "chunks= can change block SIZES, not the block count"
            )
    return new_collection(ChunksOverride(expr, tuple(norm)))


# ---------------------------------------------------------------------------
# multi-output map_blocks
# ---------------------------------------------------------------------------


class MapBlocksMultiOutput(ArrayExpr):
    """Inner node: func returns a TUPLE of tensors per block.

    The walk builds a node once (``BuildContext.build`` caches by name), so
    the function runs once per block however many outputs are selected.
    """

    _parameters = ("func", "n_out", "kwargs")
    _lane_operands = ("func",)
    # operands[3:] are the input expressions

    @property
    def arrays(self):
        return self.operands[3:]

    @property
    def _array_args(self):
        return [a for a in self.arrays if isinstance(a, ArrayExpr)]

    @property
    def chunks(self):
        return self._array_args[0].chunks  # grid carrier only

    @property
    def _meta(self):
        return self._array_args[0]._meta

    def _build(self, ctx):
        views = [ctx.build(a) if isinstance(a, ArrayExpr) else a for a in self.arrays]
        grid = next(v for v in views if isinstance(v, BlockView))
        kwargs = dict(self.kwargs or ())
        blocks = {}
        for idx in iter_block_indices(grid.numblocks):
            args = [v.block(idx) if isinstance(v, BlockView) else v for v in views]
            out = _host.call(self, "func", self.func, args, kwargs, ctx.device)
            if not isinstance(out, tuple) or len(out) != self.n_out:
                raise ValueError(
                    f"map_blocks_multi_output function must return a tuple of "
                    f"{self.n_out} arrays"
                )
            blocks[tuple(idx)] = out
        return BlockView(self.chunks, blocks=blocks)


class MultiOutputBlock(ArrayExpr):
    """Selector: output ``index`` of a MapBlocksMultiOutput."""

    _parameters = ("inner", "index", "chunks_", "_dtype")

    @property
    def chunks(self):
        return self.chunks_

    @property
    def _meta(self):
        return np.empty((0,) * len(self.chunks_), dtype=self._dtype)

    def _build(self, ctx):
        view = ctx.build(self.inner)
        blocks = {idx: _store(blk[self.index], self._dtype) for idx, blk in view.blocks_dict().items()}
        return BlockView(self.chunks_, blocks=blocks)


def map_blocks_multi_output(func, *args, dtypes, chunkss=None, **kwargs):
    """Apply a function producing several outputs per block.

    ``dtypes``: one dtype per output. ``chunkss``: optional per-output chunk
    tuples (default: the first input's chunks).
    """
    from dask_array_tpu_torch._collection import Array, new_collection

    arrays = [a.expr if isinstance(a, Array) else a for a in args]
    if not any(isinstance(a, ArrayExpr) for a in arrays):
        raise ValueError("map_blocks_multi_output requires at least one Array")
    n_out = len(dtypes)
    inner = MapBlocksMultiOutput(func, n_out, tuple(sorted(kwargs.items())), *arrays)
    grid_chunks = next(a for a in arrays if isinstance(a, ArrayExpr)).chunks
    outs = []
    for i, dt in enumerate(dtypes):
        ch = tuple(chunkss[i]) if chunkss is not None else grid_chunks
        outs.append(new_collection(MultiOutputBlock(inner, i, ch, np.dtype(dt))))
    return tuple(outs)
