"""Blockwise / Elemwise expressions and blockwise fusion.

Port of ``dask_array_tpu/_blockwise.py``.  An Elemwise builds on the
*dense* tensor — torch broadcasts like numpy — with its operands cast to
numpy's ufunc loop dtypes first and the result cast to the numpy dtype the
metadata declares, so values follow numpy's promotion rules and not
torch's.  General blockwise ops (user functions, ``map_blocks``) build per
block, so each call sees exactly one block.
"""

from __future__ import annotations

import functools
import math
import numbers

import numpy as np
import torch

from dask_array_tpu_torch import config
from dask_array_tpu_torch._chunks import (
    cached_cumsum,
    cast,
    cat,
    compute_dtype,
    convert,
    format_of,
    has_unknown_chunks,
    is_float_dtype,
    parse_bytes,
    tensor_of,
    to_compute,
    torch_dtype,
    unify_blockdims,
    value_of,
)
from dask_array_tpu_torch._executor import BlockView, iter_block_indices
from dask_array_tpu_torch._expr import ArrayExpr, _numpy_equivalent, compute_meta, loop_dtypes


def _is_bcast(chunks_axis) -> bool:
    """A broadcast dim: one block of total size 0 or 1."""
    return len(chunks_axis) == 1 and sum(chunks_axis) in (0, 1)


def _unify_index_chunks(array_args):
    """Per index label, pick the common chunking across operands under the
    configured unification policy."""
    by_label: dict = {}
    for arr, ind in array_args:
        nb = arr.nbytes
        for pos, label in enumerate(ind):
            c = arr.chunks[pos]
            # broadcast dims defer to the real dims
            if _is_bcast(c):
                by_label.setdefault(label, []).append((c, 0.0, True))
            else:
                by_label.setdefault(label, []).append((c, nb, False))
    policy = config.get("array.unify-chunks-policy", "auto")
    limit = parse_bytes(config.get("array.unify-chunks-limit", "512 MiB"))
    out = {}
    for label, cands in by_label.items():
        real = [(c, nb) for c, nb, is_bcast in cands if not is_bcast]
        totals = {int(sum(c)) for c, _ in real if not math.isnan(sum(c))}
        if len(totals) > 1:
            raise ValueError(
                "operands could not be broadcast together: axis sizes "
                f"{sorted(totals)} differ along one dimension"
            )
        if not real:
            out[label] = cands[0][0]
            continue
        if len({c for c, _ in real}) == 1:
            out[label] = real[0][0]
            continue
        lengths = [sum(c) for c, _ in real if not math.isnan(sum(c))]
        sizes = [nb for _, nb in real if not (isinstance(nb, float) and math.isnan(nb))]
        row_bytes = (max(sizes) / max(1, max(lengths))) if (sizes and lengths) else 1.0
        out[label] = unify_blockdims(real, policy=policy, limit_bytes=limit, row_bytes=row_bytes)
    return out


_NHEAD = 8  # number of fixed leading operands before the (arg, ind) pairs


def _check_broadcastable(exprs):
    """Raise (numpy-style) if operand shapes cannot broadcast."""
    shapes = [e.shape for e in exprs if isinstance(e, ArrayExpr)]
    if len(shapes) < 2:
        return
    ndim = max(len(s) for s in shapes)
    for ax in range(1, ndim + 1):
        sizes = set()
        for s in shapes:
            if ax <= len(s):
                d = s[-ax]
                if isinstance(d, float) and math.isnan(d):
                    continue
                if d != 1:
                    sizes.add(d)
        if len(sizes) > 1:
            raise ValueError(
                "operands could not be broadcast together with shapes "
                + " ".join(str(tuple(s)) for s in shapes)
            )


def _host_scalar(a, loop_dtype=None):
    """A scalar operand for a torch op.

    numpy scalars and 0-d arrays become Python scalars (their numpy dtype
    has already shaped the loop dtypes).  A scalar whose loop dtype is a
    float16 becomes a 0-d CPU tensor of that dtype: numpy (NEP 50)
    rounds the scalar to the loop dtype first, while torch reads a Python
    scalar (or a wrapped number) in the second position of a binary op
    unrounded, in its float32 compute type, so float16 ``x * 0.1`` would
    multiply by 0.1 and ``0.1 * x`` by float16(0.1).  A 0-d tensor of the
    loop dtype gives numpy's value in either position, on any device.  (A
    uint64 loop takes its ints as bits: ``ops/ufuncs.py::uint64_loop``.)
    """
    if isinstance(a, (np.generic, np.ndarray)) and np.ndim(a) == 0:
        a = a.item()
    if loop_dtype is not None and isinstance(a, (bool, int, float)) and np.dtype(loop_dtype) == np.float16:
        return torch.tensor(a, dtype=torch_dtype(loop_dtype))
    if isinstance(a, bool) and loop_dtype is not None and np.dtype(loop_dtype).kind != "b":
        return int(a)  # torch takes a Python bool as a bool tensor
    return a


def _scale_operands(func, args, out_dtype, kwargs):
    """``(x, s)`` when ``func(*args)`` is a multiply the scale kernel
    computes (``kernels/scale.py``): a real float result, one tensor
    operand of the result's dtype and shape, and the other a number or a
    tensor that is a scalar, a row or a column of it.  None otherwise;
    ``scale`` rounds a number to x's dtype.
    """
    from dask_array_tpu_torch.kernels.scale import scale_form

    if func is not torch.mul or kwargs or len(args) != 2 or not is_float_dtype(out_dtype):
        return None
    if not all(isinstance(a, (torch.Tensor, bool, int, float)) for a in args):
        return None
    if any(isinstance(a, torch.Tensor) and a.dtype != torch_dtype(out_dtype) for a in args):
        return None
    shape = torch.broadcast_shapes(*(np.shape(a) for a in args))
    full = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor) and a.shape == shape]
    if len(full) != 1:
        return None
    x, s = args[full[0]], args[1 - full[0]]
    if scale_form(x.shape, np.shape(s)) is None:
        return None
    return x, s


def _operand(t, dtype):
    """A held block as an operand of a loop of numpy ``dtype``: in its
    compute dtype (``_chunks.to_compute``); numbers pass through."""
    return to_compute(t, dtype) if isinstance(t, torch.Tensor) else t


def _store(t, dtype):
    """A result computed for numpy ``dtype`` as the block that dtype holds."""
    return cast(t, dtype) if isinstance(t, torch.Tensor) else t


def _narrow_scalar(a, dt, device):
    """A number or numpy scalar as a 0-d held block of numpy's ``dt``
    (rounded there first, as numpy casts it)."""
    with np.errstate(all="ignore"):
        return tensor_of(np.asarray(a).astype(dt).reshape(())).to(device)


def _narrow_call(node, func, args, device):
    """An ``Elemwise`` with a narrow operand or result (``_narrow``): each
    operand converted to numpy's loop dtype (a narrow one then decoded to
    float32 or int32), ``func`` on the values, and the result stored in the
    node's dtype (encoded where it is narrow), so each op rounds as the
    JAX package's and ml_dtypes' loops round.  A cast converts once; a
    function that only moves elements (``narrow_patterns``) and the
    selection of ``where`` move the patterns as they are."""
    from dask_array_tpu_torch import _host

    srcs = [a.dtype if isinstance(a, ArrayExpr) else None for a in node.args]
    out_dt = node.dtype
    kwargs = node._kwargs_dict
    if getattr(func, "narrow_convert", False):
        return convert(args[0], srcs[0], out_dt)
    if getattr(func, "narrow_patterns", False) and all(s in (None, out_dt) for s in srcs):
        return _host.call(node, "func", func, args, kwargs, device)
    if getattr(func, "narrow_select", False) and format_of(out_dt) is not None:
        cond, picks = args[0], []
        cond = value_of(cond, srcs[0]).to(torch.bool) if isinstance(cond, torch.Tensor) else bool(cond)
        for a, s in zip(args[1:], srcs[1:]):
            picks.append(convert(a, s, out_dt) if isinstance(a, torch.Tensor) else _narrow_scalar(a, out_dt, device))
        return torch.where(torch.as_tensor(cond, device=device), *picks)
    np_fn = _numpy_equivalent(func)
    dts = None
    if np_fn is not None and np_fn.nin == len(args):
        spec = [s if s is not None else (a.dtype if isinstance(a, np.generic) else type(a))
                for a, s in zip(args, srcs)]
        try:
            dts = np_fn.resolve_dtypes(tuple(spec) + (None,) * np_fn.nout)[: np_fn.nin]
        except (TypeError, OverflowError):
            dts = None
    if dts is not None:
        vals = [to_compute(convert(a, s, dt) if s is not None else _narrow_scalar(a, dt, device), dt)
                for a, s, dt in zip(args, srcs, dts)]
    else:
        # no ufunc loop: each narrow operand as its value
        vals = [value_of(a, s) for a, s in zip(args, srcs)]
    out = torch.as_tensor(_host.call(node, "func", func, vals, kwargs, device), device=device)
    return cast(out, out_dt) if format_of(out_dt) is not None else _store(out, out_dt)


def _gather(arr_view, coords, contracted, concatenate, pos, prefix):
    """The blocks of ``arr_view`` at ``coords`` (one tuple of block indices
    an axis), nested a level per contracted axis and concatenated there
    when ``concatenate``.  A plain recursion: a closure that calls itself
    is a reference cycle, which would keep ``arr_view`` on the device until
    a garbage collection."""
    if pos == len(coords):
        return arr_view.block(prefix)
    parts = [_gather(arr_view, coords, contracted, concatenate, pos + 1, prefix + (c,)) for c in coords[pos]]
    if pos not in contracted:
        return parts[0]
    if not concatenate:
        return parts
    return parts[0] if len(parts) == 1 else cat(parts, dim=pos)


class Blockwise(ArrayExpr):
    """Apply ``func`` block-wise following an index pattern.

    operands = [func, out_ind, token, dtype, adjust_chunks, new_axes,
                concatenate, kwargs, arg0, ind0, arg1, ind1, ...]

    ``out_ind``/``indN`` are tuples of hashable index labels.  A label
    that appears in an argument but not in ``out_ind`` is contracted: with
    ``concatenate=True`` the function receives that argument's blocks along
    it concatenated into one tensor; otherwise it receives them as nested
    lists (outermost list = first contracted position), as dask does.
    """

    _parameters = (
        "func",
        "out_ind",
        "token",
        "_dtype",
        "adjust_chunks",
        "new_axes",
        "concatenate",
        "kwargs",
    )
    _defaults = {
        "token": None,
        "_dtype": None,
        "adjust_chunks": None,
        "new_axes": None,
        "concatenate": True,
        "kwargs": (),
    }

    _fusable = True
    _lane_operands = ("func",)

    def _name_prefix(self):
        tok = self.operand("token")
        return tok if tok else type(self).__name__.lower()

    # -- operand views -------------------------------------------------------

    @property
    def arg_pairs(self):
        ops = self.operands[_NHEAD:]
        return [(ops[i], ops[i + 1]) for i in range(0, len(ops), 2)]

    @property
    def array_args(self):
        return [(a, i) for a, i in self.arg_pairs if i is not None and isinstance(a, ArrayExpr)]

    @property
    def _kwargs_dict(self):
        return dict(self.kwargs or ())

    # -- metadata -------------------------------------------------------------

    @functools.cached_property
    def _index_chunks(self):
        """Map index label -> unified chunks along that label (cost-aware)."""
        out = _unify_index_chunks(self.array_args)
        for label, size in dict(self.new_axes or ()).items():
            out[label] = size if isinstance(size, tuple) else (size,)
        return out

    @functools.cached_property
    def chunks(self):
        adjust = dict(self.adjust_chunks or ())
        chunks = []
        for label in self.out_ind:
            c = self._index_chunks[label]
            if label in adjust:
                adj = adjust[label]
                if callable(adj):
                    c = tuple(adj(x) for x in c)
                elif isinstance(adj, numbers.Number):
                    c = (int(adj),) * len(c)
                elif isinstance(adj, (tuple, list)):
                    c = tuple(adj)
                else:
                    raise NotImplementedError(f"adjust_chunks values must be callable, int, or tuple, got {adj!r}")
            chunks.append(tuple(c))
        return tuple(chunks)

    @property
    def ndim(self):
        # derivable from the index pattern: metadata access (ndim/dtype)
        # must not force chunk computation
        return len(self.out_ind)

    @functools.cached_property
    def _meta(self):
        dtype = self.operand("_dtype")
        if dtype is not None:
            return np.empty((0,) * len(self.out_ind), dtype=np.dtype(dtype))
        args = [a for a, _ in self.arg_pairs]
        meta = compute_meta(self.func, len(self.out_ind), *args, **self._kwargs_dict)
        if meta is None:
            raise ValueError(f"could not infer dtype of {self!r}; pass dtype= explicitly")
        return meta

    # -- lowering: operand alignment -------------------------------------------

    def _lower(self):
        from dask_array_tpu_torch._rechunk import Rechunk

        new_ops = list(self.operands[:_NHEAD])
        changed = False
        for arr, ind in self.arg_pairs:
            if ind is not None and isinstance(arr, ArrayExpr):
                want = tuple(
                    self._index_chunks[label] if not _is_bcast(arr.chunks[pos]) else arr.chunks[pos]
                    for pos, label in enumerate(ind)
                )
                if want != arr.chunks and not has_unknown_chunks(arr.chunks):
                    arr = Rechunk(arr, want)
                    changed = True
            new_ops.extend([arr, ind])
        if changed:
            return type(self)(*new_ops)
        return None

    # Slice pushdown for generic blockwise (map_blocks-style funcs):
    #   exact  — block-boundary-aligned slices on untransformed labels push
    #            verbatim into the inputs;
    #   coarse — any other unit-step range culls WHOLE blocks: inputs take a
    #            block-aligned cut, a residual slice trims the kept extent.
    def _accept_slice(self, index):
        from dask_array_tpu_torch._slicing import Slice, is_basic_index

        if not is_basic_index(index) or any(isinstance(i, numbers.Integral) for i in index):
            return None
        adjust = dict(self.adjust_chunks or ())
        new_axes = dict(self.new_axes or ())
        exact: dict = {}  # label -> out slice pushed verbatim
        coarse: dict = {}  # label -> (block-aligned input slice, b0, b1)
        residual = [slice(None)] * len(index)
        culled = False
        for pos, ind in enumerate(index):
            if ind == slice(None):
                continue
            if ind.step not in (1, None):
                return None
            label = self.out_ind[pos]
            out_c = self.chunks[pos]
            if any(isinstance(c, float) and math.isnan(c) for c in out_c):
                return None
            bounds = cached_cumsum(out_c, initial_zero=True)
            total = int(bounds[-1])
            start = 0 if ind.start is None else int(ind.start)
            stop = total if ind.stop is None else min(int(ind.stop), total)
            if stop <= start:
                residual[pos] = ind  # empty selection: nothing to cull
                continue
            if label not in adjust and label not in new_axes and start in bounds and stop in bounds:
                exact[label] = ind
                continue
            if label in new_axes:
                residual[pos] = ind  # no input carries this axis
                continue
            b0 = int(np.searchsorted(bounds, start, side="right")) - 1
            b1 = int(np.searchsorted(bounds, stop, side="left"))
            if b0 <= 0 and b1 >= len(out_c):
                residual[pos] = ind  # every block still needed
                continue
            in_c = self._index_chunks[label]
            if any(isinstance(c, float) and math.isnan(c) for c in in_c):
                residual[pos] = ind
                continue
            in_bounds = cached_cumsum(in_c, initial_zero=True)
            coarse[label] = (slice(int(in_bounds[b0]), int(in_bounds[b1]), 1), b0, b1)
            if start == int(bounds[b0]) and stop == int(bounds[b1]):
                residual[pos] = slice(None)
            else:
                residual[pos] = slice(start - int(bounds[b0]), stop - int(bounds[b0]), 1)
            culled = True
        if not exact and not culled:
            return None
        # per-block (tuple) adjust_chunks entries narrow to the kept blocks
        new_adjust = self.operand("adjust_chunks")
        if any(label in coarse and isinstance(val, (tuple, list)) for label, val in adjust.items()):
            new_adjust = tuple(
                (
                    label,
                    tuple(val[coarse[label][1] : coarse[label][2]])
                    if label in coarse and isinstance(val, (tuple, list))
                    else val,
                )
                for label, val in adjust.items()
            )
        new_ops = list(self.operands[:_NHEAD])
        new_ops[4] = new_adjust
        for arr, a_ind in self.arg_pairs:
            if a_ind is not None and isinstance(arr, ArrayExpr):
                sub = []
                for pos, lbl in enumerate(a_ind):
                    if _is_bcast(arr.chunks[pos]):
                        sub.append(slice(None))
                    elif lbl in exact:
                        sub.append(exact[lbl])
                    elif lbl in coarse:
                        sub.append(coarse[lbl][0])
                    else:
                        sub.append(slice(None))
                if any(s != slice(None) for s in sub):
                    arr = Slice(arr, tuple(sub))
            new_ops.extend([arr, a_ind])
        out = type(self)(*new_ops)
        if any(r != slice(None) for r in residual):
            out = Slice(out, tuple(residual))
        return out

    # -- execution ---------------------------------------------------------------

    def _arg_block(self, arr_view, ind, coord_of):
        """One argument's block for the output block at ``coord_of``
        (broadcast axes, with one block, always give block 0); contracted
        labels gather every block along their axis."""
        nb = arr_view.numblocks
        coords = [
            (0 if nb[pos] == 1 else coord_of[label],) if label in coord_of else tuple(range(nb[pos]))
            for pos, label in enumerate(ind)
        ]
        contracted = [pos for pos, label in enumerate(ind) if label not in coord_of]
        if not contracted:
            return arr_view.block(tuple(c[0] for c in coords))

        return _gather(arr_view, coords, contracted, self.concatenate, 0, ())

    def _build(self, ctx):
        views = {arr._name: ctx.build(arr) for arr, _ in self.array_args}
        kwargs = self._kwargs_dict
        new_axes = dict(self.new_axes or ())
        blocks = {}
        for out_coord in iter_block_indices(self.numblocks):
            coord_of = {
                label: out_coord[i]
                for i, label in enumerate(self.out_ind)
                if label not in new_axes
            }
            args = []
            for arr, ind in self.arg_pairs:
                if ind is None or not isinstance(arr, ArrayExpr):
                    args.append(arr)
                else:
                    args.append(self._arg_block(views[arr._name], ind, coord_of))
            blocks[tuple(out_coord)] = _store(self._call(args, kwargs, out_coord, ctx.device), self.dtype)
        return BlockView(self.chunks, blocks=blocks)

    def _call(self, args, kwargs, out_coord, device):
        """The function on one output block's arguments, in its lane
        (torch, or numpy on the host: ``_host.py``)."""
        from dask_array_tpu_torch import _host

        return _host.call(self, "func", self.func, args, self._block_kwargs(kwargs, out_coord), device)

    def _block_kwargs(self, kwargs, out_coord):
        return kwargs


class Elemwise(Blockwise):
    """Broadcasting element-wise application (dense fast path)."""

    takes_narrow = True

    _parameters = ("func", "kwargs")
    _defaults = {"kwargs": ()}

    # remaining operands (2:) are the raw args (exprs or scalars)

    @property
    def args(self):
        return self.operands[2:]

    @property
    def arg_pairs(self):
        out_ind = self.out_ind
        res = []
        for a in self.args:
            if isinstance(a, ArrayExpr):
                res.append((a, tuple(out_ind[len(out_ind) - a.ndim:])))
            else:
                res.append((a, None))
        return res

    @functools.cached_property
    def out_ind(self):
        nd = max((a.ndim for a in self.args if isinstance(a, ArrayExpr)), default=0)
        return tuple(range(nd))

    @property
    def out_ndim(self):
        return len(self.out_ind)

    @property
    def adjust_chunks(self):
        return None

    @property
    def new_axes(self):
        return None

    @property
    def concatenate(self):
        return True

    @property
    def token(self):
        return None

    def _name_prefix(self):
        name = getattr(self.func, "__name__", None)
        return name if name else "elemwise"

    def _accept_transpose(self, axes):
        """transpose(elemwise(f, a, b)) == elemwise(f, transpose(a),
        transpose(b)) when no operand broadcasts."""
        from dask_array_tpu_torch.ops.manipulation import make_transpose

        nd = self.out_ndim
        out_shape = self.shape
        new_args = []
        for a in self.args:
            if isinstance(a, ArrayExpr):
                if a.ndim != nd or tuple(a.shape) != tuple(out_shape):
                    return None
                new_args.append(make_transpose(a, axes))
            else:
                new_args.append(a)
        return Elemwise(self.operand("func"), self.operand("kwargs"), *new_args)

    @functools.cached_property
    def _meta(self):
        meta = compute_meta(self.func, self.out_ndim, *self.args, **self._kwargs_dict)
        if meta is None:
            raise ValueError(f"could not infer dtype for {self!r}")
        return meta

    @functools.cached_property
    def _index_chunks(self):
        return _unify_index_chunks(self.array_args)

    def _lower(self):
        from dask_array_tpu_torch._rechunk import Rechunk

        new_args = []
        changed = False
        out_ind = self.out_ind
        for a in self.args:
            if isinstance(a, ArrayExpr) and not has_unknown_chunks(a.chunks):
                ind = tuple(out_ind[len(out_ind) - a.ndim:])
                want = tuple(
                    self._index_chunks[label] if not _is_bcast(a.chunks[pos]) else a.chunks[pos]
                    for pos, label in enumerate(ind)
                )
                if want != a.chunks:
                    a = Rechunk(a, want)
                    changed = True
            new_args.append(a)
        if changed:
            return type(self)(*self.operands[:2], *new_args)
        return None

    def _build(self, ctx):
        from dask_array_tpu_torch import _host

        args = [ctx.build(a).dense() if isinstance(a, ArrayExpr) else a for a in self.args]
        func = self.func
        if _host.any_host_block(args):
            # masked, duck or record blocks: numpy's counterpart on the host
            out = _host.call(self, "func", func, args, self._kwargs_dict, ctx.device)
            if _host.is_host_block(out) and out.dtype != self.dtype:
                out = out.astype(self.dtype)
            return BlockView(self.chunks, dense=out)
        if not getattr(func, "ticks_aware", False):
            from dask_array_tpu_torch.ops._casting import datetime_call, is_datetime

            if any(is_datetime(a) for a in self.args):
                # datetime operands: int64 ticks in numpy's loop units
                out = datetime_call(func, self.args, args, self.dtype, self._kwargs_dict)
                return BlockView(self.chunks, dense=_store(out, self.dtype))
        if any(format_of(a.dtype) is not None for a in (self, *self.args) if isinstance(a, ArrayExpr)):
            return BlockView(self.chunks, dense=_narrow_call(self, func, args, ctx.device))
        dts = loop_dtypes(func, args)
        if dts is not None:
            from dask_array_tpu_torch.ops.ufuncs import compare_outside_range

            decided = compare_outside_range(func, args, dts)
            if decided is not None:
                return BlockView(self.chunks, dense=decided)
            args = [_host_scalar(_operand(a, dt), dt) for a, dt in zip(args, dts)]
            if any(np.dtype(dt) == np.uint64 for dt in dts):
                from dask_array_tpu_torch.ops.ufuncs import uint64_loop

                func = uint64_loop(func, dts)
            elif not isinstance(args[0], torch.Tensor) and len(args) > 1 and isinstance(args[1], torch.Tensor):
                # a number first: a 0-d tensor of its loop dtype (torch's
                # comparisons and extrema take no number there)
                args[0] = torch.tensor(args[0], dtype=compute_dtype(dts[0]), device=args[1].device)
        elif getattr(func, "numpy_function", None) is None:
            # (a port function of a numpy non-ufunc converts its own
            # operands: a numpy scalar keeps its dtype there)
            args = [_host_scalar(a) for a in args]
        scaled = _scale_operands(func, args, self.dtype, self.kwargs)
        if scaled is not None:
            from dask_array_tpu_torch.kernels.scale import scale

            dense = scale(*scaled)
        else:
            from dask_array_tpu_torch import _host

            dense = _host.call(self, "func", func, args, self._kwargs_dict, ctx.device)
        return BlockView(self.chunks, dense=_store(dense, self.dtype))

    # slice pushdown: x[idx] == op(a, b)[idx] == op(a[idx'], b[idx'])
    def _accept_slice(self, index):
        from dask_array_tpu_torch._slicing import Slice, slice_for_ndim

        out_shape = self.shape
        new_args = []
        for a in self.args:
            if isinstance(a, ArrayExpr):
                sub = slice_for_ndim(index, self.out_ndim, a.ndim, a.shape, out_shape)
                if sub is None:
                    return None
                a = Slice(a, sub) if sub else a
            new_args.append(a)
        return type(self)(*self.operands[:2], *new_args)

    # rechunk pushdown: rechunk(op(a, b)) == op(rechunk(a), rechunk(b))
    def _accept_rechunk(self, target_chunks):
        from dask_array_tpu_torch._rechunk import Rechunk

        out_ind = self.out_ind
        new_args = []
        for a in self.args:
            if isinstance(a, ArrayExpr):
                if has_unknown_chunks(a.chunks):
                    return None
                sub = tuple(
                    a.chunks[pos] if _is_bcast(a.chunks[pos])
                    else target_chunks[len(out_ind) - a.ndim + pos]
                    for pos in range(a.ndim)
                )
                if sub != a.chunks:
                    a = Rechunk(a, sub)
            new_args.append(a)
        return type(self)(*self.operands[:2], *new_args)


class FusedBlockwise(ArrayExpr):
    """Display/bookkeeping wrapper around a group of fused blockwise nodes.

    The grouped subtree runs in one executor walk already; the wrapper
    marks the fusion boundary for ``pprint``.
    """

    takes_narrow = True

    _parameters = ("root", "n_fused")
    _defaults = {"n_fused": 1}

    @property
    def _meta(self):
        return self.root._meta

    @property
    def chunks(self):
        return self.root.chunks

    def _pprint_line(self):
        return f"FusedBlockwise[{self.n_fused}]"

    def tree_repr(self, indent=0, seen=None):
        seen = seen if seen is not None else set()
        seen.add(self._name)
        return " " * indent + self._pprint_line() + "\n" + self.root.tree_repr(indent + 2, seen)

    def _build(self, ctx):
        return ctx.build(self.root)


def is_fusable(expr) -> bool:
    return isinstance(expr, Blockwise) and expr._fusable or getattr(expr, "_fusable_leaf", False)


def optimize_blockwise_fusion(root: ArrayExpr) -> ArrayExpr:
    """Wrap maximal fusable blockwise groups in FusedBlockwise markers.

    A group is a connected set of fusable nodes whose interior members have
    no dependents outside the group.
    """
    from dask_array_tpu_torch._expr import collect_dependents

    dependents = collect_dependents(root)
    nodes = list(root.walk())
    absorbers: dict = {}  # name -> (arg_name_set, numblocks)
    for n in nodes:
        if isinstance(n, Blockwise) and n._fusable:
            absorbers[n._name] = (frozenset(a._name for a, _ in n.array_args), n.numblocks)

    def fuses_into_parent(node, parent):
        info = absorbers.get(parent._name)
        return info is not None and node._name in info[0] and node.numblocks == info[1]

    groups = []  # (root_node, member_names)
    for node in nodes:
        if not (isinstance(node, Blockwise) and node._fusable):
            continue
        deps = dependents.get(node._name, ())
        if any(fuses_into_parent(node, p) for p in deps):
            continue  # not a root; belongs to a parent's group
        if any(isinstance(p, FusedBlockwise) for p in deps):
            continue  # already wrapped: optimize() must be idempotent
        members = set()
        stack = [node]
        while stack:
            n = stack.pop()
            if n._name in members:
                continue
            members.add(n._name)
            if not isinstance(n, Blockwise):
                continue
            for child, _ in n.array_args:
                if not is_fusable(child) or not fuses_into_parent(child, n):
                    continue
                # interior nodes must not leak outside the group
                outside = [
                    d for d in dependents.get(child._name, ()) if d._name not in members and d is not n
                ]
                if any(not fuses_into_parent(child, d) for d in outside):
                    continue
                stack.append(child)
        groups.append((node, members))

    if not groups:
        return root
    mapping = {node._name: FusedBlockwise(node, len(members)) for node, members in groups}
    return root._substitute_many(mapping, {})


# ---------------------------------------------------------------------------
# user-facing constructors
# ---------------------------------------------------------------------------


def _normalize_kwargs(kwargs: dict):
    return tuple(sorted(kwargs.items()))


def elemwise(op, *args, dtype=None, **kwargs):
    """Apply an elementwise torch function with numpy broadcasting."""
    from dask_array_tpu_torch._collection import Array, new_collection

    def coerce(a):
        if isinstance(a, Array):
            return a.expr
        # n-d array-likes must become leaves: left raw they'd be treated as
        # scalars and pushdown rewrites would never index them
        if isinstance(a, (list, tuple)) or (
            hasattr(a, "shape") and hasattr(a, "dtype") and getattr(a, "ndim", 0) > 0
        ):
            from dask_array_tpu_torch.ops._from_array import asarray

            return asarray(a).expr
        return a

    exprs = [coerce(a) for a in args]
    expr = Elemwise(op, _normalize_kwargs(kwargs), *exprs)
    _check_broadcastable(exprs)
    if dtype is not None and np.dtype(dtype) != expr.dtype:
        from dask_array_tpu_torch.ops._casting import astype_expr

        expr = astype_expr(expr, np.dtype(dtype))
    return new_collection(expr)


def blockwise(
    func,
    out_ind,
    *args,
    name=None,
    token=None,
    dtype=None,
    adjust_chunks=None,
    new_axes=None,
    align_arrays=True,
    concatenate=None,
    meta=None,
    **kwargs,
):
    """General blockwise operation (dask.array.blockwise-compatible).

    ``args`` alternate arrays (or other values, with index ``None``) and
    their index labels.  ``func`` is a torch function that sees one block
    of each argument per output block; labels missing from ``out_ind`` are
    contracted (see :class:`Blockwise`).  ``concatenate=None`` (the
    default, as in dask) passes contracted blocks as nested lists.
    """
    from dask_array_tpu_torch._collection import Array, new_collection

    out_ind = tuple(out_ind)
    pairs = []
    it = iter(args)
    for a in it:
        ind = next(it)
        if isinstance(a, Array):
            a = a.expr
        pairs.extend([a, tuple(ind) if ind is not None else None])
    if meta is not None and dtype is None:
        dtype = getattr(meta, "dtype", None)
    adjust = _normalize_kwargs(adjust_chunks) if isinstance(adjust_chunks, dict) else adjust_chunks
    naxes = _normalize_kwargs(new_axes) if isinstance(new_axes, dict) else new_axes
    expr = Blockwise(
        func,
        out_ind,
        token or name,
        np.dtype(dtype) if dtype is not None else None,
        adjust,
        naxes,
        bool(concatenate),
        _normalize_kwargs(kwargs),
        *pairs,
    )
    return new_collection(expr)
