"""The user-facing ``Array`` collection.

Port of ``dask_array_tpu/_collection.py``: a thin wrapper around one
``ArrayExpr`` with numpy-style operators (torch functions underneath),
basic ``__getitem__``, ``.T``, the reductions and contractions as methods
(``sum`` ... ``moment``, ``dot``, ``@``), ``compute``, ``optimize`` and
``pprint``, ``persist`` (a ``Persisted`` leaf holding the device tensor
under the collection's name) and ``freeze_chunks``.  ``out=`` replaces the
target's expression in place.
"""

from __future__ import annotations

import functools
from numbers import Number

import numpy as np
import torch

from dask_array_tpu_torch._chunks import format_of, has_unknown_chunks, numpy_dtype, tensor_of
from dask_array_tpu_torch._expr import ArrayExpr
from dask_array_tpu_torch.ops.ufuncs import (
    absolute_,
    floor_divide_,
    greater_,
    greater_equal_,
    less_,
    less_equal_,
    remainder_,
)


def new_collection(expr: ArrayExpr) -> "Array":
    """Wrap an expression as a user-facing :class:`Array`."""
    return Array(expr)


def handle_out(out, result: "Array") -> "Array":
    """numpy-style ``out=`` for lazy results: ``out`` must be an ``Array``;
    its expression is replaced in place with the (dtype-cast) result's."""
    if isinstance(out, tuple):
        if len(out) == 1:
            out = out[0]
        elif len(out) > 1:
            raise NotImplementedError("The out parameter is not fully supported")
        else:
            out = None
    if out is None:
        return result
    if not isinstance(out, Array):
        raise NotImplementedError(
            f"The out parameter is not fully supported. Received type "
            f"{type(out).__name__}, expected dask Array"
        )
    if out.shape != result.shape:
        raise ValueError(
            "Mismatched shapes between result and out parameter. "
            f"out={out.shape}, result={result.shape}"
        )
    if out.dtype != result.dtype:
        result = result.astype(out.dtype)
    out._replace_expr(result.expr)
    return out


class Persisted(ArrayExpr):
    """A computed device tensor pinned to the original collection's name.

    The name is the token too, so tokenizing a plan that holds this leaf
    never hashes the tensor's contents."""

    takes_narrow = True

    _parameters = ("buffer", "chunks_", "pinned_name", "dtype_")
    _defaults = {"dtype_": None}

    _fusable_leaf = True

    @property
    def _name(self):  # type: ignore[override]
        return self.pinned_name

    @property
    def deterministic_token(self):  # type: ignore[override]
        return self.pinned_name

    @property
    def _lower_cache_key(self):
        # the original expression shares the name: keep their lowered
        # forms apart, or lowering one would return the other
        return f"persist-{self.pinned_name}"

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        # a datetime's unit is in the metadata only (its ticks are int64)
        dtype = self.dtype_ if self.dtype_ is not None else numpy_dtype(self.buffer.dtype)
        return np.empty((0,) * len(self.chunks_), dtype=dtype)

    def _leaf_buffers(self):
        yield (f"persist-{self.pinned_name}", self.buffer)

    def _structural_operands(self):
        from dask_array_tpu_torch._chunks import dtype_key

        return [("buf", dtype_key(self._meta.dtype)), self.chunks_]

    def _build(self, ctx):
        from dask_array_tpu_torch._executor import BlockView

        return BlockView(self.chunks_, dense=ctx.leaf(f"persist-{self.pinned_name}"))

    def __reduce__(self):
        # the tensor travels in host memory, so a leaf pickled beside a
        # card loads where there is none; a sharded one as its dense form
        from dask_array_tpu_torch.parallel._sharded import ShardedTensor

        buf = self.buffer
        if isinstance(buf, ShardedTensor):
            buf = buf.gather(record=False)
        return (_load_persisted, (buf.cpu(), self.chunks_, self.pinned_name, self.dtype_))


def _load_persisted(buffer, chunks, pinned_name, dtype=None):
    """A pickled ``Persisted`` leaf, its tensor on the configured device.
    Where that is a card this machine lacks, the tensor stays in host
    memory: a ``compute()`` there raises as every one does without a card,
    and one under ``config.set({"device": "cpu"})`` runs."""
    from dask_array_tpu_torch import config

    device = torch.device(config.get("device", "cuda"))
    if device.type != "cuda" or torch.cuda.is_available():
        buffer = buffer.to(device)
    return Persisted(buffer, chunks, pinned_name, dtype)


def _binop(fn, reflexive=False):
    def method(self, other):
        from dask_array_tpu_torch._blockwise import elemwise

        if isinstance(other, (list, tuple, np.ndarray)):
            from dask_array_tpu_torch.ops._from_array import asarray

            other = asarray(other)
        elif not isinstance(other, (Array, Number, np.generic)):
            return NotImplemented
        return elemwise(fn, other, self) if reflexive else elemwise(fn, self, other)

    return method


def _unop(fn):
    def method(self):
        from dask_array_tpu_torch._blockwise import elemwise

        return elemwise(fn, self)

    return method


# numpy's ndarray ** scalar shortcut (``fast_scalar_power``): a float or
# complex array to one of these exponents takes the unary ufunc instead
_POWER_SHORTCUTS = {1.0: torch.positive, -1.0: torch.reciprocal, 0.0: torch.ones_like, 0.5: torch.sqrt,
                    2.0: torch.square}


def _scalar_exponent(other):
    """``(value, is_float)`` of an exponent numpy's shortcut reads: a
    Python or numpy int or float, or a 0-d integer or float array; else
    None."""
    if isinstance(other, np.ndarray) and other.ndim == 0 and other.dtype.kind in "iuf":
        return float(other), other.dtype.kind == "f"
    if isinstance(other, (int, float, np.integer, np.floating)) and not isinstance(other, np.bool_):
        return float(other), isinstance(other, (float, np.floating))
    return None


_pow = _binop(torch.pow)


def _numpy_pow(self, other):
    """``self ** other`` as numpy's ndarray computes it: a bool or integer
    array squared is ``square`` (a bool array gives int8), an integer array
    to a float 2 is squared in float64, and a float or complex array to 0,
    0.5, 1, -1 or 2 takes ones_like, sqrt, positive, reciprocal or square.
    Any other exponent is ``power``."""
    from dask_array_tpu_torch._blockwise import elemwise

    exp = _scalar_exponent(other)
    if exp is not None:
        value, is_float = exp
        kind = self.dtype.kind
        if kind in "fc":
            if value in _POWER_SHORTCUTS:
                return elemwise(_POWER_SHORTCUTS[value], self)
        elif value == 2.0:
            return elemwise(torch.square, self.astype(np.float64) if kind in "iu" and is_float else self)
    return _pow(self, other)


class Array:
    __slots__ = ("_expr", "__weakref__")

    def __init__(self, expr: ArrayExpr):
        if not isinstance(expr, ArrayExpr):
            raise TypeError(f"Array() takes an ArrayExpr, got {type(expr)}")
        object.__setattr__(self, "_expr", expr)

    def __reduce__(self):
        return (Array, (self._expr,))

    def _replace_expr(self, expr: ArrayExpr):
        object.__setattr__(self, "_expr", expr)

    # -- expression / metadata ------------------------------------------------

    @property
    def expr(self) -> ArrayExpr:
        return self._expr

    @property
    def name(self) -> str:
        return self._expr._collection_name()

    @property
    def _meta(self):
        return self._expr._meta

    @property
    def dtype(self):
        return self._expr.dtype

    @property
    def shape(self):
        return self._expr.shape

    @property
    def chunks(self):
        return self._expr.chunks

    @property
    def chunksize(self):
        return self._expr.chunksize

    @property
    def ndim(self):
        return self._expr.ndim

    @property
    def size(self):
        return self._expr.size

    @property
    def nbytes(self):
        return self._expr.nbytes

    @property
    def itemsize(self):
        return self.dtype.itemsize

    @property
    def numblocks(self):
        return self._expr.numblocks

    @property
    def npartitions(self):
        return self._expr.npartitions

    @property
    def blocks(self):
        from dask_array_tpu_torch.ops._blocks import BlockAccessor

        return BlockAccessor(self)

    @property
    def vindex(self):
        from dask_array_tpu_torch.ops._fancy_indexing import VIndexAccessor

        return VIndexAccessor(self)

    @property
    def T(self):
        from dask_array_tpu_torch.ops.manipulation import transpose

        return transpose(self)

    @property
    def real(self):
        from dask_array_tpu_torch.ops.ufuncs import real

        return real(self)

    @property
    def imag(self):
        from dask_array_tpu_torch.ops.ufuncs import imag

        return imag(self)

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        if isinstance(self.shape[0], float):
            raise ValueError("Cannot call len() on array with unknown chunk sizes; call compute_chunk_sizes() first")
        return int(self.shape[0])

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an array with more than one element is ambiguous.")
        return bool(self.compute())

    def __int__(self):
        return int(self.compute())

    def __float__(self):
        return float(self.compute())

    def __repr__(self):
        return (
            f"dask_array_tpu_torch.Array<{self.name[:20]}..., shape={self.shape}, "
            f"dtype={self.dtype}, chunksize={self.chunksize}, chunks={len(self.chunks)}d>"
        )

    def pprint(self):
        self._expr.pprint()

    # -- compute --------------------------------------------------------------

    def optimize(self, fuse: bool = True) -> "Array":
        from dask_array_tpu_torch._materialize import optimize_expr

        return new_collection(optimize_expr(self._expr, fuse=fuse))

    def simplify(self) -> "Array":
        return new_collection(self._expr.simplify())

    def compute(self):
        """Optimize, execute on ``config["device"]`` and return numpy."""
        from dask_array_tpu_torch._materialize import compute_to_numpy
        from dask_array_tpu_torch._spans import compute

        out = compute(compute_to_numpy, self._expr)
        if out.ndim == 0:
            return out[()]
        return out

    def compute_device(self) -> torch.Tensor:
        """Compute and keep the result on the device (a dense tensor); a
        result the out-of-core lane streamed comes back as host numpy."""
        from dask_array_tpu_torch._materialize import compute_expr
        from dask_array_tpu_torch._spans import compute

        return compute(compute_expr, self._expr)

    def persist(self, **kwargs) -> "Array":
        """Compute and hold the result on the device as a ``Persisted``
        leaf under this collection's name.  Under a mesh a result the
        partitioned walk holds sharded stays so: a later walk under the
        same mesh binds its shards as they are."""
        from dask_array_tpu_torch._materialize import compute_expr_held
        from dask_array_tpu_torch.parallel._sharded import ShardedTensor

        from dask_array_tpu_torch import _host
        from dask_array_tpu_torch._spans import compute

        buf = compute(compute_expr_held, self._expr)
        if isinstance(buf, ShardedTensor):
            return new_collection(Persisted(buf, self.chunks, self.name, self._held_dtype()))
        if _host.is_host_block(buf):
            # a masked, duck or record result stays on the host: a leaf of it
            from dask_array_tpu_torch.ops._from_array import from_array

            return from_array(buf, chunks=self.chunks)
        if isinstance(buf, np.ndarray):
            # streamed out of core: the result stays in host memory, and
            # each later compute uploads what it reads of it
            buf = tensor_of(buf)
        if buf.device.type == "cpu" or not buf.is_contiguous():
            # a compact snapshot: a CPU result may share memory with the
            # numpy source, a view would keep its whole base alive
            buf = buf.clone(memory_format=torch.contiguous_format)
        chunks = self.chunks
        if has_unknown_chunks(chunks):
            # real shapes are now known: one chunk per formerly-unknown axis
            chunks = tuple(
                c if not any(np.isnan(x) for x in c) else (s,) for c, s in zip(chunks, buf.shape)
            )
        return new_collection(Persisted(buf, chunks, self.name, self._held_dtype()))

    def _held_dtype(self):
        """The dtype a persisted leaf records where its tensor's dtype does
        not name it: datetime ticks, a narrow type's uint8 carrier."""
        return self.dtype if self.dtype.kind in "Mm" or format_of(self.dtype) is not None else None

    def visualize(self, *args, **kwargs):
        """The expression tree as a table (``diagnostics.expr_table``)."""
        from dask_array_tpu_torch._diagnostics import expr_table

        return expr_table(self)

    def explain(self, **kwargs):
        from dask_array_tpu_torch._diagnostics import explain

        return explain(self, **kwargs)

    def to_svg(self, size=500):
        """An SVG image of the chunk grid."""
        from dask_array_tpu_torch._svg import array_svg

        return array_svg(self.chunks)

    def _repr_html_(self):
        from dask_array_tpu_torch._svg import repr_html

        return repr_html(self)

    def freeze_chunks(self) -> "Array":
        """Pin the current chunking as load-bearing: the optimizer may
        rewrite the subtree, but this collection's layout survives."""
        from dask_array_tpu_torch.ops._map_blocks import ChunksFreeze, freeze

        if type(self._expr) is ChunksFreeze:
            return self
        return new_collection(freeze(self._expr))

    def __array__(self, dtype=None, copy=None):
        out = np.asarray(self.compute())
        if dtype is not None and out.dtype != dtype:
            out = out.astype(dtype)
        return out

    # -- numpy protocol interop ---------------------------------------------------

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        from dask_array_tpu_torch.ops.ufuncs import wrap_numpy_ufunc

        if method != "__call__" or kwargs.get("out") is not None:
            return NotImplemented
        if ufunc is np.matmul:
            from dask_array_tpu_torch.ops.linalg import matmul

            return matmul(*inputs)
        f = wrap_numpy_ufunc(ufunc)
        if f is None:
            return NotImplemented
        return f(*inputs, **kwargs)

    def __array_function__(self, func, types, args, kwargs):
        from dask_array_tpu_torch._dispatch import lookup_array_function

        impl = lookup_array_function(func)
        if impl is None:
            return NotImplemented
        return impl(*args, **kwargs)

    # -- indexing ---------------------------------------------------------------

    def __getitem__(self, index):
        from dask_array_tpu_torch.ops._getitem import getitem_router

        return getitem_router(self, index)

    def __setitem__(self, index, value):
        """numpy's assignment, as a new expression for this collection (the
        values it was built from are not changed)."""
        from dask_array_tpu_torch.ops._setitem import setitem

        self._replace_expr(setitem(self, index, value).expr)

    def compute_chunk_sizes(self):
        """Compute the unknown (nan) chunk sizes, in place (returns self).

        The block grid is kept: each unknown chunk takes the size of its
        computed block, and the blocks stay on the device as the leaves of
        the new expression (``ops/_blocks.py::from_blocks``).  A root that
        assembled densely is one block along its unknown axes."""
        if not has_unknown_chunks(self.chunks):
            return self
        from dask_array_tpu_torch._executor import execute_views
        from dask_array_tpu_torch._materialize import optimize_expr
        from dask_array_tpu_torch.ops._blocks import from_blocks

        view = execute_views([optimize_expr(self._expr)])[0]
        if view._blocks is None:
            dense = view.dense()
            out = from_blocks({(0,) * dense.ndim: dense}, tuple((s,) for s in dense.shape))
            known = tuple(c if not any(isinstance(x, float) for x in c) else (s,)
                          for c, s in zip(self.chunks, dense.shape))
            out = out.rechunk(known)
        else:
            blocks = view.blocks_dict()
            nb = view.numblocks
            chunks = tuple(
                tuple(int(blocks[tuple(i if d == ax else 0 for d in range(len(nb)))].shape[ax]) for i in range(nb[ax]))
                for ax in range(len(nb))
            )
            out = from_blocks(blocks, chunks)
        self._replace_expr(out.expr)
        return self

    # -- operators ---------------------------------------------------------------

    __add__ = _binop(torch.add)
    __radd__ = _binop(torch.add, reflexive=True)
    __sub__ = _binop(torch.sub)
    __rsub__ = _binop(torch.sub, reflexive=True)
    __mul__ = _binop(torch.mul)
    __rmul__ = _binop(torch.mul, reflexive=True)
    __truediv__ = _binop(torch.true_divide)
    __rtruediv__ = _binop(torch.true_divide, reflexive=True)
    __floordiv__ = _binop(floor_divide_)
    __rfloordiv__ = _binop(floor_divide_, reflexive=True)
    __mod__ = _binop(remainder_)
    __rmod__ = _binop(remainder_, reflexive=True)
    __pow__ = _numpy_pow
    __rpow__ = _binop(torch.pow, reflexive=True)
    __lt__ = _binop(less_)
    __le__ = _binop(less_equal_)
    __gt__ = _binop(greater_)
    __ge__ = _binop(greater_equal_)
    __eq__ = _binop(torch.eq)
    __ne__ = _binop(torch.ne)
    __and__ = _binop(torch.bitwise_and)
    __rand__ = _binop(torch.bitwise_and, reflexive=True)
    __or__ = _binop(torch.bitwise_or)
    __ror__ = _binop(torch.bitwise_or, reflexive=True)
    __xor__ = _binop(torch.bitwise_xor)
    __rxor__ = _binop(torch.bitwise_xor, reflexive=True)
    __lshift__ = _binop(torch.bitwise_left_shift)
    __rlshift__ = _binop(torch.bitwise_left_shift, reflexive=True)
    __rshift__ = _binop(torch.bitwise_right_shift)
    __rrshift__ = _binop(torch.bitwise_right_shift, reflexive=True)
    __neg__ = _unop(torch.neg)
    __abs__ = _unop(absolute_)
    __invert__ = _unop(torch.bitwise_not)

    def __matmul__(self, other):
        from dask_array_tpu_torch.ops.linalg import matmul

        return matmul(self, other)

    def __rmatmul__(self, other):
        from dask_array_tpu_torch.ops.linalg import matmul

        return matmul(other, self)

    def __pos__(self):
        return self

    def __hash__(self):
        return hash(self.name)

    def __divmod__(self, other):
        return (self // other, self % other)

    # -- methods (delegate to op modules) -------------------------------------------

    def astype(self, dtype):
        from dask_array_tpu_torch.ops._casting import astype_expr

        return new_collection(astype_expr(self._expr, dtype))

    def rechunk(self, chunks="auto", threshold=None, block_size_limit=None, balance=False):
        from dask_array_tpu_torch._rechunk import rechunk

        return rechunk(self, chunks, threshold=threshold, block_size_limit=block_size_limit, balance=balance)

    def transpose(self, *axes):
        from dask_array_tpu_torch.ops.manipulation import transpose

        if not axes:
            axes = None
        elif len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = axes[0]
        return transpose(self, axes)

    def reshape(self, *shape, merge_chunks=True, limit=None, order="C"):
        from dask_array_tpu_torch.ops._reshape import reshape

        if order not in (None, "C"):
            raise NotImplementedError(f"reshape(order={order!r}) is not supported")
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = shape[0]
        return reshape(self, shape, merge_chunks=merge_chunks, limit=limit)

    def ravel(self):
        from dask_array_tpu_torch.ops._reshape import ravel

        return ravel(self)

    def flatten(self):
        return self.ravel()

    def squeeze(self, axis=None):
        from dask_array_tpu_torch.ops.manipulation import squeeze

        return squeeze(self, axis)

    def swapaxes(self, axis1, axis2):
        from dask_array_tpu_torch.ops.manipulation import swapaxes

        return swapaxes(self, axis1, axis2)

    def copy(self):
        return new_collection(self._expr)

    # -- IO (io/) ----------------------------------------------------------

    def store(self, targets, **kwargs):
        from dask_array_tpu_torch.io._store import store

        return store(self, targets, **kwargs)

    def to_zarr(self, *args, **kwargs):
        from dask_array_tpu_torch.io._zarr import to_zarr

        return to_zarr(self, *args, **kwargs)

    def to_hdf5(self, filename, datapath, **kwargs):
        from dask_array_tpu_torch.io._store import to_hdf5

        return to_hdf5(filename, datapath, self, **kwargs)

    def to_tiledb(self, uri, *args, **kwargs):
        from dask_array_tpu_torch.io._tiledb import to_tiledb

        return to_tiledb(self, uri, *args, **kwargs)

    def to_delayed(self, optimize_graph=True):
        """An object array of one ``Delayed`` handle per block."""
        import itertools

        from dask_array_tpu_torch.io._from_map import Delayed

        out = np.empty(self.numblocks, dtype=object)
        for idx in itertools.product(*(range(n) for n in self.numblocks)):
            out[idx] = Delayed(self.blocks[idx].compute)
        return out

    def repeat(self, repeats, axis=None):
        from dask_array_tpu_torch.ops.creation import repeat

        return repeat(self, repeats, axis=axis)

    def shuffle(self, indexer, axis=0, chunks="auto"):
        from dask_array_tpu_torch._shuffle import shuffle

        return shuffle(self, indexer, axis=axis, chunks=chunks)

    def topk(self, k, axis=-1, split_every=None):
        from dask_array_tpu_torch.ops.routines import topk

        return topk(self, k, axis=axis, split_every=split_every)

    def argtopk(self, k, axis=-1, split_every=None):
        from dask_array_tpu_torch.ops.routines import argtopk

        return argtopk(self, k, axis=axis, split_every=split_every)

    def round(self, decimals=0):
        from dask_array_tpu_torch.ops.routines import round as _round

        return _round(self, decimals)

    def clip(self, min=None, max=None):
        from dask_array_tpu_torch.ops.ufuncs import clip

        return clip(self, min, max)

    def conj(self):
        from dask_array_tpu_torch.ops.ufuncs import conj

        return conj(self)

    def choose(self, choices):
        from dask_array_tpu_torch.ops.routines import choose

        return choose(self, choices)

    def nonzero(self):
        from dask_array_tpu_torch.ops.routines import nonzero

        return nonzero(self)

    def item(self):
        return self.compute().item()

    def tolist(self):
        return np.asarray(self.compute()).tolist()

    def map_blocks(self, func, *args, **kwargs):
        from dask_array_tpu_torch.ops._map_blocks import map_blocks

        return map_blocks(func, self, *args, **kwargs)

    def map_overlap(self, func, depth, boundary=None, trim=True, **kwargs):
        from dask_array_tpu_torch.ops._overlap import map_overlap

        return map_overlap(func, self, depth=depth, boundary=boundary, trim=trim, **kwargs)

    def dot(self, other):
        from dask_array_tpu_torch.ops.linalg import dot

        return dot(self, other)

    def trace(self, offset=0, axis1=0, axis2=1, dtype=None):
        from dask_array_tpu_torch.ops.reductions import trace

        return trace(self, offset=offset, axis1=axis1, axis2=axis2, dtype=dtype)

    # -- reductions -------------------------------------------------------------------

    def sum(self, axis=None, dtype=None, keepdims=False, split_every=None, out=None):
        from dask_array_tpu_torch.ops.reductions import sum as _sum

        return _sum(self, axis=axis, dtype=dtype, keepdims=keepdims, split_every=split_every, out=out)

    def prod(self, axis=None, dtype=None, keepdims=False, split_every=None, out=None):
        from dask_array_tpu_torch.ops.reductions import prod as _prod

        return _prod(self, axis=axis, dtype=dtype, keepdims=keepdims, split_every=split_every, out=out)

    def mean(self, axis=None, dtype=None, keepdims=False, split_every=None, out=None):
        from dask_array_tpu_torch.ops.reductions import mean as _mean

        return _mean(self, axis=axis, dtype=dtype, keepdims=keepdims, split_every=split_every, out=out)

    def std(self, axis=None, dtype=None, keepdims=False, ddof=0, split_every=None, out=None):
        from dask_array_tpu_torch.ops.reductions import std as _std

        return _std(self, axis=axis, dtype=dtype, keepdims=keepdims, ddof=ddof, split_every=split_every, out=out)

    def var(self, axis=None, dtype=None, keepdims=False, ddof=0, split_every=None, out=None):
        from dask_array_tpu_torch.ops.reductions import var as _var

        return _var(self, axis=axis, dtype=dtype, keepdims=keepdims, ddof=ddof, split_every=split_every, out=out)

    def min(self, axis=None, keepdims=False, split_every=None, out=None):
        from dask_array_tpu_torch.ops.reductions import min as _min

        return _min(self, axis=axis, keepdims=keepdims, split_every=split_every, out=out)

    def max(self, axis=None, keepdims=False, split_every=None, out=None):
        from dask_array_tpu_torch.ops.reductions import max as _max

        return _max(self, axis=axis, keepdims=keepdims, split_every=split_every, out=out)

    def any(self, axis=None, keepdims=False, split_every=None, out=None):
        from dask_array_tpu_torch.ops.reductions import any as _any

        return _any(self, axis=axis, keepdims=keepdims, split_every=split_every, out=out)

    def all(self, axis=None, keepdims=False, split_every=None, out=None):
        from dask_array_tpu_torch.ops.reductions import all as _all

        return _all(self, axis=axis, keepdims=keepdims, split_every=split_every, out=out)

    def view(self, dtype=None, order="C"):
        from dask_array_tpu_torch.ops._view import view

        return view(self, dtype, order)

    def argmin(self, axis=None, keepdims=False, split_every=None, out=None):
        from dask_array_tpu_torch.ops.reductions import argmin as _argmin

        return _argmin(self, axis=axis, keepdims=keepdims, split_every=split_every, out=out)

    def argmax(self, axis=None, keepdims=False, split_every=None, out=None):
        from dask_array_tpu_torch.ops.reductions import argmax as _argmax

        return _argmax(self, axis=axis, keepdims=keepdims, split_every=split_every, out=out)

    def cumsum(self, axis=None, dtype=None, method="sequential", out=None):
        from dask_array_tpu_torch.ops.reductions import cumsum as _cumsum

        return _cumsum(self, axis=axis, dtype=dtype, method=method, out=out)

    def cumprod(self, axis=None, dtype=None, method="sequential", out=None):
        from dask_array_tpu_torch.ops.reductions import cumprod as _cumprod

        return _cumprod(self, axis=axis, dtype=dtype, method=method, out=out)

    def moment(self, order, axis=None, dtype=None, keepdims=False, ddof=0, split_every=None, out=None):
        from dask_array_tpu_torch.ops.reductions import moment as _moment

        return _moment(self, order, axis=axis, dtype=dtype, keepdims=keepdims, ddof=ddof, split_every=split_every, out=out)
