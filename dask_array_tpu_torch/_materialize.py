"""The optimize -> execute choke point.

Port of ``dask_array_tpu/_materialize.py``: optimize the expression tree
(simplify -> lower -> fuse) and hand it to the executor.  Before the
optimizer, the reductions that the multi-statistic kernel computes in one
read are routed to it (``ops/_multistat.py``), across every array
computed together.
"""

from __future__ import annotations

import functools

import numpy as np

from dask_array_tpu_torch import config
from dask_array_tpu_torch._chunks import array_of, format_of
from dask_array_tpu_torch._executor import check_masked_ops, execute_many, execute_views
from dask_array_tpu_torch._expr import ArrayExpr
from dask_array_tpu_torch._hostcopy import fetch
from dask_array_tpu_torch._spans import COUNTS, call, compute


def optimize_expr(expr: ArrayExpr, fuse: bool = True) -> ArrayExpr:
    """Optimize with a per-expression memo keyed on the config epoch, so
    repeated computes of one collection skip the optimizer walk."""
    return call("optimize", _optimize_expr, expr, fuse)


def _optimize_expr(expr: ArrayExpr, fuse: bool) -> ArrayExpr:
    opt_flag = config.get("array.optimize-graph", True)
    key = (fuse, bool(opt_flag), config.epoch())
    cached = getattr(expr, "_opt_memo", None)
    if cached is not None and cached[0] == key:
        COUNTS["optimize_memo_hits"] += 1
        return _from_memo(expr, cached[1])
    COUNTS["optimize_runs"] += 1
    if not opt_flag:
        out = expr.lower_completely()
    else:
        from dask_array_tpu_torch.ops._multistat import fuse_multi_stat

        out = fuse_multi_stat([expr])[0].optimize(fuse=fuse)
    memo = _to_memo(expr, out)
    if memo is not _NO_MEMO:
        expr._opt_memo = (key, memo)
    return out


_NO_MEMO = object()


def _to_memo(expr: ArrayExpr, out: ArrayExpr):
    """What ``expr``'s optimize memo keeps of ``out``: never a graph that
    holds ``expr``.  That reference cycle would keep the leaves (a
    persisted tensor, computed blocks) on the card after the last
    collection that names them is dropped, until a garbage collection.
    None stands for ``expr`` itself, ``("fused", n)`` for
    ``FusedBlockwise(expr, n)``; any other graph that holds ``expr`` is not
    memoized."""
    from dask_array_tpu_torch._blockwise import FusedBlockwise

    if out is expr:
        return None
    if type(out) is FusedBlockwise and out.root is expr:
        return ("fused", out.n_fused)
    if any(node is expr for node in out.walk()):
        return _NO_MEMO
    return out


def _from_memo(expr: ArrayExpr, memo):
    from dask_array_tpu_torch._blockwise import FusedBlockwise

    if memo is None:
        return expr
    if isinstance(memo, tuple):
        return FusedBlockwise(expr, memo[1])
    return memo


def compute_expr(expr: ArrayExpr, optimize: bool = True):
    """Optimize + execute; returns the dense tensor on ``config["device"]``,
    or a host numpy array where the out-of-core lane answered
    (``_streaming.maybe_stream``: such a result may itself exceed the
    card's memory)."""
    out = _root_view(expr, optimize)
    return out if isinstance(out, np.ndarray) else out.dense()


def compute_expr_held(expr: ArrayExpr):
    """``compute_expr``, except that a result the partitioned walk holds
    sharded under a mesh comes back as its ``ShardedTensor`` (``persist``
    keeps it so)."""
    from dask_array_tpu_torch.parallel._sharded import ShardedView

    out = _root_view(expr, True)
    if isinstance(out, np.ndarray):
        return out
    return out.sharded if isinstance(out, ShardedView) else out.dense()


def _root_view(expr: ArrayExpr, optimize: bool):
    """The root's view from the executor, or the streamed host result."""
    check_masked_ops(expr)  # on the logical tree: MapBlocks is still itself
    if optimize:
        from dask_array_tpu_torch._streaming import maybe_stream

        streamed = maybe_stream(expr)
        if streamed is not None:
            return streamed
    lowered = optimize_expr(expr) if optimize else expr
    return execute_views([lowered])[0]


def compute_exprs(exprs) -> list:
    """Optimize several expressions together and execute them in one walk;
    returns their dense tensors on ``config["device"]``."""
    for e in exprs:
        check_masked_ops(e)
    if config.get("array.optimize-graph", True):
        from dask_array_tpu_torch.ops._multistat import fuse_multi_stat

        exprs = fuse_multi_stat(exprs)
    return execute_many([optimize_expr(e) for e in exprs])


def to_numpy(out, expr: ArrayExpr) -> np.ndarray:
    """The computed value as numpy.  A CUDA tensor comes back through the
    pinned ring into a new pageable array (``_hostcopy.fetch``); a host
    array (an object payload of ``store(load_stored=False)``, a streamed
    result, a masked array) passes as it is, and so does a block of a
    registered duck type.  A datetime64/timedelta64 result comes back from
    its int64 ticks in the unit the metadata records, a narrow type's
    (``_narrow``) from its uint8 patterns."""
    from dask_array_tpu_torch._dispatch import is_duck_chunk

    if is_duck_chunk(out):
        return out
    if isinstance(out, (np.ndarray, np.generic)):
        arr = out if isinstance(out, np.ndarray) else np.asarray(out)
    elif out.device.type == "cuda":
        arr = fetch(out.detach())
    else:
        arr = array_of(out.detach())
    if expr.dtype.kind in "Mm" and arr.dtype == np.int64:
        arr = arr.view(expr.dtype)
    elif arr.dtype == np.uint8 and format_of(expr.dtype) is not None:
        arr = arr.view(expr.dtype)  # a narrow type's carrier
    if arr.dtype != expr.dtype:
        raise TypeError(f"computed {arr.dtype} where the metadata says {expr.dtype}")
    return arr


def compute_to_numpy(expr: ArrayExpr) -> np.ndarray:
    return to_numpy(compute_expr(expr), expr)


class Barrier(ArrayExpr):
    """A program split point: the subtree below computes in its own walk
    (optimized on its own) and feeds the parent as a leaf tensor on the
    device.  No slice or rechunk is pushed through it."""

    takes_narrow = True

    _parameters = ("array",)

    # the subtree below is covered by this node's buffer: leaf collection
    # does not descend into it
    _leaf_stop = True

    @property
    def chunks(self):
        return self.array.chunks

    @property
    def _meta(self):
        return self.array._meta

    @functools.cached_property
    def _leaf_key(self):
        return f"barrier-{self._name}"

    def _leaf_buffers(self):
        buf = getattr(self, "_cached_buffer", None)
        if buf is None:
            buf = self._cached_buffer = compute(compute_expr, self.array)
        yield (self._leaf_key, buf)

    def _structural_operands(self):
        from dask_array_tpu_torch._chunks import dtype_key

        return [("buf", dtype_key(self.dtype)), self.chunks]

    def _build(self, ctx):
        from dask_array_tpu_torch._executor import BlockView

        return BlockView(self.chunks, dense=ctx.leaf(self._leaf_key))


def barrier(x):
    """Split the computation here: everything below runs as a walk of its
    own whose result feeds the rest as a tensor on the device."""
    from dask_array_tpu_torch._collection import Array, new_collection

    expr = x.expr if isinstance(x, Array) else x
    return new_collection(Barrier(expr))
