"""Rechunk: change the block layout of an array.

Port of ``dask_array_tpu/_rechunk.py``.  A rechunk is a layout boundary:
on one device the dense tensor is unchanged and only its logical block
structure moves (consumers that want blocks slice views out of it).  Under
a mesh the boundary executes in the partitioned walk
(``parallel/partition.py``): the shards move to the new grid's layout,
through the explicit collective schedule of
``parallel.collectives.mesh_collective_relayout`` (one ``all_to_all`` a
moving mesh axis) where they are under the old grid's, and are handed on
as they are.  The planner-level pushdowns (rechunk
through IO/elemwise/transpose, no-op elision, rechunk∘rechunk collapse)
happen at expression level.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from dask_array_tpu_torch._chunks import common_blockdim, normalize_chunks
from dask_array_tpu_torch._executor import BlockView
from dask_array_tpu_torch._expr import ArrayExpr, lowering_shared_names


class Rechunk(ArrayExpr):
    takes_narrow = True

    _parameters = ("array", "target_chunks")
    _pushdown_gate = "_rechunk_pushdown"

    @functools.cached_property
    def chunks(self):
        return self.target_chunks

    @property
    def _meta(self):
        return self.array._meta

    def _simplify_down(self):
        if self.target_chunks == self.array.chunks:
            return self.array
        return None

    def _accept_rechunk(self, target_chunks):
        # Rechunk∘Rechunk collapses to one relayout (through the sharing
        # gate: a SHARED inner rechunk stays)
        return Rechunk(self.array, target_chunks)

    @property
    def _lower_cache_key(self):
        # the lower rewrite depends on whether the child is shared
        if self.array._name in lowering_shared_names():
            return f"{self._name}|shared-child"
        return self._name

    def _lower(self):
        # let the child absorb the rechunk (IO leaves, creation) — but never
        # a child another parent consumes: that would read the source once
        # per layout
        if self.array._name in lowering_shared_names():
            return None
        return self.array._accept_rechunk(self.target_chunks)

    def _build(self, ctx):
        # the dense tensor is unchanged; under a mesh the partition rule
        # (``parallel/partition.py``) moves the shards instead
        return BlockView(self.chunks, dense=ctx.build(self.array).dense())

    def transfer_bytes(self):
        """Between-block movement estimate: (min, max) bytes.  min: only
        the misaligned fraction moves; max: the whole array once."""
        nb = self.array.nbytes
        if isinstance(nb, float) and math.isnan(nb):
            return (0, 0)
        moved = _moved_fraction(self.array.chunks, self.target_chunks)
        return (int(round(nb * moved)), int(nb))


def _axis_moved_fraction(src, dst):
    """Fraction of one axis's elements a src->dst relayout moves.

    Min-model: each destination chunk is assembled where its largest
    single-source piece lives; that piece stays put, the rest travels to
    join it.  Splits are free, merges move everything but the largest run
    member, jittered layouts move only boundary-crossing slivers.
    """
    src = tuple(src)
    dst = tuple(dst)
    total = sum(src)
    if not total or src == dst:
        return 0.0
    if any(isinstance(c, float) and math.isnan(c) for c in src + dst):
        return 0.0
    if sum(dst) != total:
        return 0.0
    if len(src) + len(dst) > 256:
        from dask_array_tpu_torch import native

        out = native.moved_fraction_axis(src, dst)
        if out is not None:
            return out
    moved = 0.0
    i = 0
    src_lo = 0
    dst_lo = 0
    for d in dst:
        dst_hi = dst_lo + d
        best = 0
        while True:
            src_hi = src_lo + src[i]
            overlap = min(src_hi, dst_hi) - max(src_lo, dst_lo)
            if overlap > best:
                best = overlap
            if src_hi <= dst_hi and i + 1 < len(src):
                i += 1
                src_lo = src_hi
            else:
                break
        moved += d - best
        dst_lo = dst_hi
    return moved / total


def _moved_fraction(old, new):
    """Fraction of elements whose block assignment changes: an element
    stays only if it stays along every axis."""
    stay = 1.0
    for o, n in zip(old, new):
        stay *= 1.0 - _axis_moved_fraction(o, n)
    return 1.0 - stay


def rechunk(x, chunks="auto", threshold=None, block_size_limit=None, balance=False):
    """Change the chunking of ``x`` (values unchanged)."""
    from dask_array_tpu_torch._collection import Array, new_collection

    expr = x.expr if isinstance(x, Array) else x
    if isinstance(chunks, dict):
        # axes not named keep their existing chunks; negative keys count
        # from the end (dask semantics)
        by_axis = {}
        for k, v in chunks.items():
            ax = k + expr.ndim if k < 0 else k
            if not 0 <= ax < expr.ndim:
                raise ValueError(f"rechunk axis {k} out of range for {expr.ndim}-d array")
            by_axis[ax] = v
        chunks = tuple(by_axis.get(ax, expr.chunks[ax]) for ax in range(expr.ndim))
    if isinstance(chunks, (tuple, list)) and len(chunks) == expr.ndim:
        # None per axis means "keep existing chunks"
        chunks = tuple(expr.chunks[ax] if c is None else c for ax, c in enumerate(chunks))
    norm = normalize_chunks(
        chunks, expr.shape, limit=block_size_limit, dtype=expr.dtype, previous_chunks=expr.chunks
    )
    if balance:
        norm = tuple(_balance_axis(c) for c in norm)
    if norm == expr.chunks:
        return new_collection(expr)
    return new_collection(Rechunk(expr, norm))


def _balance_axis(c):
    """Even out a chunk tuple (same count, sizes differ by <=1)."""
    total = sum(c)
    n = len(c)
    if n == 0 or any(isinstance(x, float) and math.isnan(x) for x in c):
        return tuple(c)
    base = total // n
    rem = total - base * n
    return tuple(base + (1 if i < rem else 0) for i in range(n))


# ---------------------------------------------------------------------------
# chunk-intersection algebra and multi-stage planning
# ---------------------------------------------------------------------------


def old_to_new(old_chunks, new_chunks):
    """For each axis, for each new block: list of (old_block, slice) pieces.
    Long axes take the native plankit expansion."""
    out = []
    for o, n in zip(old_chunks, new_chunks):
        if len(o) + len(n) > 512:
            from dask_array_tpu_torch import native

            res = native.old_to_new_axis(o, n)
            if res is not None:
                offsets, p_old, p_lo, p_hi = res
                out.append([
                    [(int(p_old[k]), slice(int(p_lo[k]), int(p_hi[k]))) for k in range(offsets[j], offsets[j + 1])]
                    for j in range(len(n))
                ])
                continue
        o_bounds = np.cumsum([0] + list(o))
        axis = []
        pos = 0
        ob = 0
        for size in n:
            lo, hi = pos, pos + size
            pieces = []
            while ob < len(o) and o_bounds[ob + 1] <= lo:
                ob += 1
            b = ob
            while b < len(o) and o_bounds[b] < hi:
                s = max(lo, o_bounds[b]) - o_bounds[b]
                e = min(hi, o_bounds[b + 1]) - o_bounds[b]
                pieces.append((b, slice(int(s), int(e))))
                b += 1
            axis.append(pieces)
            pos = hi
        out.append(axis)
    return out


def _stage_degree(old, new):
    """Max number of old blocks feeding one new block along any axis."""
    deg = 1
    for o, n in zip(old, new):
        if len(o) + len(n) > 256 and not any(
            isinstance(c, float) and math.isnan(c) for c in tuple(o) + tuple(n)
        ):
            from dask_array_tpu_torch import native

            d = native.stage_degree_axis(o, n)
            if d is not None:
                deg = max(deg, d)
                continue
        mapping = old_to_new((o,), (n,))[0]
        deg = max(deg, max((len(pieces) for pieces in mapping), default=1))
    return deg


def plan_rechunk(old_chunks, new_chunks, itemsize=8, threshold=None, block_size_limit=None):
    """Plan intermediate chunk layouts for a rechunk.

    Bounds the fan-in degree per stage: stage 1 is the per-axis boundary
    union (every old->mid edge a pure split); later stages merge at most
    ``threshold`` consecutive pieces per target chunk.  Returns a list of
    chunk layouts ending with ``new_chunks``.
    """
    from dask_array_tpu_torch import config

    if threshold is None:
        threshold = config.get("array.rechunk.threshold", 32)
    if _stage_degree(old_chunks, new_chunks) <= threshold:
        return [new_chunks]
    mid = tuple(
        common_blockdim([tuple(o), tuple(n)]) if tuple(o) != tuple(n) else tuple(o)
        for o, n in zip(old_chunks, new_chunks)
    )
    if mid == new_chunks:
        return [new_chunks]  # pure split: every gather has width 1
    stages = [] if mid == old_chunks else [mid]
    cur = mid
    for _ in range(64):
        if cur == new_chunks:
            break
        nxt_axes = []
        for o_ax, n_ax in zip(cur, new_chunks):
            o_ax, n_ax = tuple(o_ax), tuple(n_ax)
            if o_ax == n_ax:
                nxt_axes.append(o_ax)
                continue
            out = []
            i = 0
            for tgt in n_ax:
                run = []
                s = 0
                while s < tgt and i < len(o_ax):
                    run.append(o_ax[i])
                    s += o_ax[i]
                    i += 1
                if len(run) <= threshold:
                    out.append(tgt)
                else:
                    for g in range(0, len(run), threshold):
                        out.append(sum(run[g : g + threshold]))
            nxt_axes.append(tuple(out))
        nxt = tuple(nxt_axes)
        if nxt == cur:
            break  # cannot make progress (irregular boundary); stop safely
        stages.append(nxt)
        cur = nxt
    if stages[-1] != new_chunks:
        stages.append(new_chunks)
    return stages
