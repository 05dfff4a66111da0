"""Per-block shard lane: irregular chunk grids as per-slot programs.

Port of ``dask_array_tpu/parallel/shardlane.py``.  The planner (``_plan``
and its helpers, ``ENGAGED``, the decline matrix) is the JAX package's,
unchanged.  The executors are rewritten as per-slot programs: where the
JAX package stacks padded blocks on a leading axis and runs one
``shard_map`` body, this port gives each mesh slot its **pieces**, unpadded
(a one-axis grid: the slot's contiguous run of ``kpad / ndev`` row blocks,
the JAX package's block -> device assignment; a two-axis grid: its blocks,
flattened row-major), evaluates the program on each piece with the port's
own node builds (``BuildContext`` seeded with the piece's leaf tensors, so
dtype rules, the scale kernel and the host lane are the walk's), and splits
the body into phases at each collective:

  * reductions reduce each piece, combine a slot's pieces locally and
    combine slots with ONE ``psum``/``pmin``/``pmax`` (a typed combine: the
    same reduction over the stacked partials); no ``all_gather``;
  * scans along a chunked axis run the two-phase Blelloch schedule: a local
    scan a piece, one ``all_gather`` of the per-piece totals, a local carry;
  * arg-extremum reductions vote with global indices (extremum, NaN
    presence, first index: one collective each);
  * 2-D matmul terminals run ``torch.einsum`` a slot: rows chunked -> the
    rhs replicated whole, no collective; contraction chunked -> partial
    products and ONE ``psum``; column-parallel -> roles swapped;
  * halo stencils exchange each slot run's edge bands with ONE ``ppermute``
    each way (two more for a periodic wrap), then run the stencil once a
    slot: the band-stencil kernel where ``kernels.stencil.stencil_taps``
    takes the func, linear or a program (the gate ``map_overlap``'s route
    takes too), the halo kernel and the func otherwise.

No padding means no validity mask: the JAX package's ``_masked_combine``
shrinks to the NaN and arg-extremum votes.  A piece's values are the
walk's; a slot with no blocks sits out.  The output is gathered to the
mesh's first slot (one ``gather``) unless it is replicated.

Route differences from the JAX package: the executor offers every program
to the lane under ``"execution-lane": "auto"`` (the port has no GSPMD
partitioner, so regular grids engage too, and the JAX package's
``_auto_worthwhile`` has no counterpart), and an error while a lane
program executes propagates.
The lane declines leaves whose blocks have no device form (masked,
object, record, duck and datetime blocks stay on their lanes), and any
program with narrow data (``_chunks.is_narrow``), whose per-slot parts
its typed combines would order as bit patterns or round once a part.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from dask_array_tpu_torch._chunks import is_narrow

#: engagement counter for tests (incremented on every lane execution)
ENGAGED = {"count": 0}

_REDUCE_IDENT = {
    "sum": 0.0,
    "prod": 1.0,
    "min": np.inf,
    "max": -np.inf,
    "mean": 0.0,
    # nan variants combine cross-device with their own masking (padding ->
    # NaN / 0); listed here so the plan gate admits them
    "nansum": 0.0,
    "nanmean": 0.0,
    "nanmin": np.inf,
    "nanmax": -np.inf,
    # truth reductions: padding fills falsy/truthy, combine is pmax/pmin
    "any": False,
    "all": True,
}

#: kinds the lane can execute at all (nanprod joins only block-locally)
_LANE_KINDS = tuple(_REDUCE_IDENT) + ("nanprod",)


def _two_byte_float(dtype) -> bool:
    """float16 or bfloat16: the dense walk adds these in float32 and rounds
    once, and scans them with K3 (``kernels/scan.py``), rounding at every
    step."""
    from dask_array_tpu_torch._chunks import is_float_dtype

    return is_float_dtype(dtype) and np.dtype(dtype).itemsize == 2


def _scan_declines(scan, dims) -> bool:
    """A 2-byte float scan along a chunked axis: no per-piece carry can
    round at every step as the dense walk does, so the lane declines it."""
    return scan.axis in dims and _two_byte_float(scan.dtype)


def _reduce_ident(kind, dtype):
    """The identity of ``kind`` IN ``dtype`` (padding fill value): ±inf
    maps to the integer extrema for int dtypes, True/False for bool."""
    dtype = np.dtype(dtype)
    if kind in ("sum", "mean"):
        return np.zeros((), dtype)[()]
    if kind == "prod":
        return np.ones((), dtype)[()]
    if dtype.kind in "iu":
        info = np.iinfo(dtype)
        return info.max if kind == "min" else info.min
    if dtype.kind == "b":
        return kind == "min"
    return np.inf if kind == "min" else -np.inf


def _unwrap(expr):
    while type(expr).__name__ == "FusedBlockwise":
        expr = expr.root
    return expr



def _walk_elem(node, leaves, seen, reds=None, consts=None, scans=None):
    """Walk an elemwise tree down to FromArray leaves; False = decline.

    With ``reds``/``consts`` lists supplied the walk also admits:

    * INNER ``Reduction`` nodes (collected into ``reds``) whose own
      subtree is an elemwise tree over the same leaves — their results
      are replicated inside the per-slot program (one collective each)
      and broadcast back into the outer tree.  This is what makes
      ``x.var()``, ``x.std()`` and ``(x - x.mean()) / x.std()`` ONE
      lane program.  Axis/shape gates run later, once the grid is known.
    * 0-d subtrees of any other kind (collected into ``consts``) —
      evaluated host-side through the regular executor at plan time
      (e.g. the one-pass variance's ``x[0, 0]`` shift element).

    With a ``scans`` list supplied (the r5 multi-terminal widening) the
    walk also admits INNER ``CumReduction`` nodes: a scan preserves
    shape, so its result stays BLOCK-ALIGNED with the stacked leaves and
    feeds the outer tree in place — no broadcast, no extra collective
    beyond the scan's own Blelloch phase.  ``cumsum(x)*2+1``,
    ``(x - cumsum(x)).sum()`` and scan-of-scan pipelines become ONE lane
    program.  Scan subtrees may hold inner reds/consts (evaluated
    first); reduction subtrees stay scan-free, keeping the evaluation
    order acyclic (reds -> scans innermost-first -> outer tree).
    """
    from dask_array_tpu_torch._expr import ArrayExpr
    from dask_array_tpu_torch.ops._from_array import FromArray

    node = _unwrap(node)
    if isinstance(node, FromArray):
        if node._name not in seen:
            seen.add(node._name)
            leaves.append(node)
        return True
    if type(node).__name__ == "Elemwise":
        for a in node.args:
            if isinstance(a, ArrayExpr) and not _walk_elem(
                a, leaves, seen, reds, consts, scans
            ):
                return False
        return True
    if scans is not None:
        from dask_array_tpu_torch.ops.reductions import CumReduction

        if (
            isinstance(node, CumReduction)
            and node.kind in ("cumsum", "cumprod")
            and np.dtype(node.dtype).kind not in "Mm"
        ):
            if node._name in seen:
                return True
            sub_leaves, sub_reds, sub_consts = [], [], []
            sub_seen = set(seen)
            if not _walk_elem(
                node.array, sub_leaves, sub_seen, sub_reds, sub_consts,
                scans,
            ):
                return False
            if reds is None and sub_reds:
                return False  # caller forbids inner reductions
            seen.update(sub_seen)
            leaves.extend(sub_leaves)
            if reds is not None:
                reds.extend(sub_reds)
            consts.extend(sub_consts)
            seen.add(node._name)
            scans.append(node)
            return True
    if reds is not None:
        from dask_array_tpu_torch.ops.reductions import Reduction

        if (
            isinstance(node, Reduction)
            and node.kind in _REDUCE_IDENT
            and node.kind != "prod"
        ):
            # scratch collections: a failed subtree gate must not leave
            # stray leaves behind when the node salvages as a 0-d const
            sub_leaves, sub_consts, sub_seen = [], [], set(seen)
            if _walk_elem(node.array, sub_leaves, sub_seen, None, sub_consts):
                # sub_seen started from seen, so these are all new
                seen.update(sub_seen)
                leaves.extend(sub_leaves)
                consts.extend(sub_consts)
                if node._name not in seen:
                    seen.add(node._name)
                    reds.append(node)
                return True
    if consts is not None and node.shape == ():
        if node._name not in seen:
            seen.add(node._name)
            consts.append(node)
        return True
    return False


def _leaf_grid_ok2(leaves):
    """Shared, known, unmasked leaf grid chunked along exactly TWO axes
    — or ``None``.  Returns ``(grid, (d1, d2))`` with ``d1 < d2``."""
    if not leaves:
        return None
    grid = leaves[0].chunks
    if any(l.chunks != grid for l in leaves):
        return None
    chunked = [ax for ax, c in enumerate(grid) if len(c) != 1]
    if len(chunked) != 2:
        return None
    if any(isinstance(h, float) and math.isnan(h) for c in grid for h in c):
        return None
    if any(sum(grid[ax]) == 0 for ax in chunked):
        return None
    if any(isinstance(l.source, np.ma.MaskedArray) for l in leaves):
        return None
    return grid, tuple(chunked)


def _plan_grid2(kind, terminal, elem_root, leaves, reds=(), consts=(), scans=()):
    """The 2-D-chunk-grid lane: blocks of a two-axis grid flatten
    row-major onto the sharded block axis with a 2-D validity mask.
    Scope: elemwise; reductions over BOTH chunked axes (with or without
    the rest — one collective), over NEITHER (block-local), or
    STRADDLING exactly one chunked axis (grouped one-hot combine + one
    output-sized collective); cumulative scans along unchunked axes
    (block-local) or along a CHUNKED axis (Blelloch two-phase over block
    groups: local scans + one totals all-gather + local carry apply)."""
    ok = _leaf_grid_ok2(leaves)
    if ok is None:
        return None
    grid, dims = ok
    leaf_shape = tuple(int(sum(c)) for c in grid)
    for r in reds:
        # inner reductions must reduce BOTH chunked axes (replicated
        # result) over a leaf-shaped subtree
        if not set(dims) <= set(r.axes) or tuple(r.array.shape) != leaf_shape:
            return None
    for s in scans:
        # inner scans on the 2-D grid: block-local along UNCHUNKED axes
        # (padding is orthogonal, garbage stays padded), or the grouped
        # two-phase Blelloch along a CHUNKED axis (the same schedule the
        # g2_cumulative terminal runs, factored into the body)
        if s.axis is None or tuple(s.array.shape) != leaf_shape or _scan_declines(s, dims):
            return None
    aux = (tuple(reds), tuple(consts), tuple(scans))
    if kind == "elemwise":
        return "g2_elemwise", None, elem_root, leaves, dims, aux
    if kind in ("reduce", "reduce_local"):
        axes = tuple(terminal.axes)
        nd = terminal.array.ndim
        covered = set(dims) <= set(axes)
        disjoint = not (set(dims) & set(axes))
        if disjoint and axes:
            return "g2_reduce_local", terminal, elem_root, leaves, dims, aux
        if covered and (axes == tuple(range(nd)) or set(axes) == set(dims)):
            if terminal.kind not in _REDUCE_IDENT or terminal.kind == "prod":
                return None  # no sign-safe cross-device prod collective
            return "g2_reduce", terminal, elem_root, leaves, dims, aux
        if len(set(dims) & set(axes)) == 1:
            # STRADDLING reduce: exactly one chunked axis folds away while
            # the other survives — devices combine grid-patterned partials
            # by a one-hot grouped reduce + ONE collective of output size
            rk = terminal.kind
            base = rk[3:] if rk.startswith("nan") else rk
            dt = np.dtype(terminal.array.dtype)
            if rk not in _REDUCE_IDENT or base == "prod":
                return None  # no sign-safe cross-device prod collective
            if rk in ("nanmin", "nanmax") and dt.kind in "fc":
                return None  # grouped NaN-restoration vote not built
            if base in ("min", "max") and dt.kind == "c":
                return None  # no extremum compare on complex
            return "g2_reduce_straddle", terminal, elem_root, leaves, dims, aux
        return None
    if kind in ("cumulative", "cumulative_local"):
        if terminal.axis not in dims:
            return "g2_cumulative_local", terminal, elem_root, leaves, dims, aux
        if _scan_declines(terminal, dims):
            return None
        # scan ALONG a chunked axis: the two-phase Blelloch schedule over
        # block groups — local scans, one all-gather of per-block totals,
        # a within-group exclusive combine, local carry apply
        return "g2_cumulative", terminal, elem_root, leaves, dims, aux
    if kind in ("argreduce", "argreduce_local"):
        if terminal.axis is None:
            # full flatten: the 1-D lane's global-index vote with 2-D
            # block origins
            return "g2_argreduce", terminal, elem_root, leaves, dims, aux
        if terminal.axis not in dims:
            # positions along an unchunked axis are block-local truths
            return "g2_argreduce_local", terminal, elem_root, leaves, dims, aux
        # arg-extremum ALONG one chunked axis: grouped global-index vote
        return "g2_argreduce_straddle", terminal, elem_root, leaves, dims, aux
    return None


def _leaf_grid_ok(leaves):
    """Shared, known, single-chunked-axis, unmasked leaf grid — or
    ``None``.  Returns ``(grid, d)`` with ``d`` the one chunked axis
    (0 when every axis is a single block)."""
    if not leaves:
        return None
    grid = leaves[0].chunks
    if any(l.chunks != grid for l in leaves):
        return None  # one shared grid only (prototype)
    chunked = [ax for ax, c in enumerate(grid) if len(c) != 1]
    if len(chunked) > 1:
        return None  # chunked along ONE axis only
    d = chunked[0] if chunked else 0
    if any(isinstance(h, float) and math.isnan(h) for c in grid for h in c):
        return None  # known heights required
    if not grid or not grid[d] or sum(grid[d]) == 0:
        return None  # empty arrays: nothing to shard
    if any(isinstance(l.source, np.ma.MaskedArray) for l in leaves):
        return None  # masked stays on the host lane
    return grid, d


def _plan_matmul(root):
    """Einsum terminal: a 2-D matmul/matvec with one chunked lhs axis.

    Generalized parse: one contraction label shared by both operands (at
    EITHER position of either operand), output = lhs free label then rhs
    free label.  Two lanes by which lhs axis is chunked:

    * **rows** (free axis chunked): the rhs is replicated whole
      (weights-stationary) and each device runs its row blocks' GEMM on
      its own slot — ZERO collectives.
    * **contraction chunked** (``matmul_k`` — the classic tensor-parallel
      pattern): both operands are restacked along the shared contraction
      profile, each device contracts its own blocks, and the partial
      products combine with ONE ``psum`` — the output is replicated.

    Either operand may be an elemwise tree; the rhs's own declared chunk
    grid is irrelevant (blocks are restacked from the dense host buffer).
    """
    labels = root.input_labels
    if len(labels) != 2 or len(root.arrays) != 2:
        return None
    l0, l1 = labels
    out = root.out_labels
    if len(l0) != 2 or len(set(l0)) != 2:
        return None
    common = set(l0) & set(l1)
    if len(common) != 1 or len(set(l1)) != len(l1):
        return None
    c = common.pop()
    lpos = l0.index(c)
    lfree = l0[1 - lpos]
    if len(l1) == 2:  # matrix rhs
        rpos = l1.index(c)
        rfree = l1[1 - rpos]
        if out != lfree + rfree:
            return None
        rhs_vec = False
    elif len(l1) == 1:  # vector rhs
        rpos = 0
        if out != lfree:
            return None
        rhs_vec = True
    else:
        return None
    lhs, rhs = root.arrays
    lhs_leaves, rhs_leaves, consts = [], [], []
    if not _walk_elem(lhs, lhs_leaves, set(), None, consts):
        return None
    if not _walk_elem(rhs, rhs_leaves, set(), None, consts):
        return None
    # the two walks use separate seen sets: dedupe shared 0-d constants
    consts = list({c._name: c for c in consts}.values())
    swapped = False
    if not rhs_vec and lhs_leaves and rhs_leaves:
        rgrid0 = rhs_leaves[0].chunks
        lhs_unchunked = all(
            len(c) == 1 for l in lhs_leaves for c in l.chunks
        )
        rhs_one_chunked = sum(len(c) != 1 for c in rgrid0) == 1 and all(
            l.chunks == rgrid0 for l in rhs_leaves
        )
        if lhs_unchunked and rhs_one_chunked:
            # the CHUNKED operand drives the lane: a single-block lhs
            # against a chunked matrix rhs swaps roles, so the rhs's free
            # axis becomes the COLUMN-parallel split (weights sharded by
            # columns, lhs replicated, zero collectives, output chunked
            # along columns — the classic Megatron column split) and its
            # contraction axis becomes the tensor-parallel matmul_k
            lhs, rhs = rhs, lhs
            lhs_leaves, rhs_leaves = rhs_leaves, lhs_leaves
            lpos, rpos = rpos, lpos
            swapped = True
    ok = _leaf_grid_ok(lhs_leaves)
    if ok is None:
        return None
    d = ok[1]
    if not rhs_leaves:
        return None
    rgrid = rhs_leaves[0].chunks
    if any(l.chunks != rgrid for l in rhs_leaves):
        return None
    if any(isinstance(h, float) and math.isnan(h) for c_ in rgrid for h in c_):
        return None
    if any(isinstance(l.source, np.ma.MaskedArray) for l in rhs_leaves):
        return None
    layout = (lpos, rpos, rhs_vec, swapped)
    if d == 1 - lpos:
        # free axis chunked: rows lane, rhs replicated whole
        kind = "matmul"
    elif d == lpos and len(ok[0][d]) > 1:
        # contraction axis chunked: per-device partial GEMMs + one psum
        kind = "matmul_k"
    else:
        return None
    return kind, root, _unwrap(lhs), lhs_leaves, d, (
        _unwrap(rhs), rhs_leaves, layout, tuple(consts),
    )


def _plan_matmul_post(root):
    """Elemwise tree OVER one matmul (``f(x @ w)`` — the GEMM-then-
    activation pattern): the Einsum plans as usual and the outer tree
    applies per-device to the stacked (rows lane) or replicated
    (matmul_k) GEMM output.  Scope: the outer tree's array operands are
    the ONE Einsum subtree, scalars / 0-d consts, and EXTRA FromArray
    leaves that never touch the chunked output axis (the bias-add
    pattern ``x @ w + b``): those replicate whole into the body —
    matmul_k's output is replicated so any broadcastable leaf binds;
    the rows lane requires the leaf's aligned extent along the chunked
    rows axis to be 1 or absent (anything else would need restacking by
    the OUTPUT grid — declines).  Returns the matmul plan with aux
    extended to ``(..., None, post_elem_root, post_leaves)``."""
    from dask_array_tpu_torch._expr import ArrayExpr
    from dask_array_tpu_torch.ops._from_array import FromArray
    from dask_array_tpu_torch.ops.linalg import Einsum

    mms, consts, pleaves = [], [], []

    def walk(node):
        node = _unwrap(node)
        if isinstance(node, Einsum):
            if all(m._name != node._name for m in mms):
                mms.append(node)
            return True
        if type(node).__name__ == "Elemwise":
            return all(
                walk(a) for a in node.args if isinstance(a, ArrayExpr)
            )
        if node.shape == ():
            consts.append(node)
            return True
        if (
            isinstance(node, FromArray)
            and np.dtype(node.dtype).kind in "fciub"
            and not isinstance(node.source, np.ma.MaskedArray)
            and not any(
                isinstance(h, float) and math.isnan(h)
                for c in node.chunks
                for h in c
            )
        ):
            if all(p._name != node._name for p in pleaves):
                pleaves.append(node)
            return True
        return False

    if not walk(root) or len(mms) != 1:
        return None
    mm = _plan_matmul(mms[0])
    if mm is None:
        return None
    kind, terminal, lhs_root, lhs_leaves, d, aux = mm
    if pleaves:
        out_shape = tuple(int(s) for s in mms[0].shape)
        if kind == "matmul":
            _, _, _, swapped = aux[2]
            if swapped:
                return None  # column-chunked output: restack not built
            for p in pleaves:
                ps = tuple(int(s) for s in p.shape)
                if len(ps) > len(out_shape):
                    return None
                if len(ps) == len(out_shape) and ps and ps[0] != 1:
                    return None  # touches the chunked rows axis
    merged = list({c._name: c for c in list(aux[3]) + consts}.values())
    return kind, terminal, lhs_root, lhs_leaves, d, (
        aux[0], aux[1], aux[2], tuple(merged), None, _unwrap(root),
        tuple(pleaves),
    )


def _plan_stencil(root):
    """Halo stencils (``TrimInternal`` over map_blocks-over-``Overlap``)
    in-lane (r5): blocks stay stacked on the mesh while each block's halo
    rows arrive from its NEIGHBOR blocks — same-device slots by a shifted
    take, device-boundary slots by ONE ppermute of the per-device edge
    bands (plus two static wrap ppermutes for periodic) — then ``func``
    applies per-block and the halos trim away (the port runs the func once
    a slot over its haloed run: ``_execute_stencil``).  dask's analog is
    its ghost-cell task layer.

    Scope: one array argument (an elemwise tree over one irregular
    1-chunked-axis grid), depth along the chunked axis ``d`` rides the
    ring (depth on unchunked axes is global-boundary padding, handled
    block-locally), boundary per axis in reflect/nearest/periodic/
    constant, symmetric halos, no block_id/block_info injection, no
    margins, ``func`` vmappable over blocks.  ``None`` declines.
    """
    from dask_array_tpu_torch.ops._map_blocks import MapBlocks, MapBlocksInfo
    from dask_array_tpu_torch.ops._overlap import Overlap

    mb = _unwrap(root.array)
    if type(mb) is not MapBlocks or isinstance(mb, MapBlocksInfo):
        return None
    if mb._kwargs_dict.get("__inject_block_id__") or type(mb)._inject_block_id:
        return None
    if mb.new_axes or mb.adjust_chunks:
        return None
    if root.margin is not None:
        return None
    ov_args = mb.array_args
    if len(ov_args) != 1:
        return None
    ov = _unwrap(ov_args[0][0])
    if type(ov) is not Overlap or ov.body_chunks is not None:
        return None
    if tuple(ov.depth) != tuple(root.depth) or tuple(ov.boundary) != tuple(
        root.boundary
    ):
        return None
    depth = tuple(tuple(p) for p in ov.depth)
    boundary = tuple(ov.boundary)
    for (lo, hi), bd in zip(depth, boundary):
        if (lo or hi) and (bd == "none" or lo != hi):
            return None  # 'none' shrinks edge blocks; asymmetric is 'none'-only
        if not (
            bd in ("reflect", "nearest", "periodic", "none")
            or isinstance(bd, (int, float, np.number))
        ):
            return None
    leaves, consts = [], []
    if not _walk_elem(ov.array, leaves, set(), None, consts):
        return None
    ok = _leaf_grid_ok(leaves)
    if ok is None:
        return None
    grid, d = ok
    lo_d, hi_d = depth[d]
    # halos along the chunked axis must fit every donating block
    if (lo_d or hi_d) and min(grid[d]) < max(lo_d, hi_d):
        return None
    return "stencil", root, _unwrap(ov.array), leaves, d, (
        mb, depth, boundary, tuple(consts),
    )


def _plan(root):
    """Validate the subtree and return an execution plan, or None.

    plan = (kind, terminal, elem_root, leaves, d, aux) where kind is
    "elemwise" | "reduce" | "reduce_local" | "cumulative" | "matmul",
    terminal the Reduction/CumReduction/Einsum node (or None), leaves the
    FromArray nodes in deterministic order, d the one chunked (sharded)
    axis, and aux the kind-specific extra ("matmul": the rhs tree + its
    leaves).
    """
    from dask_array_tpu_torch.ops.linalg import Einsum
    from dask_array_tpu_torch.ops.reductions import (
        ArgReduction,
        CumReduction,
        Reduction,
    )

    root = _unwrap(root)
    terminal = None
    kind = "elemwise"
    if isinstance(root, Einsum):
        return _plan_matmul(root)
    if isinstance(root, Reduction):
        if root.keepdims:
            return None
        if root.kind not in _LANE_KINDS:
            return None
        inner = _unwrap(root.array)
        if isinstance(inner, Einsum):
            # reduction OVER the matmul: the GEMM runs per-device and the
            # reduce composes on top (padded rows masked before combining)
            mm = _plan_matmul(inner)
            if mm is None:
                return None
            if mm[0] == "matmul_k":
                if root.kind in ("any", "all"):
                    return None  # truth kinds stay off the GEMM compose
                # the GEMM output is replicated post-psum: ANY lane
                # reduce (nan kinds and prod included) applies locally
                return "matmul_k", inner, mm[2], mm[3], mm[4], mm[5] + (root,)
            if mm[5][2][3]:
                # swapped (column-parallel) rows lane: the sharded output
                # axis is 1 and the compose logic below assumes rows —
                # the walk answers the composed form
                return None
            if root.kind not in ("sum", "mean", "prod", "min", "max"):
                return None  # composed GEMM reduces stay plain numeric kinds
            axes = tuple(root.axes)
            nd = root.array.ndim
            if 0 in axes:
                if axes not in (tuple(range(nd)), (0,)):
                    return None
                if root.kind == "prod":
                    return None  # no sign-safe cross-device prod collective
            return "matmul", inner, mm[2], mm[3], mm[4], mm[5] + (root,)
        terminal, kind = root, "reduce"  # split on d below, once known
        elem_root = _unwrap(root.array)
    elif isinstance(root, CumReduction):
        if root.kind not in ("cumsum", "cumprod"):
            return None
        terminal, kind = root, "cumulative"
        elem_root = _unwrap(root.array)
    elif type(root).__name__ == "TrimInternal":
        return _plan_stencil(root)
    elif isinstance(root, ArgReduction):
        # first-occurrence semantics via a global-index vote (nanarg
        # kinds stay out: their all-NaN raise happens at host fetch,
        # which this lane's direct result would bypass); complex dtypes
        # have no extremum compare
        if (
            root.keepdims
            or root.kind not in ("argmin", "argmax")
            or np.dtype(root.array.dtype).kind == "c"
        ):
            return None
        terminal, kind = root, "argreduce"
        elem_root = _unwrap(root.array)
    else:
        elem_root = root

    # walk the tree down to FromArray leaves, collecting INNER reductions
    # (replicated inside the body), INNER scans (block-aligned in place),
    # and 0-d host constants along the way
    leaves, reds, consts, scans = [], [], [], []
    if not _walk_elem(elem_root, leaves, set(), reds, consts, scans):
        if kind == "elemwise":
            # an Einsum inside the tree fails the elemwise walk; the
            # GEMM-then-activation pattern rides the matmul lanes
            return _plan_matmul_post(elem_root)
        return None
    ok = _leaf_grid_ok(leaves)
    if ok is None:
        # a TWO-axis chunk grid rides its own lane (flattened block grid
        # + 2-D validity mask); anything else declines
        return _plan_grid2(
            kind, terminal, elem_root, leaves, reds, consts, scans
        )
    grid, d = ok
    leaf_shape = tuple(int(sum(c)) for c in grid)
    for r in reds:
        # an inner reduction's result must be REPLICATED (the sharded
        # axis reduced away) and its subtree leaf-shaped, so the result
        # broadcasts back into the outer tree with numpy's trailing rules
        if d not in tuple(r.axes) or tuple(r.array.shape) != leaf_shape:
            return None
    for s in scans:
        # an inner scan's subtree must be leaf-shaped so its result stays
        # block-aligned with the stacked leaves (a scan preserves shape);
        # axis=None (flattening) scans leave the lane
        if s.axis is None or tuple(s.array.shape) != leaf_shape or _scan_declines(s, (d,)):
            return None

    if kind == "reduce":
        axes = tuple(terminal.axes)
        nd = terminal.array.ndim
        if d not in axes and axes:
            # unsharded axes reduce block-locally: no collective, padding
            # drops at unpad (prod is fine — no cross-device combine)
            kind = "reduce_local"
        elif axes in (tuple(range(nd)), (d,)):
            if terminal.kind not in _REDUCE_IDENT:
                return None
        else:
            return None
    elif kind == "cumulative" and _scan_declines(terminal, (d,)):
        return None
    elif kind == "cumulative" and terminal.axis != d:
        # an unsharded scan axis never crosses a block boundary: pure
        # block-local work, no collective at all
        kind = "cumulative_local"
    elif kind == "argreduce" and terminal.axis is not None and terminal.axis != d:
        # indices along an unsharded axis are block-local positions
        kind = "argreduce_local"

    return kind, terminal, elem_root, leaves, d, (
        tuple(reds), tuple(consts), tuple(scans),
    )


# ---------------------------------------------------------------------------
# execution: per-slot programs
# ---------------------------------------------------------------------------


class _Piece:
    """A box of the leaf grid one slot holds: a run of row blocks (one-axis
    grids) or one block (two-axis grids).  ``idx`` is its index along the
    lane's chunked axes, ``region`` its ``(start, stop)`` per array axis;
    ``ctx`` evaluates nodes over its leaf tensors."""

    __slots__ = ("slot", "device", "idx", "region", "ctx")

    def __init__(self, slot, device, idx, region):
        from dask_array_tpu_torch._executor import BuildContext

        self.slot = slot
        self.device = device
        self.idx = idx
        self.region = region
        self.ctx = BuildContext({}, device)

    def seed(self, name, value):
        from dask_array_tpu_torch._executor import BlockView

        self.ctx.cache[name] = BlockView((), dense=value)

    def ev(self, node):
        return self.ctx.build(node).dense()

    def sizes(self):
        return tuple(b - a for a, b in self.region)


class _Lane:
    """The pieces of one lane program and the mesh they run on."""

    def __init__(self, mesh, grid, dims, pieces, numblocks):
        self.mesh = mesh
        self.grid = grid
        self.dims = tuple(dims)
        self.pieces = pieces
        self.numblocks = tuple(numblocks)
        self.shape = tuple(int(sum(c)) for c in grid)

    def per_slot(self, values):
        """Per-piece values -> ``{slot: [values]}`` in piece order."""
        out: dict = {}
        for p, v in zip(self.pieces, values):
            out.setdefault(p.slot, []).append(v)
        return out

    def slot_list(self, by_slot):
        return [by_slot.get(s) for s in range(self.mesh.size)]

    def axes(self):
        return tuple(self.mesh.axis_names)


def _lane_1d(mesh, grid, d):
    """One piece a slot: slot ``s`` runs blocks ``[s*blk, (s+1)*blk)`` with
    ``blk = kpad / ndev`` (the JAX package's contiguous assignment)."""
    heights = [int(h) for h in grid[d]]
    k = len(heights)
    blk = -(-max(k, 1) // mesh.size)
    off = np.concatenate([[0], np.cumsum(heights)]).astype(int)
    pieces = []
    for s, dev in enumerate(mesh.slots):
        b0, b1 = min(s * blk, k), min((s + 1) * blk, k)
        if b1 <= b0:
            continue
        region = tuple(
            (int(off[b0]), int(off[b1])) if ax == d else (0, int(sum(c))) for ax, c in enumerate(grid)
        )
        pieces.append(_Piece(s, dev, (len(pieces),), region))
    return _Lane(mesh, grid, (d,), pieces, (len(pieces),))


def _lane_2d(mesh, grid, dims):
    """One piece a block: the ``k1 * k2`` blocks flatten row-major and run
    ``kpad / ndev`` to a slot."""
    d1, d2 = dims
    h1 = [int(h) for h in grid[d1]]
    h2 = [int(h) for h in grid[d2]]
    k1, k2 = len(h1), len(h2)
    blk = -(-(k1 * k2) // mesh.size)
    o1 = np.concatenate([[0], np.cumsum(h1)]).astype(int)
    o2 = np.concatenate([[0], np.cumsum(h2)]).astype(int)
    pieces = []
    for g in range(k1 * k2):
        i1, i2 = divmod(g, k2)
        s = g // blk
        region = []
        for ax, c in enumerate(grid):
            if ax == d1:
                region.append((int(o1[i1]), int(o1[i1 + 1])))
            elif ax == d2:
                region.append((int(o2[i2]), int(o2[i2 + 1])))
            else:
                region.append((0, int(sum(c))))
        pieces.append(_Piece(s, mesh.slots[s], (i1, i2), tuple(region)))
    return _Lane(mesh, grid, dims, pieces, (k1, k2))


def _leaf_source(leaf):
    """A leaf's buffer, made (a loader's block) and read (a store)."""
    ((_, buf),) = list(leaf._leaf_buffers())
    if hasattr(buf, "materialize"):
        buf = buf.materialize()
    if not isinstance(buf, (np.ndarray, torch.Tensor)) and not hasattr(buf, "__array__") and hasattr(buf, "shape"):
        buf = buf[(slice(None),) * len(buf.shape)]
    return buf if isinstance(buf, torch.Tensor) else np.asarray(buf)


def _device_form(sources) -> bool:
    """Whether every source has a device form the lane can shard: masked,
    object, record, duck and datetime blocks stay on their own lanes."""
    from dask_array_tpu_torch._host import is_host_block

    for src in sources:
        if isinstance(src, torch.Tensor):
            continue
        if is_host_block(src) or src.dtype.kind in "MmO":
            return False
    return True


def _part(src, region, device):
    """The region of a leaf source on ``device``."""
    from dask_array_tpu_torch._executor import to_device

    sl = tuple(slice(a, b) for a, b in region)
    if isinstance(src, torch.Tensor):
        return src[sl].to(device, non_blocking=True)
    return to_device(src[sl], device)


class _Whole:
    """A leaf source whole on each device that asks (uploaded once a
    device): a replicated operand."""

    def __init__(self, src):
        self.src = src
        self.on: dict = {}

    def get(self, device):
        got = self.on.get(device)
        if got is None:
            from dask_array_tpu_torch._executor import to_device

            src = self.src
            got = src.to(device, non_blocking=True) if isinstance(src, torch.Tensor) else to_device(src, device)
            self.on[device] = got
        return got


def _bind(lane, leaves, sources, axis_of=None):
    """Seed every piece with its part of each leaf.  ``axis_of`` maps a
    leaf to the array axis its piece range runs along when that leaf is
    laid out differently from the lane grid (a restacked rhs)."""
    for p in lane.pieces:
        for leaf in leaves:
            region = p.region
            if axis_of is not None:
                ax, d = axis_of
                region = tuple(
                    p.region[d] if a == ax else (0, int(s)) for a, s in enumerate(sources[leaf._name].shape)
                )
            p.seed(leaf._name, _part(sources[leaf._name], region, p.device))


def _bind_consts(lane, consts):
    """0-d subtrees, computed through the regular executor (a 0-d root
    always declines this lane), seeded in every piece."""
    if not consts:
        return
    from dask_array_tpu_torch._materialize import compute_expr

    for node in consts:
        value = compute_expr(node)
        for p in lane.pieces:
            p.seed(node._name, value.to(p.device, non_blocking=True))


# -- typed combines ----------------------------------------------------------

# the reduction that combines partials of each lane kind, and its collective
_COMBINE_KIND = {
    "sum": "sum", "mean": "sum", "nansum": "sum", "nanmean": "sum",
    "prod": "prod", "nanprod": "prod",
    "min": "min", "max": "max", "nanmin": "nanmin", "nanmax": "nanmax",
    "any": "any", "all": "all",
}
_COLLECTIVE = {"sum": "psum", "prod": "psum", "min": "pmin", "nanmin": "pmin", "max": "pmax", "nanmax": "pmax",
               "any": "pmax", "all": "pmin"}


def _stack(ts):
    from dask_array_tpu_torch._chunks import cat

    return cat([t.unsqueeze(0) for t in ts], dim=0)


def _combiner(kind, dtype):
    from dask_array_tpu_torch.ops.reductions import reduce_dense

    ck = _COMBINE_KIND[kind]

    def combine(ts):
        ts = [t for t in ts if t is not None]
        return ts[0] if len(ts) == 1 else reduce_dense(ck, _stack(ts), (0,), False, dtype)

    return combine


def _identity(kind, shape, dtype, device):
    """A tensor of the reduction identity of ``kind`` in numpy ``dtype``."""
    from dask_array_tpu_torch._chunks import tensor_of

    base = kind[3:] if kind.startswith("nan") else kind
    base = {"mean": "sum"}.get(base, base)
    if base in ("any", "all"):
        value = base == "all"
    else:
        value = _reduce_ident(base, dtype)
    return tensor_of(np.full(shape, value, dtype=np.dtype(dtype))).to(device)


def _out_region(region, axes):
    """The output box of a piece once ``axes`` reduce away."""
    return tuple(r for ax, r in enumerate(region) if ax not in axes)


def _grouped(lane, parts, axes, combine, ident):
    """Per-slot combine of per-piece partials of a reduction over ``axes``:
    a partial whose output box is the whole output combines directly; one
    of a straddling reduction lands in its box of an output-sized tensor
    filled with the identity (``ident(shape, device)``)."""
    out_shape = _out_region(tuple((0, s) for s in lane.shape), axes)
    full = tuple(b for _, b in out_shape)
    by_slot: dict = {}
    for p, part in zip(lane.pieces, parts):
        box = _out_region(p.region, axes)
        cur = by_slot.get(p.slot)
        if box == out_shape:
            by_slot[p.slot] = part if cur is None else combine([cur, part])
            continue
        if cur is None:
            cur = by_slot[p.slot] = ident(full, p.device)
        sl = tuple(slice(a, b) for a, b in box)
        cur[sl] = combine([cur[sl], part])
    return lane.slot_list(by_slot)


def _lane_reduce(lane, kind, dtype, values, axes):
    """A typed reduction of the per-piece values over array ``axes``: one
    partial a piece, a local combine a slot, ONE collective across slots
    (two for ``nanmean`` of floats: the non-NaN counts).  Returns the
    per-slot results (None on a slot with no piece).  A 2-byte float sum
    or mean keeps float32 partials through the combines and the
    collective and rounds once at the end, as the dense walk does."""
    from dask_array_tpu_torch._chunks import cast, to_compute
    from dask_array_tpu_torch.ops.reductions import reduce_dense
    from dask_array_tpu_torch.parallel.collectives import all_reduce

    out_dtype = np.dtype(dtype)
    axes = tuple(axes)
    part_kind = {"mean": "sum", "nanmean": "nansum"}.get(kind, kind)
    once = part_kind in ("sum", "nansum") and _two_byte_float(out_dtype)
    dtype = np.dtype(np.float32) if once else out_dtype
    parts = [reduce_dense(part_kind, v, axes, False, dtype) for v in values]
    combine = _combiner(kind, dtype)
    slot_parts = _grouped(lane, parts, axes, combine,
                          lambda shape, dev: _identity(kind, shape, dtype, dev))
    coll = _COLLECTIVE[_COMBINE_KIND[kind]]
    tot = all_reduce(coll, slot_parts, lane.mesh, lane.axes(), combine=combine)
    floats = any(v.is_floating_point() or v.is_complex() for v in values)
    if kind == "nanmean" and floats:
        counts = [(~torch.isnan(v)).sum(dim=axes) if axes else (~torch.isnan(v)).to(torch.int64) for v in values]
        add = _combiner("sum", np.dtype(np.int64))
        slot_counts = _grouped(lane, counts, axes, add,
                               lambda shape, dev: torch.zeros(shape, dtype=torch.int64, device=dev))
        cnt = all_reduce("psum", slot_counts, lane.mesh, lane.axes(), combine=add)
        tot = [None if t is None else (to_compute(t, dtype) / c.to(to_compute(t, dtype).dtype)).to(t.dtype)
               for t, c in zip(tot, cnt)]
    elif kind in ("mean", "nanmean"):
        count = math.prod(lane.shape[ax] for ax in axes)
        tot = [None if t is None else to_compute(t, dtype) / count for t in tot]
    return [None if t is None else cast(t, out_dtype) for t in tot] if once else tot


def _first(values):
    return next(v for v in values if v is not None)


# -- scans --------------------------------------------------------------------


def _lane_scan(lane, node, ds):
    """``node`` (a cumsum/cumprod along ``ds``) on every piece.  Along an
    unchunked axis the scan is piece-local.  Along a chunked axis: the
    two-phase Blelloch schedule, a local scan a piece, ONE ``all_gather``
    of the per-piece totals, and each piece adds (multiplies) the totals
    of the pieces before it in its group as a carry.  The planners keep a
    2-byte float scan along a chunked axis out (`_scan_declines`)."""
    from dask_array_tpu_torch._chunks import as_stored, to_compute
    from dask_array_tpu_torch.parallel.collectives import all_gather

    local = [p.ev(node) for p in lane.pieces]
    if ds not in lane.dims:
        return local
    dtype = np.dtype(node.dtype)
    pos = lane.dims.index(ds)
    totals = [
        None if t.shape[ds] == 0 else to_compute(t.narrow(ds, t.shape[ds] - 1, 1), dtype) for t in local
    ]
    by_slot = lane.per_slot(totals)
    gathered = all_gather(lane.slot_list(by_slot), lane.mesh, lane.axes())
    op = torch.add if node.kind.endswith("cumsum") else torch.mul
    out = []
    for p, t in zip(lane.pieces, local):
        everyone = [x for slot_list in gathered[p.slot] if slot_list is not None for x in slot_list]
        key = p.idx[:pos] + p.idx[pos + 1:]
        prev = [
            tot for q, tot in zip(lane.pieces, everyone)
            if tot is not None and q.idx[:pos] + q.idx[pos + 1:] == key and q.idx[pos] < p.idx[pos]
        ]
        if not prev:
            out.append(t)
            continue
        carry = functools.reduce(op, prev)
        out.append(as_stored(op(to_compute(t, dtype), carry), dtype))
    return out


# -- arg-extremum votes --------------------------------------------------------


def _vote_value(v):
    """A piece's values as the vote compares them (bool as int32)."""
    from dask_array_tpu_torch._chunks import computable

    v = computable(v)
    return v.to(torch.int32) if v.dtype == torch.bool else v


def _lane_arg(lane, kind, values, axis):
    """argmin/argmax over the whole array (``axis`` None) or along a
    chunked axis: the extremum (one pmin/pmax), NaN presence (one pmax,
    floats), then the least global index of a hit (one pmin): numpy's
    first occurrence, a NaN anywhere winning as in numpy."""
    from dask_array_tpu_torch.parallel.collectives import all_reduce

    is_min = kind == "argmin"
    vals = [_vote_value(v) for v in values]
    floats = any(v.is_floating_point() for v in vals)
    axes = tuple(range(len(lane.shape))) if axis is None else (axis,)
    ext_op = torch.minimum if is_min else torch.maximum

    def ext_ident(shape, dev, dt):
        if dt.is_floating_point:
            val = math.inf if is_min else -math.inf
        else:
            info = torch.iinfo(dt)
            val = info.max if is_min else info.min
        return torch.full(shape, val, dtype=dt, device=dev)

    dt = vals[0].dtype
    parts = [(v.amin(dim=axes) if is_min else v.amax(dim=axes)) for v in vals]
    comb = lambda ts: functools.reduce(ext_op, [t for t in ts if t is not None])  # noqa: E731
    ext = all_reduce("pmin" if is_min else "pmax",
                     _grouped(lane, parts, axes, comb, lambda s, d: ext_ident(s, d, dt)),
                     lane.mesh, lane.axes())
    has_nan = None
    if floats:
        nan_parts = [torch.isnan(v).any(dim=axes) if axes else torch.isnan(v) for v in vals]
        nan_or = lambda ts: functools.reduce(torch.logical_or, [t for t in ts if t is not None])  # noqa: E731
        has_nan = all_reduce("pmax", _grouped(lane, nan_parts, axes, nan_or,
                                              lambda s, d: torch.zeros(s, dtype=torch.bool, device=d)),
                             lane.mesh, lane.axes())
    n_out = math.prod(lane.shape) if axis is None else lane.shape[axis]
    strides = [math.prod(lane.shape[ax + 1:]) for ax in range(len(lane.shape))]
    cands = []
    for p, v in zip(lane.pieces, vals):
        box = tuple(slice(a, b) for a, b in _out_region(p.region, axes))
        g = ext[p.slot][box] if box else ext[p.slot]
        if axis is not None:
            g = g.unsqueeze(axis)
        eq = v == g
        if has_nan is not None:
            hn = has_nan[p.slot][box] if box else has_nan[p.slot]
            if axis is not None:
                hn = hn.unsqueeze(axis)
            eq = torch.where(hn, torch.isnan(v), eq)
        if axis is None:
            flat = eq.reshape(-1)
            i = flat.to(torch.int32).argmax()
            glob = torch.zeros((), dtype=torch.int64, device=p.device)
            rem = i.to(torch.int64)
            sizes = p.sizes()
            for ax in range(len(sizes) - 1, -1, -1):
                coord = rem % sizes[ax]
                rem = rem // sizes[ax]
                glob = glob + (coord + p.region[ax][0]) * strides[ax]
            cands.append(torch.where(flat.any(), glob, torch.full_like(glob, n_out)))
        else:
            i = eq.to(torch.int32).argmax(dim=axis).to(torch.int64) + p.region[axis][0]
            cands.append(torch.where(eq.any(dim=axis), i, torch.full_like(i, n_out)))
    least = lambda ts: functools.reduce(torch.minimum, [t for t in ts if t is not None])  # noqa: E731
    slot_cands = _grouped(lane, cands, axes, least,
                          lambda s, d: torch.full(s, n_out, dtype=torch.int64, device=d))
    return all_reduce("pmin", slot_cands, lane.mesh, lane.axes())


# -- assembly -------------------------------------------------------------------


def _gather(lane, values, axis_map, out_dtype):
    """Per-piece outputs -> the dense result on the mesh's first slot (one
    ``gather``).  ``axis_map`` gives, for each lane chunked axis, its
    output axis."""
    from dask_array_tpu_torch._chunks import cast
    from dask_array_tpu_torch._executor import _assemble
    from dask_array_tpu_torch.parallel._sharded import COLLECTIVES, nbytes

    walk = lane.mesh.slots[0]
    nd = values[0].ndim
    numblocks = [1] * nd
    for pos, oax in enumerate(axis_map):
        numblocks[oax] = lane.numblocks[pos]
    blocks = {}
    moved = 0
    for p, v in zip(lane.pieces, values):
        key = [0] * nd
        for pos, oax in enumerate(axis_map):
            key[oax] = p.idx[pos]
        if p.slot != 0:
            moved += nbytes(v)
        blocks[tuple(key)] = v.to(walk, non_blocking=True)
    COLLECTIVES.add("gather", moved)
    return cast(_assemble(blocks, tuple(numblocks)), out_dtype)


def _replicated(values, mesh, out_dtype):
    from dask_array_tpu_torch._chunks import cast

    return cast(_first(values).to(mesh.slots[0], non_blocking=True), out_dtype)


def _kept(axis, removed):
    """An axis's position once the axes in ``removed`` drop out."""
    return axis - sum(1 for ax in removed if ax < axis)


# -- the lane programs ----------------------------------------------------------


def try_execute_shard(root, mesh):
    """Execute ``root`` as per-slot programs on ``mesh``; None = declined.

    Returns the dense result on the mesh's first slot.
    """
    if any(is_narrow(node.dtype) for node in root.walk()):
        return None  # narrow data: the walk's dense builds decode it
    plan = _plan(root)
    if plan is None:
        return None
    kind, terminal, elem_root, leaves, d, aux = plan
    extra = []
    if kind in ("matmul", "matmul_k"):
        extra = list(aux[1]) + list(aux[6] if len(aux) >= 7 else ())
    sources = {leaf._name: _leaf_source(leaf) for leaf in list(leaves) + extra}
    if not _device_form(sources.values()):
        return None
    if kind == "reduce" and terminal.kind == "prod":
        return None  # a cross-slot prod has no sign-safe collective
    out_dtype = np.dtype(_unwrap(root).dtype)
    if kind.startswith("g2_"):
        out = _execute_grid2(plan, mesh, sources, out_dtype)
    elif kind in ("matmul", "matmul_k"):
        out = _execute_matmul(plan, mesh, sources, out_dtype)
    elif kind == "stencil":
        out = _execute_stencil(plan, mesh, sources, out_dtype)
    else:
        out = _execute_1d(plan, mesh, sources, out_dtype)
    ENGAGED["count"] += 1
    return out


def _prologue(lane, leaves, sources, reds, consts, scans):
    """Bind the leaves and constants, then run the inner reductions (each
    replicated by one collective) and the inner scans (innermost first),
    seeding their results where the outer tree reads them."""
    _bind(lane, leaves, sources)
    _bind_consts(lane, consts)
    for r in reds:
        vals = [p.ev(_unwrap(r.array)) for p in lane.pieces]
        res = _lane_reduce(lane, r.kind, r.dtype, vals, tuple(r.axes))
        shape = tuple(int(s) for s in r.shape)
        for p in lane.pieces:
            p.seed(r._name, res[p.slot].reshape(shape))
    for s in scans:
        for p, v in zip(lane.pieces, _lane_scan(lane, s, s.axis)):
            p.seed(s._name, v)


def _execute_1d(plan, mesh, sources, out_dtype):
    kind, terminal, elem_root, leaves, d, aux = plan
    lane = _lane_1d(mesh, leaves[0].chunks, d)
    reds, consts, scans = aux[0], aux[1], aux[2] if len(aux) > 2 else ()
    _prologue(lane, leaves, sources, reds, consts, scans)
    if tuple(int(s) for s in elem_root.shape) != lane.shape and kind != "elemwise":
        # the terminal reads only inner reductions' results: every piece
        # holds its whole operand (replicated), so the terminal runs on it
        # as it is, with no combine across slots (the JAX package's lane
        # combines it once a slot here, or fails on a 0-d result)
        return _replicated([p.ev(terminal) for p in lane.pieces], mesh, out_dtype)
    if kind in ("reduce_local", "cumulative_local", "argreduce_local"):
        # block-local work along unsharded axes: the terminal node itself on
        # each piece, no collective
        outs = [p.ev(terminal) for p in lane.pieces]
        removed = () if kind == "cumulative_local" else (
            tuple(terminal.axes) if kind == "reduce_local" else (terminal.axis,))
        return _gather(lane, outs, (_kept(d, removed),), out_dtype)
    vals = [p.ev(elem_root) for p in lane.pieces]
    if kind == "reduce":
        res = _lane_reduce(lane, terminal.kind, terminal.dtype, vals, tuple(terminal.axes))
        return _replicated(res, mesh, out_dtype)
    if kind == "cumulative":
        for p, v in zip(lane.pieces, vals):
            p.seed(_unwrap(terminal.array)._name, v)
        return _gather(lane, _lane_scan(lane, terminal, terminal.axis), (d,), out_dtype)
    if kind == "argreduce":
        return _replicated(_lane_arg(lane, terminal.kind, vals, terminal.axis), mesh, out_dtype)
    # elemwise: a leaf-shaped root reassembles; a smaller root collapsed to
    # inner-reduction/constant combinations and is replicated
    if tuple(int(s) for s in elem_root.shape) != lane.shape:
        return _replicated(vals, mesh, out_dtype)
    return _gather(lane, vals, (d,), out_dtype)


def _execute_matmul(plan, mesh, sources, out_dtype):
    """2-D matmul/matvec terminals: rows lane (rhs whole on every device, no
    collective), contraction lane (both operands restacked along the lhs's
    contraction profile, partial products, ONE psum) and the composed
    forms (a reduction over the product, ``f(x @ w)``)."""
    from dask_array_tpu_torch.parallel.collectives import all_reduce

    kind, terminal, lhs_root, leaves, d, aux = plan
    rhs_root, rhs_leaves, layout, consts = aux[0], aux[1], aux[2], aux[3]
    post = aux[4] if len(aux) >= 5 else None
    post_elem = aux[5] if len(aux) >= 6 else None
    post_leaves = aux[6] if len(aux) >= 7 else ()
    _, rpos, _, swapped = layout
    lane = _lane_1d(mesh, leaves[0].chunks, d)
    _bind(lane, leaves, sources)
    _bind_consts(lane, consts)
    lhs = [p.ev(lhs_root) for p in lane.pieces]
    # the rhs tree evaluates in a context of its own on each piece (the two
    # operands may share a leaf laid out differently)
    rhs_pieces = [_Piece(p.slot, p.device, p.idx, p.region) for p in lane.pieces]
    rlane = _Lane(mesh, lane.grid, lane.dims, rhs_pieces, lane.numblocks)
    if kind == "matmul":
        wholes = {leaf._name: _Whole(sources[leaf._name]) for leaf in rhs_leaves}
        for rp in rhs_pieces:
            for leaf in rhs_leaves:
                rp.seed(leaf._name, wholes[leaf._name].get(rp.device))
    else:
        _bind(rlane, rhs_leaves, sources, axis_of=(rpos, d))
    _bind_consts(rlane, consts)
    rhs = [rp.ev(rhs_root) for rp in rhs_pieces]
    prods = [terminal.contract([b, a] if swapped else [a, b]) for a, b in zip(lhs, rhs)]
    pl_wholes = {leaf._name: _Whole(sources[leaf._name]) for leaf in post_leaves}

    def finish(p, mm):
        p.seed(terminal._name, mm)
        for leaf in post_leaves:
            p.seed(leaf._name, pl_wholes[leaf._name].get(p.device))
        if post_elem is not None:
            return p.ev(post_elem)
        if post is not None:
            return p.ev(post)
        return mm

    if kind == "matmul_k":
        # contraction chunked: partial products, ONE psum, the output
        # replicated; any composed form then applies on the true product
        per_slot = [None] * mesh.size
        for p, v in zip(lane.pieces, prods):
            per_slot[p.slot] = v  # a one-axis lane holds one piece a slot
        total = all_reduce("psum", per_slot, mesh, lane.axes(), combine=_combiner("sum", terminal.dtype))
        done: dict = {}
        outs = []
        for p in lane.pieces:
            if p.device not in done:
                done[p.device] = finish(p, total[p.slot])
            outs.append(done[p.device])
        return _replicated(outs, mesh, out_dtype)
    out_axis = 1 if swapped else 0
    if post is not None and 0 in tuple(post.axes):
        # the sharded row axis folds in: a partial a slot, one collective
        plane = _relane(lane, tuple(int(x) for x in terminal.shape), 0)
        res = _lane_reduce(plane, post.kind, post.dtype, prods, tuple(post.axes))
        return _replicated(res, mesh, out_dtype)
    outs = [finish(p, mm) for p, mm in zip(lane.pieces, prods)]
    if post is not None:
        return _gather(lane, outs, (_kept(out_axis, tuple(post.axes)),), out_dtype)
    return _gather(lane, outs, (out_axis,), out_dtype)


def _relane(lane, shape, axis):
    """The one-axis lane seen in another array's coordinates: each piece's
    run along the lane's chunked axis becomes its run along ``axis`` of an
    array of ``shape`` (the rows of a matmul's product)."""
    d = lane.dims[0]
    pieces = []
    for p in lane.pieces:
        q = _Piece.__new__(_Piece)
        q.slot, q.device, q.idx, q.ctx = p.slot, p.device, p.idx, p.ctx
        q.region = tuple(p.region[d] if ax == axis else (0, s) for ax, s in enumerate(shape))
        pieces.append(q)
    return _Lane(lane.mesh, tuple((s,) for s in shape), (axis,), pieces, lane.numblocks)


def _execute_stencil(plan, mesh, sources, out_dtype):
    """A halo stencil on a one-axis grid: each slot's run evaluates its
    elemwise tree, sends its tail forward and its head back (ONE
    ``ppermute`` each way over the slot ring; two more wrap a periodic
    axis), the first and last runs realize the boundary, and the stencil
    runs once a slot over the haloed run: the band-stencil kernel where
    ``stencil_taps`` takes the func, its taps or its program (so not under
    ``stencil-kernel: off`` nor past depth 8), the halo kernel (the other
    axes' boundary) and the func otherwise.  Under the ``map_overlap``
    locality contract this equals the func per block."""
    from dask_array_tpu_torch._chunks import cast, cat
    from dask_array_tpu_torch.kernels.halo import halo_pad, numpy_mode
    from dask_array_tpu_torch.kernels.stencil import band_stencil_call, bind_kwargs, stencil_taps
    from dask_array_tpu_torch.ops._overlap import _edge_fill
    from dask_array_tpu_torch.parallel.collectives import ppermute

    kind, root, elem_root, leaves, d, aux = plan
    mb, depth, boundary, consts = aux
    lane = _lane_1d(mesh, leaves[0].chunks, d)
    _bind(lane, leaves, sources)
    _bind_consts(lane, consts)
    vals = [p.ev(elem_root) for p in lane.pieces]
    nd = len(lane.shape)
    lo_d, hi_d = depth[d]
    bd_d = boundary[d]
    wrap = bd_d == "periodic"
    axes = lane.axes()
    slots = [p.slot for p in lane.pieces]
    n = mesh.size
    left = [None] * len(vals)
    right = [None] * len(vals)
    if lo_d or hi_d:
        tails = [None] * n
        heads = [None] * n
        for p, v in zip(lane.pieces, vals):
            tails[p.slot] = v.narrow(d, v.shape[d] - lo_d, lo_d)
            heads[p.slot] = v.narrow(d, 0, hi_d)
        fwd = [(i, i + 1) for i in range(n - 1)]
        bwd = [(i + 1, i) for i in range(n - 1)]
        from_left = ppermute(tails, mesh, axes, fwd)
        from_right = ppermute(heads, mesh, axes, bwd)
        first, last = slots[0], slots[-1]
        for i, p in enumerate(lane.pieces):
            left[i] = from_left[p.slot] if p.slot != first else None
            right[i] = from_right[p.slot] if p.slot != last else None
        if wrap:
            # block 0's left is block k-1's tail and block k-1's right is
            # block 0's head: two pairs between the slots of the edge blocks
            wl = ppermute(tails, mesh, axes, [(last, first)])
            wr = ppermute(heads, mesh, axes, [(first, last)])
            left[0] = wl[first]
            right[-1] = wr[last]
        else:
            left[0] = _edge_fill(vals[0], d, lo_d, bd_d, "lo")
            right[-1] = _edge_fill(vals[-1], d, hi_d, bd_d, "hi")
    func = mb.operand("func")
    fkw = {k: v for k, v in mb._kwargs_dict.items() if not k.startswith("__inject")}
    taps = stencil_taps(nd, elem_root.dtype, depth, boundary, func, fkw)
    outs = []
    for i, (p, v) in enumerate(zip(lane.pieces, vals)):
        parts = [t for t in (left[i], v, right[i]) if t is not None and t.shape[d]]
        vin = cat(parts, dim=d) if len(parts) > 1 else v
        if taps is not None:
            dep = tuple(lo for lo, _ in depth)
            # the kernel pads the unchunked axis with its boundary itself
            out = band_stencil_call(vin.contiguous(), bind_kwargs(func, fkw), dep, tuple(boundary), taps)
            out = out.narrow(d, lo_d, v.shape[d])
        else:
            widths = [(0, 0) if ax == d else tuple(depth[ax]) for ax in range(nd)]
            modes = [numpy_mode(boundary[ax]) if widths[ax] != (0, 0) else "edge" for ax in range(nd)]
            vin = halo_pad(vin, widths, modes)
            out = mb._call([vin], fkw, (0,) * nd, p.device)
            out = out[tuple(
                slice(lo_d, lo_d + v.shape[d]) if ax == d else slice(depth[ax][0], depth[ax][0] + lane.shape[ax])
                for ax in range(nd)
            )]
        outs.append(cast(out, np.dtype(root.dtype)))
    return _gather(lane, outs, (d,), out_dtype)


def _execute_grid2(plan, mesh, sources, out_dtype):
    """A two-axis chunk grid: one piece a block, flattened row-major onto the
    slots.  Elemwise; reductions over both chunked axes (one collective),
    over neither (block-local) or straddling one (an output-sized combine,
    one collective); scans along a chunked axis (the grouped Blelloch
    schedule) or an unchunked one (block-local); arg-extremum votes."""
    kind, terminal, elem_root, leaves, dims, aux = plan
    d1, d2 = dims
    lane = _lane_2d(mesh, leaves[0].chunks, dims)
    reds, consts, scans = aux[0], aux[1], aux[2] if len(aux) > 2 else ()
    _prologue(lane, leaves, sources, reds, consts, scans)
    if kind in ("g2_reduce_local", "g2_cumulative_local", "g2_argreduce_local"):
        outs = [p.ev(terminal) for p in lane.pieces]
        removed = () if kind == "g2_cumulative_local" else (
            tuple(terminal.axes) if kind == "g2_reduce_local" else (terminal.axis,))
        return _gather(lane, outs, (_kept(d1, removed), _kept(d2, removed)), out_dtype)
    vals = [p.ev(elem_root) for p in lane.pieces]
    if kind in ("g2_reduce", "g2_reduce_straddle"):
        # a straddling reduction combines an output-sized tensor (_grouped)
        res = _lane_reduce(lane, terminal.kind, terminal.dtype, vals, tuple(terminal.axes))
        return _replicated(res, mesh, out_dtype)
    if kind == "g2_cumulative":
        for p, v in zip(lane.pieces, vals):
            p.seed(_unwrap(terminal.array)._name, v)
        return _gather(lane, _lane_scan(lane, terminal, terminal.axis), (d1, d2), out_dtype)
    if kind in ("g2_argreduce", "g2_argreduce_straddle"):
        return _replicated(_lane_arg(lane, terminal.kind, vals, terminal.axis), mesh, out_dtype)
    assert kind == "g2_elemwise", f"unhandled grid2 plan kind: {kind}"
    if tuple(int(s) for s in elem_root.shape) != lane.shape:
        return _replicated(vals, mesh, out_dtype)
    return _gather(lane, vals, (d1, d2), out_dtype)
