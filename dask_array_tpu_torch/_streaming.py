"""Out-of-core panel streaming: the executor lane for programs larger than
the card's memory.

Port of ``dask_array_tpu/_streaming.py``, with the same planner:

* the output (map-stream) or the reduced input (reduce-stream) is cut into
  **panels** along one axis, each a contiguous run of chunk rows;
* the optimizer's own slice pushdown shrinks each panel program's leaf
  reads to the panel's region (``FromArray`` defers its region, so only the
  panel's bytes go up; a memmap or a store reads only the panel);
* panels of equal height share one structural key
  (``_executor.structural_key``), checked before the lane engages: at most
  three keys over all panels (the first, the interior, the last);
* leaves the pushdown cannot shrink (the weights of a panel-swept matmul)
  go up **once** and stay on the card for every panel;
* the panels run as a pipeline: panel *i+1*'s upload is queued on the copy
  stream (``_hostcopy.upload``) while panel *i* computes and panel *i-1* is
  fetched into the preallocated host result (map-stream) or folded into a
  small combine accumulator (reduce-stream); ``"stream-depth"`` panels are
  in flight beyond the one being fetched;
* each panel's expected bytes (its leaves' and its output's, from chunk
  metadata) set the panel height against the memory budget.

Engagement: config ``"out-of-core"`` = ``"auto"`` (stream when the
program's estimated device bytes exceed ``"memory-budget"``), ``"force"``
(stream whenever a plan exists), ``"off"``.  The planner declines, and the
in-core walk answers, whenever it cannot show the stream is bounded and of
one plan: irregular heights along the candidate axis, a pushdown that does
not shrink the leaf reads, unknown chunks, host-only or masked data,
``Barrier`` splits, or more than three structural keys.

Where the port differs from the JAX package: the ``"auto"`` budget comes
from ``torch.cuda.mem_get_info`` of the configured device (unbounded on
the CPU, so ``"auto"`` never engages there); a host leaf is a ``FromArray``
of host data (numpy, a memmap, an array-like store), and a tensor source
is resident; a pinned leaf goes up through the pinned ring.  Under a mesh
``_pin_resident`` pins nothing: mesh placement is the layout solver's job,
as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dask_array_tpu_torch import config
from dask_array_tpu_torch._chunks import array_of, format_of, is_float_dtype, parse_bytes
from dask_array_tpu_torch._host import is_host_block
from dask_array_tpu_torch._spans import COUNTS, call, span

# engagement spy: how often the lane answered, how many panels it ran, how
# many unshrinkable leaves it made resident, and the host bytes its panels
# read (up) and landed (down), from chunk metadata
STREAMED = {"count": 0, "panels": 0, "pinned": 0, "h2d_bytes": 0, "d2h_bytes": 0}

# reduce-stream's cross-panel combines: each kind is associative and
# commutative over panel partials (nanmin/nanmax combine with fmin/fmax, so
# an all-NaN panel's NaN partial loses to any value)
_COMBINE = {
    "sum": np.add,
    "nansum": np.add,
    "prod": np.multiply,
    "nanprod": np.multiply,
    "min": np.minimum,
    "max": np.maximum,
    "nanmin": np.fmin,
    "nanmax": np.fmax,
    "any": np.logical_or,
    "all": np.logical_and,
}


def _device() -> torch.device:
    from dask_array_tpu_torch._executor import current_device

    return current_device()


def _budget() -> int:
    b = config.get("memory-budget", "auto")
    if b != "auto":
        return int(parse_bytes(b))
    device = _device()
    if device.type != "cuda":
        # the host's memory: "auto" never engages
        return 1 << 62
    COUNTS["mem_get_info"] += 1
    free, _total = call("mem_get_info", torch.cuda.mem_get_info, device)
    # what the caching allocator holds but does not use is free to this
    # program too: without it the budget would shrink by whatever earlier
    # computes left in the cache.  Three quarters of the sum: the eager
    # walk holds intermediates beyond the estimate (the largest node and
    # the leaves)
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return (int(free) + int(cached)) * 3 // 4


def _is_host_leaf(node) -> bool:
    """A ``FromArray`` leaf whose buffer is on the host (it streams up); a
    tensor source is resident on the configured device."""
    return type(node).__name__ == "FromArray" and not isinstance(node.source, torch.Tensor)


def _host_leaf_bytes(expr) -> int:
    """Expected host-to-device bytes of a program: its host leaves' nbytes
    after pushdown, from chunk metadata."""
    total = 0
    for node in expr.walk():
        if not node.dependencies() and _is_host_leaf(node):
            total += int(node.nbytes)
    return total


def _sel(nd, d, start, stop):
    return tuple(slice(int(start), int(stop)) if ax == d else slice(None) for ax in range(nd))


def _regular_rows(heights):
    """All chunk heights along the axis equal but a smaller tail: panels of
    equal height then share one plan."""
    if len(heights) < 2:
        return False
    h = int(heights[0])
    return all(int(x) == h for x in heights[:-1]) and int(heights[-1]) <= h


def _host_only(dt) -> bool:
    """Dtypes the lane does not stream: the host lane's (records, strings,
    objects), as the JAX package's ``_scan`` declines them.  Datetime
    ticks, bfloat16, the float8 types and the narrow types stream."""
    from dask_array_tpu_torch._chunks import host_only_dtype

    return host_only_dtype(dt)


def _scan(expr):
    """One walk: the estimated device bytes of the in-core walk (host
    leaves and the largest node), or None when the program cannot stream
    (unknown chunks, host-only dtypes, masked leaves, ``Barrier`` splits,
    metadata that does not resolve)."""
    leaf_bytes = 0
    biggest = 0
    try:
        for node in expr.walk():
            nb = node.nbytes
            if isinstance(nb, float) and math.isnan(nb):
                return None
            if getattr(node, "_leaf_stop", False):
                return None  # Barrier: its subtree computes whole on the card
            if _host_only(node.dtype):
                return None
            if not node.dependencies():
                if type(node).__name__ == "FromArray" and is_host_block(node.source):
                    return None  # a masked or duck leaf: the host lane
                if _is_host_leaf(node):
                    leaf_bytes += int(nb)
            biggest = max(biggest, int(nb))
    except (ValueError, TypeError, NotImplementedError):
        return None  # metadata that does not resolve: the in-core walk raises its own error
    return leaf_bytes + biggest


def maybe_stream(expr):
    """Execute ``expr`` out of core, or None to decline (the in-core walk
    answers).  Returns a host numpy array: an out-of-core result may itself
    exceed the card's memory."""
    return call("stream_check", _maybe_stream, expr)


def _maybe_stream(expr):
    mode = config.get("out-of-core", "auto")
    if mode == "off":
        return None
    if mode == "auto" and config.get("memory-budget", "auto") == "auto" and _device().type != "cuda":
        return None  # unbounded budget: nothing to plan
    if getattr(expr, "ndim", None) is None or not expr.known_chunks:
        return None
    est = _scan(expr)
    if est is None:
        return None
    budget = _budget()
    if mode != "force" and est <= budget:
        return None
    with span("stream_run"):
        res = _map_stream(expr, budget, mode)
        if res is not None:
            return res
        return _reduce_stream(expr, budget, mode)


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------


def _probe_axis(expr, d, budget, mode, reducer=None):
    """Plan panels along axis ``d``: 1- and 2-row panel programs split the
    expected bytes into FIXED (leaves that do not shrink) and PER-ROW, and
    the panel height makes fixed + rows * (leaf + output per row) fit the
    budget.  Returns (rows per panel, heights, the 1-row plan, depth) or
    None.  ``reducer`` wraps a sliced input back into the terminal
    reduction (reduce-stream); map-stream slices the root."""
    from dask_array_tpu_torch._collection import new_collection
    from dask_array_tpu_torch._materialize import optimize_expr

    src = expr if reducer is None else expr.array
    heights = src.chunks[d]
    if not _regular_rows(heights):
        return None
    k = len(heights)
    h = int(heights[0])
    nd = src.ndim

    def panel_expr(r0, r1):
        start, stop = r0 * h, min(r1 * h, int(src.shape[d]))
        sliced = new_collection(src)[_sel(nd, d, start, stop)].expr
        return sliced if reducer is None else reducer(sliced)

    full = _host_leaf_bytes(expr)
    p1 = optimize_expr(panel_expr(0, 1))
    b1 = _host_leaf_bytes(p1)
    if full <= 0 or b1 >= full * 0.9:
        return None  # the pushdown did not shrink the reads: unbounded
    if k >= 3:
        b2 = _host_leaf_bytes(optimize_expr(panel_expr(0, 2)))
        per = max(b2 - b1, 1)
        fixed = max(b1 - per, 0)
    else:
        per, fixed = max(b1, 1), 0
    # output bytes per chunk row (map-stream: the panel's slice of the
    # root; reduce-stream: partials are reduced over d, negligible)
    out_per_row = int(expr.nbytes) * h / max(int(expr.shape[d]), 1) if reducer is None else 0
    # up to depth + 1 panels' inputs are alive on the card at once; a
    # budget too tight for the configured depth degrades to synchronous
    # streaming (depth 0) before declining
    denom = max(per + out_per_row, 1)
    depth = _depth()
    while True:
        rows = int((budget * 0.8 / (depth + 1) - fixed) // denom)
        if rows >= 1 or depth == 0:
            break
        depth -= 1
    if rows < 1:
        if mode != "force":
            return None  # not even one chunk row fits
        rows = 1
    if rows >= k:
        if mode != "force":
            return None  # one panel: the in-core walk is better
        rows = max(1, (k + 1) // 2)  # force: at least two panels
    return rows, heights, p1, depth


def _pin_resident(expr, probe_opt, budget):
    """Make the leaves the pushdown could not shrink resident on the card,
    so they go up once (through the pinned ring) and not once a panel: the
    weights of a panel-swept matmul.  Returns the (possibly substituted)
    expression."""
    from dask_array_tpu_torch._executor import to_device
    from dask_array_tpu_torch.parallel.mesh import current_mesh

    if current_mesh() is not None:
        return expr  # mesh placement is the layout solver's job
    cap = budget * 0.3
    spent = 0
    pinned_srcs = []
    for node in probe_opt.walk():
        if node.dependencies() or not _is_host_leaf(node):
            continue
        src = node.source
        if not isinstance(src, np.ndarray) or isinstance(src, np.ma.MaskedArray):
            continue  # memmaps and stores: pinning would read the whole file
        nb = int(node.nbytes)
        if nb < src.nbytes:  # the slice shrank it: it streams
            continue
        if spent + nb > cap:
            continue
        if any(s is src for s in pinned_srcs):
            continue
        spent += nb
        pinned_srcs.append(src)
    if not pinned_srcs:
        return expr
    STREAMED["pinned"] += len(pinned_srcs)
    STREAMED["h2d_bytes"] += spent
    device = _device()
    put = {id(s): to_device(s, device) for s in pinned_srcs}
    mapping = {}
    for node in expr.walk():
        if not node.dependencies() and type(node).__name__ == "FromArray" and id(node.source) in put:
            # named by the resident tensor, not by the host source's token
            mapping[node._name] = type(node)(put[id(node.source)], node.chunks_, node.region, node.name_)
    if not mapping:
        return expr
    return expr._substitute_many(mapping, {})


def _panel_ranges(heights, rows):
    """(start, stop) element ranges grouping chunk rows into panels."""
    bounds = np.concatenate([[0], np.cumsum([int(x) for x in heights])])
    k = len(heights)
    out = []
    r = 0
    while r < k:
        r2 = min(r + rows, k)
        out.append((int(bounds[r]), int(bounds[r2])))
        r = r2
    return out


def _keys_bounded(exprs):
    """Panels share their plan: at most 3 structural keys over all panels
    (an overlap program's first and last panels touch the array's edges,
    and the tail may be shorter: a constant, not one plan a panel)."""
    from dask_array_tpu_torch._executor import structural_key

    keys = set()
    for e in exprs:
        keys.add(structural_key(e))
        if len(keys) > 3:
            return False
    return True


def _depth():
    # 1 is double buffering: the next panel goes up and computes while the
    # previous one comes back
    return max(int(config.get("stream-depth", 1)), 0)


def _ready(t):
    """The event after which the panel's value ``t`` is made (CUDA), or
    None."""
    if t.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


def _to_host(t, ready=None, dtype=None) -> np.ndarray:
    """A panel's value as host numpy; with ``dtype``, datetime ticks and a
    narrow type's carrier (``_narrow``) viewed as that dtype."""
    if t.device.type == "cuda":
        from dask_array_tpu_torch._hostcopy import fetch

        arr = fetch(t, ready)
    else:
        arr = array_of(t)
    if dtype is not None and arr.dtype != dtype and (dtype.kind in "Mm" or format_of(dtype) is not None):
        arr = arr.view(dtype)
    return arr


# ---------------------------------------------------------------------------
# map-stream: a large sliceable output, landed panel by panel on the host
# ---------------------------------------------------------------------------


def _map_stream(expr, budget, mode):
    from dask_array_tpu_torch._collection import new_collection
    from dask_array_tpu_torch._executor import execute
    from dask_array_tpu_torch._hostcopy import _numpy_dtype_of, fetch_into
    from dask_array_tpu_torch._materialize import optimize_expr

    nd = expr.ndim
    if nd == 0:
        return None
    chunks = expr.chunks
    for d in sorted(range(nd), key=lambda ax: -len(chunks[ax])):
        plan = _probe_axis(expr, d, budget, mode)
        if plan is None:
            continue
        rows, heights, probe, depth = plan
        pinned = _pin_resident(expr, probe, budget)
        ranges = _panel_ranges(heights, rows)
        coll = new_collection(pinned)
        opts = [optimize_expr(coll[_sel(nd, d, a, b)].expr) for a, b in ranges]
        if not _keys_bounded(opts):
            continue  # one plan a panel: decline this axis

        STREAMED["count"] += 1
        shape = tuple(int(s) for s in expr.shape)
        out = None
        inflight = []

        def land(sel_range, t, ready):
            nonlocal out
            if out is None:
                out = np.empty(shape, _numpy_dtype_of(t.dtype))
            a, b = sel_range
            dst = out[_sel(nd, d, a, b)]
            if t.device.type == "cuda":
                fetch_into(t, dst, ready)
            else:
                np.copyto(dst, array_of(t))
            STREAMED["d2h_bytes"] += dst.nbytes

        for (a, b), opt in zip(ranges, opts):
            t = execute(opt)
            inflight.append(((a, b), t, _ready(t)))
            STREAMED["panels"] += 1
            STREAMED["h2d_bytes"] += _host_leaf_bytes(opt)
            if len(inflight) > depth:
                land(*inflight.pop(0))
        for item in inflight:
            land(*item)
        return out
    return None


# ---------------------------------------------------------------------------
# reduce-stream: a terminal reduction; panels of its INPUT fold into a small
# combine accumulator
# ---------------------------------------------------------------------------


def _reduce_stream(expr, budget, mode):
    from dask_array_tpu_torch.ops.reductions import Reduction

    if not isinstance(expr, Reduction):
        return None
    kind = expr.kind
    mean_kind = kind in ("mean", "nanmean")
    if kind not in _COMBINE and not mean_kind:
        return None
    arr = expr.array
    for d in sorted(expr.axes, key=lambda ax: -len(arr.chunks[ax])):
        res = _reduce_stream_axis(expr, d, budget, mode, mean_kind)
        if res is not None:
            return res
    return None


def _reduce_stream_axis(expr, d, budget, mode, mean_kind):
    import dask_array_tpu_torch as da
    from dask_array_tpu_torch._collection import new_collection
    from dask_array_tpu_torch._executor import execute, execute_many
    from dask_array_tpu_torch._materialize import optimize_expr
    from dask_array_tpu_torch.ops.reductions import Reduction

    arr = expr.array
    kind = expr.kind
    axes = tuple(expr.axes)
    keepdims = expr.keepdims
    out_dtype = np.dtype(expr.dtype)
    # a sum or product of a float narrower than float32 (float16, bfloat16,
    # float8, the narrow floats) accumulates in float32 across panels, as
    # the in-core reduction does, and rounds once at the end
    part_dtype = out_dtype
    if kind in ("sum", "nansum", "prod", "nanprod", "mean", "nanmean") and is_float_dtype(out_dtype) \
            and out_dtype.itemsize < 4:
        part_dtype = np.dtype(np.float32)

    # the per-panel partial: the same reduction over the sliced input; for
    # the mean kinds the matching sum, divided once after the combine
    def reducer(panel):
        if mean_kind:
            pkind = "nansum" if kind == "nanmean" else "sum"
            return Reduction(panel, pkind, axes, keepdims, part_dtype, None)
        if part_dtype != out_dtype:
            return Reduction(panel, kind, axes, keepdims, part_dtype, None)
        return type(expr)(panel, *expr.operands[1:])

    plan = _probe_axis(expr, d, budget, mode, reducer=reducer)
    if plan is None:
        return None
    rows, heights, _probe, depth = plan
    ranges = _panel_ranges(heights, rows)
    nd = arr.ndim
    acoll = new_collection(arr)

    def panel_exprs(a, b):
        panel = acoll[_sel(nd, d, a, b)]
        roots = [optimize_expr(reducer(panel.expr))]
        if kind == "nanmean":
            # the data-dependent divisor, the non-NaN count, in the same
            # panel program (one leaf read)
            cnt = (~da.isnan(panel)).sum(axis=axes, keepdims=keepdims)
            roots.append(optimize_expr(cnt.expr))
        return roots

    opts = [panel_exprs(a, b) for a, b in ranges]
    if not _keys_bounded([o[0] for o in opts]):
        return None

    STREAMED["count"] += 1
    comb = _COMBINE["nansum" if kind == "nanmean" else ("sum" if kind == "mean" else kind)]
    acc = None
    cnt_acc = None
    inflight = []

    def land(vals, ready):
        # partials combined by numpy in their dtype (a datetime min or max
        # keeps numpy's NaT, a narrow integer sum wraps as in core)
        nonlocal acc, cnt_acc
        part = _to_host(vals[0], ready, part_dtype)
        STREAMED["d2h_bytes"] += part.nbytes
        acc = part if acc is None else comb(acc, part)
        if len(vals) > 1:
            c = _to_host(vals[1], ready)
            STREAMED["d2h_bytes"] += c.nbytes
            cnt_acc = c if cnt_acc is None else cnt_acc + c

    for roots in opts:
        vals = [execute(roots[0])] if len(roots) == 1 else execute_many(roots)
        inflight.append((vals, _ready(vals[-1])))
        STREAMED["panels"] += 1
        STREAMED["h2d_bytes"] += _host_leaf_bytes(roots[0])
        if len(inflight) > depth:
            land(*inflight.pop(0))
    for item in inflight:
        land(*item)

    if kind == "mean":
        count = math.prod(int(arr.shape[ax]) for ax in axes)
        acc = (acc / count).astype(out_dtype, copy=False)
    elif kind == "nanmean":
        with np.errstate(invalid="ignore", divide="ignore"):
            acc = (acc / cnt_acc).astype(out_dtype, copy=False)
    if acc.dtype != out_dtype:
        acc = acc.astype(out_dtype)
    return np.asarray(acc)
