"""Optimizer and executor diagnostics: ``trace_rewrites``, ``explain``,
``chunk_report``, ``expr_table``, ``xla_profile``, ``tier_report`` and
``plan_table``.

Port of ``dask_array_tpu/_diagnostics.py``.  Where the JAX package speaks
of its compiled XLA program, the port reports what it has instead: the
eager torch walk on the configured device, the host lane (``_host.py``),
plankit, and whether the band-stencil kernel is built.  ``xla_profile``
keeps its name and wraps ``torch.profiler``.  The JAX package's
``compiled_hlo`` has no counterpart: the port compiles no program.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import time
from collections import Counter
from dataclasses import dataclass

import numpy as np

import dask_array_tpu_torch._expr as _expr_mod
from dask_array_tpu_torch._expr import ArrayExpr


@dataclass
class RewriteRecord:
    rule: str
    before: str
    after: str
    phase: str
    before_type: str = ""
    after_type: str = ""


class RewriteTrace:
    def __init__(self):
        self.records: list[RewriteRecord] = []

    def __iter__(self):
        return iter(self.records)

    def __len__(self):
        return len(self.records)

    def counter(self):
        return Counter(r.rule for r in self.records)

    def summary(self) -> str:
        lines = [f"{len(self.records)} rewrites"]
        for rule, n in self.counter().most_common():
            lines.append(f"  {rule}: {n}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace_rewrites():
    """Record every optimizer rewrite fired inside the block.

    >>> with trace_rewrites() as trace:
    ...     y.optimize()
    >>> print(trace.summary())
    """
    trace = RewriteTrace()
    prev = _expr_mod._trace_hook

    def hook(rule, before, after, phase):
        trace.records.append(
            RewriteRecord(rule, before._name, after._name, phase, type(before).__name__, type(after).__name__)
        )
        if prev is not None:
            prev(rule, before, after, phase)

    _expr_mod._trace_hook = hook
    try:
        yield trace
    finally:
        _expr_mod._trace_hook = prev


def _expr_of(x) -> ArrayExpr:
    from dask_array_tpu_torch._collection import Array

    return x.expr if isinstance(x, Array) else x


def _node_count(expr: ArrayExpr) -> int:
    return sum(1 for _ in expr.walk())


def _transfer_total(expr: ArrayExpr):
    lo = hi = 0
    for node in expr.walk():
        a, b = node.transfer_bytes()
        lo += a
        hi += b
    return lo, hi


def _leaf_read_bytes(expr: ArrayExpr):
    total = 0
    for node in expr.walk():
        if not node.dependencies():
            nb = node.nbytes
            if not (isinstance(nb, float) and np.isnan(nb)):
                total += int(nb)
    return total


def _fmt_bytes(n):
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024:
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n:.1f} PiB"


def explain(x, fuse: bool = True, file=None):
    """Run simplify, lower and fuse one at a time, timing and reporting
    each; returns the stages, their node counts, leaf reads and rewrites."""
    from dask_array_tpu_torch import config, native
    from dask_array_tpu_torch._blockwise import FusedBlockwise, optimize_blockwise_fusion
    from dask_array_tpu_torch._planrec import plan_fingerprint, plan_records

    expr = _expr_of(x)
    out = []
    emit = out.append

    emit(f"explain: {type(expr).__name__}  shape={expr.shape}  chunks={expr.chunksize}")
    emit(f"  raw: {_node_count(expr)} nodes, leaf reads {_fmt_bytes(_leaf_read_bytes(expr))}")

    with trace_rewrites() as tr_s:
        t0 = time.perf_counter()
        simplified = expr.simplify()
        t_simplify = time.perf_counter() - t0
    emit(
        f"  simplify: {t_simplify * 1e3:.2f} ms, {len(tr_s)} rewrites -> "
        f"{_node_count(simplified)} nodes, leaf reads {_fmt_bytes(_leaf_read_bytes(simplified))}"
    )
    for rule, n in tr_s.counter().most_common():
        emit(f"    {rule}: {n}")

    with trace_rewrites() as tr_l:
        t0 = time.perf_counter()
        lowered = simplified.lower_completely()
        t_lower = time.perf_counter() - t0
    emit(f"  lower: {t_lower * 1e3:.2f} ms, {len(tr_l)} rewrites -> {_node_count(lowered)} nodes")
    for rule, n in tr_l.counter().most_common():
        emit(f"    {rule}: {n}")

    fused = lowered
    if fuse:
        t0 = time.perf_counter()
        fused = optimize_blockwise_fusion(lowered)
        t_fuse = time.perf_counter() - t0
        groups = [n for n in fused.walk() if isinstance(n, FusedBlockwise)]
        emit(f"  fuse: {t_fuse * 1e3:.2f} ms, {len(groups)} fused groups (sizes {[g.n_fused for g in groups]})")

    lo, hi = _transfer_total(fused)
    emit(f"  est. transfer bytes: min {_fmt_bytes(lo)}, max {_fmt_bytes(hi)}")
    emit(f"  leaf read bytes: {_fmt_bytes(_leaf_read_bytes(fused))}")
    emit(f"  output: shape={fused.shape} dtype={fused.dtype} blocks={fused.npartitions}")
    emit(f"  executor: eager torch walk on {config.get('device', 'cuda')}")

    plan_fp = None
    rec = plan_records(fused)
    if rec is not None:
        blob, stable = rec
        plan_fp = plan_fingerprint(fused)[0]
        emit(
            f"  plan record: {len(blob)} bytes, fingerprint {plan_fp}"
            f" ({'process-stable' if stable else 'in-process only'},"
            f" {'native' if native.available() else 'python'} encoder)"
        )

    text = "\n".join(out)
    print(text, file=file)
    return {
        "simplified": simplified,
        "lowered": lowered,
        "fused": fused,
        "times_ms": {"simplify": t_simplify * 1e3, "lower": t_lower * 1e3},
        "transfer_bytes": (lo, hi),
        "nodes": {
            "raw": _node_count(expr),
            "simplified": _node_count(simplified),
            "lowered": _node_count(lowered),
            "fused": _node_count(fused),
        },
        "read_bytes": {
            "raw": _leaf_read_bytes(expr),
            "simplified": _leaf_read_bytes(simplified),
            "fused": _leaf_read_bytes(fused),
        },
        "rewrites": {"simplify": tr_s.counter(), "lower": tr_l.counter()},
        "plan_fingerprint": plan_fp,
    }


def chunk_report(*arrays, limit=8, file=None):
    """Summarize the health of each array's chunk shapes (``limit`` caps
    the arrays reported)."""
    lines = []
    for a in arrays[: limit if limit else None]:
        sizes = []
        for dims in itertools.product(*a.chunks):
            if any(isinstance(d, float) and np.isnan(d) for d in dims):
                sizes = None
                break
            sizes.append(int(np.prod(dims)) * a.dtype.itemsize)
        name = getattr(a, "name", "?")[:24]
        if sizes is None:
            lines.append(f"{name}: unknown chunk sizes (nan)")
            continue
        lines.append(
            f"{name}: {a.npartitions} blocks, chunk bytes min {_fmt_bytes(min(sizes))} "
            f"/ median {_fmt_bytes(int(np.median(sizes)))} / max {_fmt_bytes(max(sizes))}"
        )
        if max(sizes) > 1 << 30:
            lines.append("  WARNING: chunks exceed 1 GiB; consider rechunking smaller")
        if len(sizes) > 100000:
            lines.append("  WARNING: very large block count; consider rechunking larger")
    text = "\n".join(lines)
    print(text, file=file)
    return text


def expr_table(x, file=None):
    """One row per node of the expression tree: type, shape, chunk size,
    dtype, blocks and the bytes it moves between blocks."""
    rows = [("node", "shape", "chunksize", "dtype", "blocks", "transfer(max)")]
    for node in _expr_of(x).walk():
        _lo, hi = node.transfer_bytes()
        rows.append(
            (type(node).__name__, str(node.shape), str(node.chunksize), str(node.dtype), str(node.npartitions),
             _fmt_bytes(hi))
        )
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    text = "\n".join("  ".join(cell.ljust(w) for cell, w in zip(row, widths)) for row in rows)
    print(text, file=file)
    return text


@contextlib.contextmanager
def xla_profile(logdir=None):
    """Profile the computes inside the block with ``torch.profiler`` (host
    and, where there is a card, CUDA activity) and write a Chrome trace into
    ``logdir`` (by default a folder under the temporary directory).  Yields
    ``logdir``.  The name is the JAX package's; the trace is torch's.

    Beside torch's own events the trace holds the port's spans, named
    ``dask_array_tpu_torch.<stage>`` on the device's clock: each request's
    root ``compute:<id>``, and under it ``stream_check`` (with
    ``mem_get_info``), ``fuse_multistat``, ``optimize``, ``execute`` (with
    ``bind`` and a ``node:<Type>`` a node built), ``launch:<kernel>``,
    ``fetch`` (with ``fetch.wait`` and ``fetch.piece``) and ``upload``;
    ``capture`` where ``map_overlap`` traces its func, ``meta`` where a
    node's dtype is inferred, ``kernel_build`` and ``library_load``
    (``_spans`` lists them all).  So each gap in the
    card's work lies under the host stage that held it.  The counters need
    no profile: ``_spans.COUNTS`` (computes, optimizer walks and memo
    hits, free-memory queries, ``torch.fx`` captures, kernel builds and
    loads) is read as it stands."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "dask_array_tpu_torch_profile")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def _node_tier(node) -> str:
    """``sync`` where the walk reads a size from the data (unknown chunks:
    a host sync), ``host`` where a block function runs in the host lane or
    the blocks have no torch dtype, ``device`` for the torch walk."""
    from dask_array_tpu_torch._host import lane_of

    if not node.known_chunks:
        return "sync"
    try:
        if np.dtype(node.dtype).hasobject:
            return "host"
    except TypeError:
        return "host"
    for key in getattr(node, "_lane_operands", ()):
        func = node.operand(key)
        if func is not None and lane_of(node, key, func):
            return "host"
    return "device"


def tier_report(x, file=None):
    """Classify every node of the optimized plan by the lane that runs it
    (``_node_tier``), and report the lanes the port has: the eager torch
    walk on the configured device, the host lane (``_host.py``), plankit,
    and whether the band-stencil kernel (K1) is built."""
    from dask_array_tpu_torch import config, native
    from dask_array_tpu_torch.kernels import stencil
    from dask_array_tpu_torch.kernels._build import library_path

    lowered = _expr_of(x).optimize()
    rows = [(type(node).__name__, _node_tier(node)) for node in lowered.walk()]
    counts = Counter(tier for _, tier in rows)
    device = config.get("device", "cuda")
    lines = [
        f"execution tier report ({len(rows)} nodes): " + ", ".join(f"{t}={n}" for t, n in sorted(counts.items())),
        f"  mode: eager torch walk on {device}"
        + (f", {counts['sync']} host sync(s) for data-dependent sizes" if counts.get("sync") else ""),
        f"  host lane (_host.py): {counts.get('host', 0)} node(s)",
        f"  native plankit: {'engaged' if native.available() else 'Python fallback'}",
    ]
    lib = library_path("band_stencil")
    if stencil._launcher.cache_info().currsize:
        band = f"built and loaded ({lib.name})"
    elif lib.exists():
        band = f"built ({lib.name}), not loaded"
    else:
        band = "not built (it builds at its first CUDA call)"
    lines.append(f"  band-stencil kernel (K1, csrc/band_stencil.cu): {band}")
    for name, tier in rows:
        if tier != "device":
            lines.append(f"  {name}: {tier}")
    text = "\n".join(lines)
    print(text, file=file)
    return {"counts": dict(counts), "nodes": rows, "native": native.available(), "band_kernel": band}


def plan_table(x, file=None):
    """Decode and show the binary plan record of ``x``'s optimized plan:
    the node table the structural key (``_executor.structural_key``) is
    taken over.  Returns the decoded dict, or None where the plan is not
    expressible in the records grammar."""
    from dask_array_tpu_torch._planrec import decode_plan, plan_records

    expr = _expr_of(x).optimize()
    rec = plan_records(expr)
    if rec is None:
        print("plan not expressible in the records grammar", file=file)
        return None
    blob, stable = rec
    decoded = decode_plan(blob)
    lines = [
        f"plan record: {len(decoded['nodes'])} nodes, {len(blob)} bytes, grammar v{decoded['version']}"
        f" ({'process-stable' if stable else 'in-process only'})"
    ]
    for i, node in enumerate(decoded["nodes"]):
        nblocks = tuple(len(c) for c in node["chunks"])
        ops = []
        for op in node["ops"]:
            if isinstance(op, tuple) and len(op) == 2 and op[0] == "expr":
                ops.append(f"@{op[1]}")
            elif isinstance(op, tuple) and len(op) == 2 and op[0] == "leaf":
                ops.append(f"leaf#{op[1]}")
            else:
                r = repr(op)
                ops.append(r if len(r) <= 24 else r[:21] + "...")
        lines.append(f"  [{i}] {node['type']} blocks={nblocks} ops=({', '.join(ops)})")
    text = "\n".join(lines)
    print(text, file=file)
    return decoded
