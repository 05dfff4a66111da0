"""The port's spans and counters: what a profile of a compute is made of.

A leaf module: it imports nothing of the package, so every layer can use
it.

**Spans.**  ``call(name, fn, *args)`` runs ``fn(*args)`` inside a span and
costs one flag read and a call while no ``torch.profiler`` records
(``span(name)``, the same as a context manager, adds the ``with``
statement's cost).  While one records, a span is
``record_function("dask_array_tpu_torch.<name>")``: it is kept in the
profiler's memory, written out with the profile (a Chrome trace from
``diagnostics.xla_profile``, or the events of any
``torch.profiler.profile``) and shares the device trace's clock.  The
spans, outermost first:

``compute:<request id>``
    each public entry (``Array.compute``/``compute_device``/``persist``,
    ``dask_array_tpu_torch.compute``) and each ``Barrier``'s own walk.  A
    compute inside a compute keeps the outer id, so every span of one
    request lies under a root of its id.
``stream_check``
    ``_streaming.maybe_stream`` from entry to its decision, with the
    child ``mem_get_info`` (``torch.cuda.mem_get_info`` in ``_budget``)
    and, where the program streams, ``stream_run``.
``fuse_multistat``
    ``ops/_multistat.fuse_multi_stat``: the route of several statistics
    of one operand to the multi-statistic kernel.
``optimize``
    the body of ``_materialize.optimize_expr`` (simplify, lower, fuse).
``execute``
    the body of ``_executor.execute_views``, with the child ``bind`` (leaf
    collection and the leaves' move to the device) and one
    ``node:<Type>`` a node built (cache misses only); a node's self time
    is its span less its child nodes.
``launch:<kernel>``
    the host side of a hand-kernel launch (``kernels/_build.Launcher``);
    each wrapper's ``LAUNCHES`` counts them.
``fetch``
    ``_hostcopy.fetch_into``, the answers' trip to numpy, with the
    children ``fetch.wait`` (the host waits on a piece's copy event: the
    card is busy) and ``fetch.piece`` (a slot drained into the result).
``upload``
    ``_hostcopy.upload``, a host leaf's copy to the card.
``capture``
    ``kernels/stencil.stencil_spec``: the ``torch.fx`` traces of a
    ``map_overlap`` func into taps or a program, when the graph is built.
``meta``
    ``_expr.compute_meta``: a node's dtype inferred by running its function
    on tiny numpy or torch ``meta`` tensors, wherever a metadata cache is
    first filled (the build, the optimizer's ``warm_metadata``, an answer's
    dtype read after the walk).
``kernel_build``, ``library_load``
    ``nvcc`` run for a hand kernel's source, and a kernel library's
    ``ctypes`` load (generated programs included).

**Counters.**  ``COUNTS`` is always on and is read without wrapping
anything, as ``_hostcopy.COPIES`` is; each counter answers one question:

``computes``
    how many computes ran, those inside another compute too; an
    outermost compute's request id is the count at its entry.
``optimize_runs``, ``optimize_memo_hits``
    how often the optimizer walked a tree, and how often
    ``optimize_expr``'s per-expression memo saved that walk.
``mem_get_info``
    how often the out-of-core check asked CUDA for free memory.
``captures``
    how many ``torch.fx`` captures of a ``map_overlap`` func ran.
``library_builds``, ``library_loads``
    how many hand-kernel sources were compiled with ``nvcc``, and how
    many libraries were loaded.

The counters that stay in their modules: ``_hostcopy.COPIES`` (bytes and
pieces a direction), ``_streaming.STREAMED`` (streamed computes, panels,
bytes), ``ops/_fancy_indexing.SYNCS`` (host syncs for data-dependent
sizes), ``ops/linalg_decomp.FACTORIZATIONS`` (factorizations a walk),
``_host.HOST_CALLS`` (block functions run on the host lane),
``io/_from_map.LOADS`` (loader calls), ``parallel/_sharded.COLLECTIVES``
and ``parallel/partition.PARTITIONED`` (the mesh's collectives and
partitioned nodes), and each kernel wrapper's ``LAUNCHES``
(``kernels/*.py``) with ``kernels/stencil.VARIANT_LAUNCHES``.
"""

from __future__ import annotations

import threading

from torch.autograd import profiler as _profiler

PREFIX = "dask_array_tpu_torch."

COUNTS = {
    "computes": 0,
    "optimize_runs": 0,
    "optimize_memo_hits": 0,
    "mem_get_info": 0,
    "captures": 0,
    "library_builds": 0,
    "library_loads": 0,
}


class _Off:
    """The span of a process no profiler records: enters nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """The span ``dask_array_tpu_torch.<name>`` as a context manager.  Costs
    one flag read where no profiler records, besides the ``with``
    statement's own cost: the hot paths take ``call``."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _profiler.record_function(PREFIX + name)


def call(name: str, fn, *args):
    """``fn(*args)`` inside the span ``name``, at the cost of a flag read
    and a call where no profiler records."""
    if not _profiler._is_profiler_enabled:
        return fn(*args)
    with span(name):
        return fn(*args)


_request = threading.local()


def compute(fn, *args):
    """``fn(*args)`` as a compute: counted in ``COUNTS["computes"]``, and
    while a profiler records, under the span ``compute:<request id>``.  An
    outermost compute's id is the count at its entry; a compute inside it
    (a ``Barrier``'s walk, a ``persist`` in a build) opens a child
    ``compute`` with the same id."""
    COUNTS["computes"] += 1
    if not _profiler._is_profiler_enabled:
        return fn(*args)
    outer = getattr(_request, "id", None)
    _request.id = COUNTS["computes"] if outer is None else outer
    try:
        with span(f"compute:{_request.id}"):
            return fn(*args)
    finally:
        _request.id = outer
